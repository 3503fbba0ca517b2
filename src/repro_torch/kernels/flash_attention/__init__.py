"""Flash attention forward: the port of ``repro.kernels.flash_attention``."""
