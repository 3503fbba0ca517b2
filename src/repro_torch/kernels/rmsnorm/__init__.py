"""RMSNorm over the last dimension: the port of ``repro.kernels.rmsnorm``."""
