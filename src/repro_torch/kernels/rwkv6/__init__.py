"""RWKV6 WKV recurrence forward: the port of ``repro.kernels.rwkv6``."""
