"""Kernels written by hand for Hopper, one package per kernel of ``repro``.

Each package has ``ops.py`` (the wrapper: the CUDA kernel for a CUDA tensor,
the plain PyTorch version for a CPU tensor, and a launch count), ``ref.py``
(the plain PyTorch version) and ``csrc/`` (the CUDA source, built by
``build.py`` on first use).
"""
