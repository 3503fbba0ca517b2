"""Kernels written by hand for Hopper, one package per kernel of ``repro``.

Each package has ``ops.py`` (the wrapper: the CUDA kernel for a CUDA tensor,
the plain PyTorch version for a CPU tensor, and a launch count), ``ref.py``
(the plain PyTorch version) and ``csrc/`` (the CUDA source, built by
``build.py`` on first use).
"""
import torch


def on_card(x: torch.Tensor) -> bool:
    """Whether a wrapper takes its kernel's path for ``x`` (any tensor not
    on the CPU; the kernel then raises unless ``x`` is on a CUDA device)."""
    return x.device.type != "cpu"


def refuse_grad(kernel: str, why: str, *tensors: torch.Tensor) -> None:
    """Raises where autograd would need the gradient of a kernel that has
    no backward: on the card the call must not differentiate silently
    through nothing, nor fall back to the plain version."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward; {why} (a backward "
            f"kernel is open work in ROADMAP.md §B)")
