"""Host arrays and torch tensors, both ways, bfloat16 included.

numpy has no bfloat16 of its own.  A bf16 host mirror is an
``ml_dtypes.bfloat16`` array (the reference's host arrays of bf16 device
values are of that type), which ``torch.from_numpy`` and ``Tensor.numpy``
both refuse.  Both directions go through 16-bit integer views here, so
the bits never change.  ``ml_dtypes`` is imported only when a bf16 tensor
is brought to the host.
"""
from __future__ import annotations

import numpy as np
import torch


def _bfloat16() -> np.dtype:
    try:
        import ml_dtypes
    except ImportError as exc:
        raise ImportError("a bf16 host array needs the ml_dtypes package: "
                          "numpy has no bfloat16 of its own") from exc
    return np.dtype(ml_dtypes.bfloat16)


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor sharing ``a``'s memory; ``ml_dtypes.bfloat16`` becomes
    ``torch.bfloat16``."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The host array of ``t`` (copied off the device first; a CPU tensor
    shares its memory); ``torch.bfloat16`` becomes ``ml_dtypes.bfloat16``."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bfloat16())
    return t.numpy()


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a host array of numpy dtype ``dtype``."""
    if np.dtype(dtype).name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype)).dtype
