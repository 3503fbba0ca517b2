"""What the references share: weight specs, the float32 product and its
float8 control, norms, and the logit gaps that decide ``correct``."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Iterator, NamedTuple, Tuple

import torch

MM = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class Spec(NamedTuple):
    """One raw weight: ``init`` is ("normal", std), ("const", value),
    ("log_arange", n): log(1..n) along the last axis, as Mamba's A_log,
    or one of the published models' initialisations of their decays (see
    ``weights.make``)."""
    name: str
    shape: Tuple[int, ...]
    init: tuple


def normal(name, shape, std=0.02) -> Spec:
    return Spec(name, tuple(shape), ("normal", float(std)))


def const(name, shape, value) -> Spec:
    return Spec(name, tuple(shape), ("const", float(value)))


@contextmanager
def exact_float32() -> Iterator[None]:
    """Float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale a row (dim -1) or a column
    (dim 0), its largest magnitude at the format's largest value, 448."""
    s = t.abs().amax(dim, keepdim=True).clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's product: both operands in float8 e4m3 (activations
    scaled a row, weights a column), accumulated in float32: the step
    below the configurations' bfloat16 products."""
    return _fp8(x, -1) @ _fp8(w, 0)


def layer_norm(x, scale, bias, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def shifted(x: torch.Tensor) -> torch.Tensor:
    """x one step later in time, zeros first: (n, T, d)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def last_gaps(h_last: torch.Tensor, head: torch.Tensor,
              served: torch.Tensor) -> torch.Tensor:
    """(n,) gaps by which each served token's logit lies below the best
    logit, the logits the reference's own: h_last (n, d) float32, head (d,
    V), served (n,) ids."""
    logits = h_last @ head
    return logits.max(-1).values - logits.gather(
        -1, served[:, None].long())[:, 0]

