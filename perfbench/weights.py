"""The raw weights of a run, made on the device from the seed: one draw of
normal numbers for every weight that has a normal init, in the type the
weights are served in (float32 masters), sliced and scaled; one draw of
uniform numbers for Mamba's step sizes; the constant weights filled.  The
same seed gives the same weights, so the reference makes them again after
the program's state is freed.

The decays start where the published models start them, so that the
served token depends on many earlier tokens through the recurrent state
(a state that forgets within a token or two would let a broken
recurrence pass the comparison): RWKV-6's ``time_decay`` and
``time_faaaa`` (the RWKV-LM v6 initialisation, by layer and channel) and
Mamba's step size, log-uniform in [1e-3, 1e-1] through the inverse
softplus of its bias."""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from .generator import seed_words
from .reference.common import Spec


def make(specs: Sequence[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed))
    normals = [s for s in specs if s.init[0] == "normal"]
    total = sum(math.prod(s.shape) for s in normals)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for s in normals:
        n = math.prod(s.shape)
        out[s.name] = flat[off:off + n].view(s.shape).mul_(s.init[1])
        off += n
    steps = [s for s in specs if s.init[0] == "mamba_dt_bias"]
    uniform = torch.rand(sum(math.prod(s.shape) for s in steps),
                         generator=gen, device=device, dtype=torch.float32)
    off = 0
    for s in steps:
        n = math.prod(s.shape)
        lo, hi = math.log(s.init[1]), math.log(s.init[2])
        dt = torch.exp(uniform[off:off + n] * (hi - lo) + lo)
        out[s.name] = (dt + torch.log(-torch.expm1(-dt))).view(s.shape)
        off += n
    for s in specs:
        kind = s.init[0]
        if kind in ("rwkv6_decay", "rwkv6_bonus"):
            out[s.name] = _rwkv6_init(kind, *s.init[1:], s.shape, device)
        elif kind == "const":
            out[s.name] = torch.full(s.shape, s.init[1], device=device,
                                     dtype=torch.float32)
        elif kind == "log_arange":
            n = torch.arange(1, s.init[1] + 1, dtype=torch.float32,
                             device=device)
            out[s.name] = torch.log(n).expand(s.shape).contiguous()
        elif kind not in ("normal", "mamba_dt_bias"):
            raise ValueError(f"{s.name}: unknown init {s.init!r}")
    return out


def _rwkv6_init(kind: str, layer: int, n_layers: int, shape, device):
    """RWKV-LM v6's ``time_decay`` (decay speeds from -6 to -1 across the
    channels, steeper in later layers) or ``time_faaaa`` (the bonus, a
    ramp over the channels plus a zigzag of 0.1)."""
    d = math.prod(shape)
    ratio = layer / max(n_layers - 1, 1)
    n = torch.arange(d, dtype=torch.float64, device=device) / max(d - 1, 1)
    if kind == "rwkv6_decay":
        t = -6 + 5 * n ** (0.7 + 1.3 * ratio)
    else:
        zigzag = ((torch.arange(d, device=device) + 1) % 3 - 1) * 0.1
        t = ratio * (1 - n) + zigzag
    return t.to(torch.float32).view(shape)
