"""The norm-shift-mix CUDA kernel (rwkv6's LayerNorm, token shift and mixes
in one pass) against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU (the kernel has no CPU mode), carries
the ``cuda`` marker and skips without one.  The file imports neither JAX nor
the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_norm_shift_mix_cuda.py

What is held, with the kernel's normalised rows h read back exactly from
its own outputs (a mix of 0 gives out = h_{t-1}; the new shift is h_{S-1}):

* h against the plain version's LayerNorm: within one bf16 step of it and
  H_ABS, equal but in under 1% of the elements (float32 statistics summed in
  another order: a row's h can round the other way near a bf16 rounding
  boundary, and where y * scale cancels against the bias, h is near 0 and
  the float32 difference of the two, a few 2^-24 of |y * scale|, is many
  of h's own bf16 steps);
* each mix against the formula rounded once, h_{t-1} + (h_t - h_{t-1}) *
  m in float64 from the kernel's own h: within one step of the output
  itself (the float32 result rounded to bf16, a double rounding) and the
  float32 rounding of h_t - h_{t-1} (where the two are far apart in
  magnitude, and m rounds to 1 in bf16, that shows);
* each mix against the plain version's (which rounds h * m, h_prev *
  (1 - m), 1 - m and their sum): within two bf16 steps of the larger of
  |h_t| and |h_{t-1}|, plus the two versions' difference in h;
* the new shift bit for bit the state a second chunk needs: two chunks
  with the shift handed over equal one call.
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels.norm_shift_mix import ops
from repro_torch.kernels.norm_shift_mix.ref import (layer_norm,
                                                    norm_shift_mix_ref)

BF16_STEPS = 2        # the plain version's three roundings of a mix
# float32 differences of (x - mu) * rstd * scale + bias, |y * scale| up to
# about 8 here, at a few 2^-24 of it
H_ABS = 2.0 ** -16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(card, B, S, d, K, dtype, seed=0):
    """x ~ N(0.5, 2²) in ``dtype``, a nonzero float32 shift, LayerNorm
    parameters near 1 and 0, and K mixes: the first 0 (its output is
    h_{t-1}, the kernel's own normalised rows), the rest uniform in
    [0, 1)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn((B, S, d), generator=g) * 2 + 0.5).to(card, dtype)
    shift = torch.randn((B, d), generator=g).to(card)
    scale = (1 + 0.1 * torch.randn(d, generator=g)).to(card)
    bias = (0.1 * torch.randn(d, generator=g)).to(card)
    mixes = [torch.zeros(d, device=card)] + [
        torch.rand(d, generator=g).to(card) for _ in range(K - 1)]
    return x, shift, scale, bias, mixes


def _step(t):
    """The bf16 spacing at |t| (the smallest normal's where t is 0)."""
    a = t.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _where(bad, **values) -> str:
    """The count of ``bad`` elements and the values at the first few."""
    idx = bad.nonzero()[:4]
    rows = [{k: float(v.expand_as(bad)[tuple(i)]) for k, v in values.items()}
            for i in idx.tolist()]
    return f"{int(bad.sum())} elements, first {rows}"


def _check(x, shift, scale, bias, mixes, outs, new_shift):
    """The holds of the module's docstring, for bf16 x."""
    want, want_shift = norm_shift_mix_ref(x, shift, scale, bias, mixes)
    h_plain = layer_norm(x, scale, bias).double()
    # the kernel's h: out_0 (m = 0) is h_{t-1}, new_shift h_{S-1}
    h = torch.cat([outs[0][:, 1:].double(), new_shift[:, None].double()], 1)
    hp = outs[0].double()
    assert torch.equal(hp[:, :1, :],
                       shift.to(x.dtype).double()[:, None, :])
    dh = (h - h_plain).abs()
    bad = dh > _step(h_plain) + H_ABS
    assert not bool(bad.any()), _where(bad, h=h, h_plain=h_plain)
    # a flip needs the two float32 values (about 1e-6 apart) to straddle
    # a bf16 rounding boundary: about 1e-6 / step(h) of the elements
    assert float((dh > 0).double().mean()) < 1e-2, float(
        (dh > 0).double().mean())
    hp_plain = torch.cat([shift.to(x.dtype).double()[:, None],
                          h_plain[:, :-1]], 1)
    dhp = (hp - hp_plain).abs()
    big = torch.maximum(h_plain.abs(), hp_plain.abs())
    for m, out, ref in zip(mixes, outs, want):
        assert out.dtype == x.dtype and out.shape == x.shape
        mb = m.to(x.dtype).double()
        exact = hp + (h - hp) * mb
        once = exact.to(x.dtype).double()
        got = out.double()
        # h_t - h_{t-1} is exact in float32 unless the two lie more than
        # 16 binades apart; then it rounds, by up to 2^-24 of the larger
        bad = (got - once).abs() > _step(once) + 2.0 ** -24 * (
            h.abs() + hp.abs())
        assert not bool(bad.any()), _where(bad, got=got, once=once, h=h,
                                           hp=hp, m=mb)
        err = (got - ref.double()).abs()
        bad = err > BF16_STEPS * _step(big) + dh + dhp
        assert not bool(bad.any()), _where(bad, got=got, ref=ref.double(),
                                           h=h, hp=hp, m=mb)
    assert new_shift.dtype == torch.float32
    assert torch.equal(new_shift, h[:, -1].float())
    assert bool(((new_shift.double() - want_shift.double()).abs()
                 <= _step(want_shift) + H_ABS).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,d,K", [
    (4, 8192, 2048, 5),     # the cell's largest batch, time-mix site
    (4, 8192, 2048, 2),     # and its channel-mix site
    (4, 2048, 2048, 5),     # the cell's smallest batch
    (4, 2048, 2048, 2),
    (4, 1001, 2048, 5),     # runs of 2 rows: S no multiple of the run
    (2, 3, 2048, 5),        # S = 3
    (4, 1, 2048, 5),        # decode: S = 1
    (4, 1, 2048, 2),
    (2, 37, 64, 5),         # the reduced width: most lanes idle
])
def test_kernel_matches_plain(card, B, S, d, K):
    x, shift, scale, bias, mixes = _inputs(card, B, S, d, K, torch.bfloat16)
    before = ops.launches
    outs, new_shift = ops.norm_shift_mix(x, shift, scale, bias, mixes)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert len(outs) == K
    _check(x, shift, scale, bias, mixes, outs, new_shift)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048, 64])
def test_float32_kernel_matches_plain(card, d):
    """float32 x (the f32 activations phase 4 of chip_smoke.py runs): no
    rounding to bf16 anywhere, so within float32 sums in another order."""
    x, shift, scale, bias, mixes = _inputs(card, 2, 333, d, 5,
                                           torch.float32)
    outs, new_shift = ops.norm_shift_mix(x, shift, scale, bias, mixes)
    want, want_shift = norm_shift_mix_ref(x, shift, scale, bias, mixes)
    for got, ref in zip(outs, want):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(new_shift, want_shift, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("runs,copies,chunks,K", [
    (1, 512, 1, 5),     # one row a warp, against a batch of 512 copies
    (4, 8, 1, 5),       # four, against eight copies
    (64, 1, 2, 2),      # the longest run, against the sequence in halves
])
def test_run_length_changes_no_bit(card, runs, copies, chunks, K):
    """Each row is normalised by one warp alone, so the rows a warp walks
    (the halo row recomputed at each run's start) change nothing.  The
    kernel picks the run length from the row count, so one sequence whose
    length gives ``runs`` rows a warp is held against itself computed at
    another run length: inside a batch of ``copies`` copies of it, or in
    ``chunks`` chunks with the shift handed over."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    S = (runs - 1) * sms * 16 + 7       # 16 warps an SM over the grid
    x, shift, scale, bias, mixes = _inputs(card, 1, S, 2048, K,
                                           torch.bfloat16, seed=4)
    assert ops.rows_per_warp(S) == runs
    outs, new_shift = ops.norm_shift_mix(x, shift, scale, bias, mixes)
    xs, shifts = x.expand(copies, S, 2048), shift.expand(copies, 2048)
    cut = -(-S // chunks)
    assert ops.rows_per_warp(copies * cut) != runs
    got, mid = [], shifts
    for c in range(chunks):
        part, mid = ops.norm_shift_mix(xs[:, c * cut:(c + 1) * cut], mid,
                                       scale, bias, mixes)
        got.append(torch.stack(part))
    got = torch.cat(got, 2)
    for i in range(copies):
        assert torch.equal(got[:, i], torch.stack(outs)[:, 0])
        assert torch.equal(mid[i], new_shift[0])


@pytest.mark.cuda
def test_chunks_compose_bitwise(card):
    """A prompt in two chunks, the first chunk's new shift handed to the
    second, gives the whole prompt's mixed inputs bit for bit: the new
    shift is exactly the state the next chunk needs."""
    x, shift, scale, bias, mixes = _inputs(card, 2, 300, 2048, 5,
                                           torch.bfloat16, seed=5)
    whole, last = ops.norm_shift_mix(x, shift, scale, bias, mixes)
    a, mid = ops.norm_shift_mix(x[:, :129], shift, scale, bias, mixes)
    b, end = ops.norm_shift_mix(x[:, 129:], mid, scale, bias, mixes)
    for w, u, v in zip(whole, a, b):
        assert torch.equal(torch.cat([u, v], 1), w)
    assert torch.equal(end, last)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [5, 2])
def test_backward_matches_autograd_of_the_plain_version(card, K):
    """Under autograd the kernel's forward runs (``NormShiftMixFn``) and
    its closed-form backward gives autograd's gradients of the plain
    version, for x, the shift, the LayerNorm's parameters and every mix:
    in float32, within sums in another order."""
    ins = _inputs(card, 2, 97, 2048, K, torch.float32, seed=6)
    x, shift, scale, bias, mixes = [
        [m.clone().requires_grad_() for m in t] if isinstance(t, list)
        else t.clone().requires_grad_() for t in ins]
    leaves = [x, shift, scale, bias, *mixes]
    g = torch.Generator(device="cpu").manual_seed(7)
    g_outs = [torch.randn(x.shape, generator=g).to(card) for _ in mixes]
    g_shift = torch.randn(shift.shape, generator=g).to(card)
    grads = {}
    for name, fn in (("kernel", ops.norm_shift_mix),
                     ("plain", norm_shift_mix_ref)):
        before = ops.launches
        outs, new_shift = fn(x, shift, scale, bias, mixes)
        grads[name] = torch.autograd.grad((*outs, new_shift), leaves,
                                          (*g_outs, g_shift))
        assert ops.launches == before + (name == "kernel")
    for got, want in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_launches_on_rwkv6_prefill_and_training(card):
    """A 24-layer rwkv6 prefill (the reduced width) launches the kernel
    twice a layer, 48 times, beside 24 WKV6 launches; a training forward
    and backward launches it as often (``NormShiftMixFn``: the kernel
    forward, the backward in PyTorch ops) and gives every parameter of
    the LayerNorms and mixes a gradient."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import ops as wkv
    from repro_torch.models import (forward_prefill, forward_train,
                                    init_cache, init_lm)
    cfg = dataclasses.replace(get_config("rwkv6_1_6b", reduced=True),
                              n_layers=24)
    model = init_lm(cfg, torch.Generator(device=card).manual_seed(0),
                    device=card)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=card,
                         dtype=torch.int32)
    ops.launches = wkv.launches = 0
    with torch.no_grad():
        logits, _ = forward_prefill(cfg, model, {"tokens": toks},
                                    init_cache(cfg, 2, 40, card))
    torch.cuda.synchronize()
    assert (ops.launches, wkv.launches) == (48, 24)
    assert torch.isfinite(logits).all()
    ops.launches = 0
    model.requires_grad_(True)
    logits, _ = forward_train(cfg, model, {"tokens": toks})
    logits.float().square().mean().backward()
    assert ops.launches == 48
    for blk in model.blocks:
        for p in (blk.rwkv.mix_r, blk.rwkv.mix_w, blk.ln1.scale,
                  blk.ln1.bias, blk.ln2.scale, blk.ln2.bias):
            assert p.grad is not None and torch.isfinite(p.grad).all()


@pytest.mark.cuda
def test_cuda_path_refuses_what_it_does_not_take(card):
    x, shift, scale, bias, mixes = _inputs(card, 2, 8, 64, 5,
                                           torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.norm_shift_mix_cuda(x.cpu(), shift.cpu(), scale.cpu(),
                                bias.cpu(), [m.cpu() for m in mixes])
    with pytest.raises(ValueError, match="1 to 5 mixes"):
        ops.norm_shift_mix(x, shift, scale, bias, mixes + mixes[:1])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.norm_shift_mix(x.half(), shift, scale, bias, mixes)
    with pytest.raises(ValueError, match="shift must be"):
        ops.norm_shift_mix(x, shift[:1], scale, bias, mixes)
    with pytest.raises(ValueError, match="a mix must be"):
        ops.norm_shift_mix(x, shift, scale, bias, [m[:32] for m in mixes])
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.norm_shift_mix(x[..., :60], shift[:, :60], scale[:60],
                           bias[:60], [m[:60] for m in mixes])
    wide = torch.zeros((1, 2, 8192), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 4096"):
        ops.norm_shift_mix(wide, torch.zeros((1, 8192), device=card),
                           *[torch.zeros(8192, device=card)] * 2,
                           [torch.zeros(8192, device=card)])
    with pytest.raises(ValueError, match="contiguous"):
        ops.norm_shift_mix(x.transpose(1, 2).contiguous().transpose(1, 2),
                           shift, scale, bias, mixes)
    off = torch.zeros(2 * 8 * 64 + 1, device=card,
                      dtype=torch.bfloat16)[1:].view(2, 8, 64)
    with pytest.raises(RuntimeError, match="16-byte"):
        ops.norm_shift_mix(off, shift, scale, bias, mixes)
