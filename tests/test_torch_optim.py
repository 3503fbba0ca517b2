"""AdamW of the port against ``repro.optim``: the same parameters and
gradients, made from a numpy seed, through both.

Tolerances: the update is f32 elementwise arithmetic in the same order, so
parameters, moments, ``grad_norm`` and ``lr`` agree to rtol 1e-6 (a few
f32 steps: the frameworks may fuse a multiply and an add differently and
sum a leaf's squares in another order, which moves the clip factor by an
f32 step).  An element of a leaf is held to 1e-6 of its own size or of the
leaf's largest, whichever is larger: a moment that crosses zero keeps the
absolute error of its neighbours.  q8 codes are held equal exactly and
their scales within 1e-7."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import Q8State as JQ8State
from repro.optim import dequantize_q8 as jdequantize_q8
from repro.optim import quantize_q8 as jquantize_q8
from repro_torch.optim import (AdamW, Q8State, dequantize_q8, named_leaves,
                               quantize_q8)

RTOL = 1e-6
SHAPES = {"w": (6, 130), "b": (130,), "stack": (2, 3, 40)}


def _params(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.standard_normal(s).astype(np.float32) * 0.5
            for k, s in SHAPES.items()}


def _grads(seed, scale):
    rng = np.random.RandomState(1000 + seed)
    return {k: rng.standard_normal(s).astype(np.float32) * scale
            for k, s in SHAPES.items()}


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _to_np(x):
    if isinstance(x, (Q8State, JQ8State)):
        return tuple(np.asarray(t) for t in x)
    return np.asarray(x)


@pytest.mark.parametrize("grad_scale", [0.01, 1.0], ids=["no-clip", "clip"])
def test_adamw_update_matches_reference(grad_scale):
    """Twelve updates over warmup (4 steps) and the cosine decay (to step
    10) and past it: params, moments, grad_norm and lr each step."""
    kw = dict(lr=1e-2, warmup=4, total_steps=10, weight_decay=0.1)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    p0 = _params(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(12):
        g = _grads(step, grad_scale)
        jp, js, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp)
        tm = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                         ts, tp)
        assert ts.step == int(js.step) == step + 1
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        for k in SHAPES:
            _close(tp[k].numpy(), jp[k])
            _close(ts.m[k].numpy(), js.m[k])
            _close(ts.v[k].numpy(), js.v[k])


def test_schedule_matches_reference_over_warmup_and_cosine():
    kw = dict(lr=3e-4, warmup=20, total_steps=100)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    for step in (0, 1, 7, 19, 20, 21, 55, 99, 100, 150):
        np.testing.assert_allclose(topt.schedule(step),
                                   float(jopt.schedule(jnp.int32(step))),
                                   rtol=RTOL)


@pytest.mark.parametrize("shape", [(), (5,), (3, 128), (2, 3, 200), (4, 257)],
                         ids=str)
def test_quantize_q8_matches_reference(shape):
    x = np.asarray(np.random.RandomState(3).standard_normal(shape) * 3,
                   np.float32)
    jc, js = jquantize_q8(jnp.asarray(x))
    tc, tsc = quantize_q8(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(js), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(
        dequantize_q8(tc, tsc, shape).numpy(),
        np.asarray(jdequantize_q8(jc, js, shape)), rtol=RTOL, atol=1e-7)


def test_q8_moments_after_three_updates_match_reference():
    """Quantized moments on the matrices (and the 3-axis leaf), f32 on the
    vector, after three updates: block scales to rtol 1e-6, and codes at
    most one apart, 99% of them equal (a moment that lands on a rounding
    boundary may round one code apart)."""
    kw = dict(lr=1e-2, warmup=2, total_steps=10, quantized=True)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    p0 = _params(4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    assert isinstance(ts.m["w"], Q8State) and not isinstance(ts.m["b"],
                                                             Q8State)
    for step in range(3):
        g = _grads(step, 0.3)
        jp, js, _ = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
        topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
    for k in SHAPES:
        _close(tp[k].numpy(), jp[k])
        for tm, jm in ((ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
            if k == "b":
                _close(tm.numpy(), jm)
                continue
            tc, tsc = _to_np(tm)
            jc, jsc = _to_np(jm)
            assert tc.shape == jc.shape and tsc.shape == jsc.shape
            np.testing.assert_allclose(tsc, jsc, rtol=RTOL)
            assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1
            assert (tc == jc).mean() > 0.99


def test_quantized_adamw_converges():
    """8-bit AdamW behaves like fp32 AdamW on a quadratic toy problem (the
    reference's ``test_quantized_adamw_converges``)."""
    def run(quantized):
        opt = AdamW(lr=0.05, weight_decay=0.0, warmup=1, total_steps=400,
                    quantized=quantized)
        params = {"w": torch.ones((4, 512)) * 3.0}
        state = opt.init(params)
        for _ in range(150):
            grads = {"w": 2 * params["w"]}        # d/dw of w^2
            opt.update(grads, state, params)
        return float(params["w"].abs().max())

    final_fp32 = run(False)
    final_q8 = run(True)
    assert final_fp32 < 0.15
    assert final_q8 < 0.3, f"q8 AdamW diverged: {final_q8}"


def test_missing_gradient_counts_as_zero():
    opt = AdamW(lr=1e-2, warmup=1, weight_decay=0.0)
    params = {"a": torch.ones(3), "b": torch.ones(3)}
    state = opt.init(params)
    m = opt.update({"a": torch.ones(3)}, state, params)
    assert torch.equal(params["b"], torch.ones(3))
    np.testing.assert_allclose(float(m["grad_norm"]), np.sqrt(3), rtol=RTOL)


def test_named_leaves_follow_the_reference_rank_of_a_module():
    """An LM's block parameters count one more axis, as the reference
    stacks them: a block's norm scale gets the weight decay and q8."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    model = init_lm(get_config("qwen3_32b", reduced=True),
                    torch.Generator().manual_seed(0), device="cpu")
    ranks = {n: nd for n, _, nd in named_leaves(model)}
    assert ranks["final_norm.scale"] == 1
    assert ranks["blocks.0.ln1.scale"] == 2
    assert ranks["blocks.1.attn.wq"] == 3
    assert ranks["embed"] == 2
    state = AdamW(quantized=True).init(model)
    assert isinstance(state.m["blocks.0.ln1.scale"], Q8State)
    assert not isinstance(state.m["final_norm.scale"], Q8State)
