"""Serving parity: the port's ``ServingEngine`` on the CPU against the JAX
engine, with the reference's weights carried over; and the engine's pure
batch-ordering logic (weighted-fair stride order), ported from
``tests/test_serving.py``."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import (forward_decode as jdecode,
                          forward_prefill as jprefill, init_cache as jcache,
                          init_lm as jinit)
from repro.runtime.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.core import make_scheduler
from repro_torch.models import (forward_decode, forward_prefill,
                                from_jax_params, init_cache)
from repro_torch.runtime.serving import ServingEngine

LOGIT_TOL = 2e-2    # the bf16 logit tolerance of test_torch_models.py


def _greedy_steps(jcfg, params, cfg, model, toks, new):
    """Run the reference's greedy decode and feed the port the same tokens.

    Returns, per request and step, the reference's top-2 logit margin and
    the largest |port - reference| logit difference: (B, new) each."""
    B, S = toks.shape
    jc = jcache(jcfg, B, S + new)
    jl, jc = jprefill(jcfg, params, {"tokens": jnp.asarray(toks)}, jc)
    tc = init_cache(cfg, B, S + new, "cpu")
    tl, tc = forward_prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                             tc)
    margins, diffs = [], []
    for i in range(new):
        ref = np.asarray(jl)
        top2 = np.sort(ref, -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        diffs.append(np.abs(tl.numpy() - ref).max(-1))
        nxt = np.argmax(ref, -1)[:, None].astype(np.int32)
        if i < new - 1:
            jl, jc = jdecode(jcfg, params, jnp.asarray(nxt), jc,
                             jnp.int32(S + i))
            tl, tc = forward_decode(cfg, model, torch.from_numpy(nxt), tc,
                                    S + i)
    return np.stack(margins, 1), np.stack(diffs, 1)


def test_serving_engine_matches_jax_engine():
    arch, batch, new = "qwen3_32b", 2, 6
    jcfg = jget_config(arch, reduced=True)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(arch, reduced=True)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, 16) for _ in range(7)]
    prompts.append(prompts[0].copy())            # same prompt, later batch

    eng = ServingEngine(cfg, model, batch_size=batch, max_new_tokens=new,
                        device="cpu")
    assert eng.use_flash is False                # off by default on the CPU
    try:
        got = [eng.submit(p) for p in prompts]
        eng.flush()
        assert len(eng.collect()) == len(prompts)
        lanes = eng.stats()["lanes_created"]
    finally:
        eng.close()
    jeng = JServingEngine(jcfg, params, batch_size=batch, max_new_tokens=new)
    try:
        want = [jeng.submit(p) for p in prompts]
        jeng.flush()
        jeng.collect()
    finally:
        jeng.close()

    assert lanes >= 2
    for r in got:
        assert r.result.shape == (new,) and r.result.dtype == np.int32
    np.testing.assert_array_equal(got[0].result, got[-1].result)
    compared = 0
    for b in range(0, len(prompts), batch):
        toks = np.stack([p.astype(np.int32) for p in prompts[b:b + batch]])
        margins, diffs = _greedy_steps(jcfg, params, cfg, model, toks, new)
        assert diffs.max() <= LOGIT_TOL          # logit parity
        # Where every logit differs by at most d, the greedy token can only
        # flip where the reference's top-2 margin is under 2 d: compare each
        # request's tokens up to its first such step.
        tol = 2 * diffs.max()
        for j, row in zip(range(b, b + batch), margins):
            upto = next((i for i, m in enumerate(row) if m <= tol), new)
            if upto < new:
                print(f"request {j}: reference top-2 margin {row[upto]:.2e} "
                      f"<= {tol:.2e} at step {upto}; comparing the {upto} "
                      f"tokens before it only")
            np.testing.assert_array_equal(got[j].result[:upto],
                                          want[j].result[:upto])
            compared += upto
    assert compared >= len(prompts) * new // 2, compared


def test_use_flash_switch_reaches_prefill_on_cpu():
    """``use_flash=True`` on the CPU takes the flash wrapper's plain path
    and serves the same tokens."""
    cfg = get_config("qwen3_32b", reduced=True)
    jparams = jinit(jax.random.PRNGKey(1), jget_config("qwen3_32b",
                                                       reduced=True))
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                            "cpu")
    prompts = [np.random.RandomState(3).randint(0, cfg.vocab, 16)
               for _ in range(2)]
    results = []
    for use_flash in (False, True):
        eng = ServingEngine(cfg, model, batch_size=2, max_new_tokens=4,
                            device="cpu", use_flash=use_flash)
        try:
            reqs = [eng.submit(p) for p in prompts]
            eng.drain()
        finally:
            eng.close()
        assert eng.use_flash is use_flash
        results.append(np.stack([r.result for r in reqs]))
    np.testing.assert_array_equal(results[0], results[1])


def test_engine_refuses_weights_on_another_device():
    cfg = get_config("qwen3_32b", reduced=True)
    from repro_torch.models import init_lm
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    model.to("meta")
    with pytest.raises(ValueError, match="weights"):
        ServingEngine(cfg, model, device="cpu")


# ----------------------------------------------------------------------
# Multi-tenant QoS: weighted-fair batch assembly (pure ordering logic)
# ----------------------------------------------------------------------

def _engine_shell(batch=2):
    """ServingEngine shell without a model: enough state for
    submit()/flush() ordering tests (issue step stubbed per test)."""
    eng = ServingEngine.__new__(ServingEngine)
    eng.batch = batch
    eng.max_new = 4
    eng.sched = make_scheduler("parallel", simulate=True)
    eng.capture = False
    eng._queue = collections.deque()
    eng._rid = 0
    eng._pending = []
    return eng


def test_weighted_fair_batch_assembly_order():
    eng = _engine_shell(batch=2)
    order = []
    eng._issue_batch = lambda plen, ntok, tenant, prio, group: \
        order.append((tenant, len(group)))
    rng = np.random.RandomState(0)
    for _ in range(6):      # 3 bulk batches
        eng.submit(rng.randint(0, 100, 8), 4, tenant="bulk", priority=0)
    for _ in range(6):      # 3 latency batches
        eng.submit(rng.randint(0, 100, 8), 4, tenant="lat", priority=3)
    eng.flush()
    assert order == [("bulk", 2), ("lat", 2), ("lat", 2), ("lat", 2),
                     ("bulk", 2), ("bulk", 2)]
    order.clear()
    for _ in range(2):
        eng.submit(rng.randint(0, 100, 8), 4, tenant="bulk", priority=0)
        eng.submit(rng.randint(0, 100, 8), 4, tenant="lat", priority=3)
    eng.flush()
    assert order == [("bulk", 2), ("lat", 2)]


def test_tenant_high_priority_batch_issues_before_its_own_low():
    eng = _engine_shell(batch=2)
    order = []
    eng._issue_batch = lambda plen, ntok, tenant, prio, group: \
        order.append(prio)
    rng = np.random.RandomState(2)
    eng.submit(rng.randint(0, 100, 8), 4, tenant="m", priority=0)
    eng.submit(rng.randint(0, 100, 16), 4, tenant="m", priority=3)
    eng.flush()
    assert order == [3, 0]


def test_weighted_fair_keeps_shape_batches_intact():
    eng = _engine_shell(batch=2)
    seen = []
    eng._issue_batch = lambda plen, ntok, tenant, prio, group: \
        seen.append((plen, ntok, tenant, prio,
                     [r.tenant for r in group], [len(r.tokens) for r in group]))
    rng = np.random.RandomState(1)
    eng.submit(rng.randint(0, 100, 8), 4, tenant="a", priority=0)
    eng.submit(rng.randint(0, 100, 16), 4, tenant="a", priority=0)
    eng.submit(rng.randint(0, 100, 8), 4, tenant="b", priority=1)
    eng.flush()
    assert len(seen) == 3
    for plen, ntok, tenant, _prio, tenants, plens in seen:
        assert all(t == tenant for t in tenants)
        assert all(p == plen for p in plens)


def test_batch_wait_holds_underfull_batches_until_forced():
    """``max_batch_wait_s`` requeues an under-full batch; ``force`` (the
    drain path) issues it."""
    eng = _engine_shell(batch=2)
    eng.max_batch_wait_s = 1e9
    issued = []
    eng._issue_batch = lambda plen, ntok, tenant, prio, group: \
        issued.append(len(group))
    eng.submit(np.arange(8), 4)
    eng.flush()
    assert issued == [] and len(eng._queue) == 1
    eng.flush(force=True)
    assert issued == [1] and not eng._queue
