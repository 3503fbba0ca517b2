"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``) on the CPU, at the examples' own reduced sizes.

* quickstart: the reference example run in-process after
  ``np.random.seed(0)``, then the port's ``main(["--device", "cpu"])``
  after the same seed: z at rtol 1e-5, two lanes each.
* serve_lm (gemma3_12b and rwkv6_1_6b, reduced): the reference example's
  printed sample tokens, every token of the reference's own prefill and
  decode steps over the same prompts and ``init_lm(PRNGKey(0))`` weights
  (the example's kernel body restated here), and the port's
  ``serve_requests`` on CPU lanes with those weights carried over by
  ``from_jax_params``: the tokens identical.
* train_lm: the reference's trainer built as its example builds it and the
  port's through ``build``, both from the reference's seed-0 parameters:
  5 losses at rtol 1e-3 (bf16 activations round differently in the two
  frameworks, as in ``test_torch_runtime.py``).
* the port's access-mode lint over the three examples, and each example's
  ``main([])`` raising without a card.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_cache as jcache, init_lm as jinit
from repro.optim import AdamW as JAdamW
from repro.runtime import TaskGraphTrainer as JTrainer
from repro.runtime import make_decode_step as jdecode_step
from repro.runtime import make_prefill_step as jprefill_step
from repro_torch.configs import get_config
from repro_torch.core import make_scheduler
from repro_torch.models import from_jax_params, init_cache
from repro_torch.runtime import (TrainState, make_decode_step,
                                 make_prefill_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
PORT_EXAMPLES = ("torch_quickstart", "torch_serve_lm", "torch_train_lm")
# Logits of the two frameworks differ by about 5e-3 on the reduced configs
# (bf16 activations round apart; ROADMAP C6), so a greedy token may differ
# only where the reference's top-2 margin is under twice that.
BF16_GAP = 5e-3


def _load(name):
    """An example of the port as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(name, argv=None, call_main=False):
    """Runs ``examples/<name>.py`` of the reference in-process; returns
    what it printed."""
    buf = io.StringIO()
    path = os.path.join(EXAMPLES, f"{name}.py")
    saved = sys.argv
    sys.argv = [path] + list(argv or [])
    try:
        with contextlib.redirect_stdout(buf):
            ns = runpy.run_path(path)
            if call_main:
                ns["main"]()
    finally:
        sys.argv = saved
    return buf.getvalue()


def test_quickstart_matches_reference():
    np.random.seed(0)
    out = _run_reference("quickstart")          # runs at import
    want = float(re.search(r"^z = (\S+)$", out, re.M).group(1))
    want_lanes = int(re.search(r"ran on (\d+) lanes", out).group(1))
    np.random.seed(0)
    z, lanes = _load("torch_quickstart").main(["--device", "cpu"])
    np.testing.assert_allclose(z, want, rtol=1e-5)
    assert lanes == want_lanes == 2


def _reference_tokens(jcfg, params, prompts, new):
    """The reference example's kernel body, restated: each request
    batch's greedy tokens (B, new) and the top-2 logit margin at each."""
    prefill = jax.jit(jprefill_step(jcfg))
    decode = jax.jit(jdecode_step(jcfg))
    tokens, margins = [], []
    for toks in prompts:
        B, S = toks.shape
        logits, cache = prefill(params, {"tokens": jnp.asarray(toks)},
                                jcache(jcfg, B, S + new))
        outs, gaps = [], []
        for i in range(new):
            top2 = np.sort(np.asarray(logits), -1)[:, -2:]
            gaps.append(top2[:, 1] - top2[:, 0])
            nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            outs.append(np.asarray(nxt))
            if i < new - 1:
                nxt, logits, cache = decode(params, nxt, cache,
                                            jnp.int32(S + i))
        tokens.append(np.concatenate(outs, 1))
        margins.append(np.stack(gaps, 1))
    return tokens, margins


def _port_tokens_forced(cfg, model, toks, forced):
    """The port's greedy choice at each position when fed the reference's
    tokens ``forced`` (B, new) instead of its own: (B, new)."""
    B, S = toks.shape
    new = forced.shape[1]
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    with torch.no_grad():
        logits, cache = prefill(model, {"tokens": torch.from_numpy(toks)},
                                init_cache(cfg, B, S + new, "cpu"))
        picks = [torch.argmax(logits, -1)]
        for i in range(new - 1):
            nxt = torch.from_numpy(forced[:, i:i + 1])
            pick, _, cache = decode(model, nxt, cache, S + i)
            picks.append(pick[:, 0])
    return torch.stack(picks, 1).numpy()


@pytest.mark.parametrize("arch", ["gemma3_12b", "rwkv6_1_6b"])
def test_serve_lm_tokens_match_reference(arch):
    requests, batch, plen, new = 2, 2, 32, 8
    out = _run_reference("serve_lm", ["--arch", arch, "--requests",
                                      str(requests), "--new-tokens",
                                      str(new)], call_main=True)
    printed = [np.array(m.split(), np.int64) for m in re.findall(
        r"^req\d+ sample tokens: \[([\d\s]+)\]", out, re.M)]
    jcfg = jget_config(arch, reduced=True)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, jcfg.vocab, (batch, plen)).astype(np.int32)
               for _ in range(requests)]
    want, margins = _reference_tokens(jcfg, params, prompts, new)
    assert len(printed) == requests
    for p, w in zip(printed, want):
        np.testing.assert_array_equal(p, w[0, :8])

    cfg = get_config(arch, reduced=True)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            "cpu")
    sched = make_scheduler("parallel", device="cpu")
    try:
        got = _load("torch_serve_lm").serve_requests(sched, cfg, model,
                                                     prompts, new)
        lanes = sched.streams.lanes_created
    finally:
        sched.shutdown()
    assert lanes == requests
    for r, (g, w, m) in enumerate(zip(got, want, margins)):
        assert g.shape == (batch, new) and g.dtype == np.int32
        for b in range(batch):
            differ = np.flatnonzero(g[b] != w[b])
            if not differ.size:
                continue
            # A request whose tokens part where the reference's margin is
            # within the frameworks' gap is compared teacher-forced from
            # there on: fed the reference's tokens, the port must pick the
            # reference's token wherever the margin is wider.
            i = differ[0]
            assert m[b, i] < 2 * BF16_GAP, (r, b, i, m[b, i])
            print(f"req{r} row {b}: tokens part at {i} where the reference's "
                  f"top-2 margin is {m[b, i]:.2e}; compared teacher-forced "
                  f"from there on")
            forced = _port_tokens_forced(cfg, model, prompts[r], w)[b]
            wide = m[b] >= 2 * BF16_GAP
            np.testing.assert_array_equal(forced[wide], w[b][wide])


def test_train_lm_losses_match_reference():
    steps, seq, batch = 5, 32, 2
    ex = _load("torch_train_lm")
    args = ex.parse_args(["--seq", str(seq), "--batch", str(batch),
                          "--steps", str(steps), "--device", "cpu"])
    cfg, trainer = ex.build(args)
    # The reference example's config and trainer (examples/train_lm.py).
    jcfg = dataclasses.replace(
        jget_config("qwen3_32b", reduced=True), d_model=256, n_heads=8,
        n_kv_heads=4, head_dim=32, d_ff=1024, n_layers=4, vocab=8192)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jt = JTrainer(jcfg, seq_len=seq, global_batch=batch, accum=1,
                  optimizer=JAdamW(lr=3e-4, warmup=20,
                                   total_steps=max(100, steps)),
                  ckpt_dir=None, ckpt_every=20)
    try:
        want = jt.run(steps, metrics_every=1).losses
    finally:
        jt.sched.shutdown()
    params = jinit(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            "cpu")
    try:
        got = trainer.run(steps, state=TrainState(
            model, trainer.optimizer.init(model)), metrics_every=1).losses
    finally:
        trainer.sched.shutdown()
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_lint_checks_the_examples_declarations():
    files = [a for name in PORT_EXAMPLES
             for a in ("--file", os.path.join("examples", f"{name}.py"))]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "lint", *files,
         "--json"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    # the JSON report, then the CLI's timing line
    report, _ = json.JSONDecoder().raw_decode(res.stdout)
    assert report["issues"] == 0
    # quickstart's square and RED (the benchsuite declares a RED too)
    ours = [r for r in report["reports"] if r["function"] == "square"] + [
        r for r in report["reports"] if r["function"] == "RED"][-1:]
    assert [r["modes"] for r in ours] == [["const", "out"],
                                          ["const", "const", "out"]]
    assert sum(r["function"] == "RED" for r in report["reports"]) == 2
    for r in ours:
        assert r["skipped"] is None and r["issues"] == [], r


@pytest.mark.parametrize("name", PORT_EXAMPLES)
def test_example_raises_without_a_card(monkeypatch, name):
    """``main([])`` runs on the card; without one it raises before it draws
    a random number or builds a model."""
    ex = _load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.random.seed(0)
    before = np.random.rand()
    np.random.seed(0)
    with pytest.raises(RuntimeError, match="cuda"):
        ex.main([])
    assert np.random.rand() == before
