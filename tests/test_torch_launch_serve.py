"""The serving launcher of the port (``repro_torch.launch.serve``) on the
CPU against the reference's prefill and decode, on reduced configs with the
reference launcher's bf16 weights (``init_lm(..., dtype=bfloat16)``)
carried over.

Each step's logits of the port's greedy run are held against the
reference's ``forward_prefill`` and ``forward_decode`` fed the same tokens
(the reference teacher-forced with the port's choices), at rtol = atol =
2e-2 of the logits as ``test_torch_models.py`` holds them; where the
reference's own top two logits stand further apart than that tolerance,
its argmax must be the port's choice.  The batch (tokens, frames,
patches) is the reference launcher's, bit for bit."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import (forward_decode as jdecode,
                          forward_prefill as jprefill, init_cache as jcache,
                          init_lm as jinit)
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["hymba_1_5b", "seamless_m4t_medium", "internvl2_76b", "gemma3_12b"]
TOL = 2e-2


def _reference_batch(cfg, B, S):
    """The reference launcher's batch, written out as its ``main`` makes
    it."""
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    cross = S // 4 if cfg.n_encoder_layers else 0
    if cfg.n_encoder_layers:
        batch["frames"] = rng.randn(B, cross, cfg.d_model).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patches"] = rng.randn(B, cfg.n_frontend_tokens,
                                     cfg.d_model).astype(np.float32) * 0.02
    return batch, cross


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_logits_match_reference_forward(arch):
    B, S, new = 2, 32, 6
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    # bf16 leaves reach the port through float32 (exact both ways)
    model = from_jax_params(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params), cfg, "cpu").to(
        torch.bfloat16)
    out = serve.generate(cfg, batch=B, prompt_len=S, new_tokens=new,
                         device="cpu", model=model)
    batch, cross = _reference_batch(jcfg, B, S)
    for k, v in batch.items():
        np.testing.assert_array_equal(out["batch"][k].numpy(), v)
    toks = out["tokens"]
    assert toks.shape == (B, new) and toks.dtype == np.int32
    assert len(out["logits"]) == new

    jc = jcache(jcfg, B, S + new, cross_len=cross)
    jl, jc = jprefill(jcfg, params, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jc)
    for i, got in enumerate(out["logits"]):
        if i:
            jl, jc = jdecode(jcfg, params, jnp.asarray(toks[:, i - 1:i]), jc,
                             jnp.int32(S + i - 1))
        want = np.asarray(jl)
        assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * TOL
        np.testing.assert_array_equal(toks[clear, i],
                                      want.argmax(-1)[clear])


@pytest.mark.parametrize("arch", ["hymba_1_5b", "seamless_m4t_medium",
                                  "internvl2_76b"])
def test_main_prints_the_reference_lines(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--prompt-len", "16", "--new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device cpu | generated 8 tokens in ")
    assert lines[0].endswith("tok/s)")
    assert lines[1].startswith("sample: [")


def test_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert "generated 32 tokens" in lines[0]
    assert lines[1].startswith("sample: [")


def test_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.generate(get_config("gemma3_12b", reduced=True))
