"""``ServingEngine`` on the card with ``use_flash`` left at its default (on
on the card): every prefill goes through the flash kernel, at a head dim
the wrapper pads (a reduced config's 16) and at nemotron's 192, which the
kernels take natively.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor the JAX package:

    python -m pytest -q --noconftest -m cuda tests/test_torch_serving_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import init_lm
from repro_torch.runtime import ServingEngine


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,reduced,layers,dtype", [
    ("qwen3_32b", True, None, torch.float32),        # hd 16, padded to 64
    # full width (d 18432, H 96, Hkv 8, hd 192) cut to 1 of 96 layers:
    # 12.9e9 parameters, 25.8 GB in bf16
    ("nemotron_4_340b", False, 1, torch.bfloat16),
])
def test_serving_engine_prefills_through_flash(card, arch, reduced, layers,
                                               dtype):
    cfg = get_config(arch, reduced=reduced)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda", dtype=dtype)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, 64).astype(np.int32)
               for _ in range(4)]
    new = 4
    eng = ServingEngine(cfg, model, batch_size=2, max_new_tokens=new)
    assert eng.use_flash is True                 # the default on the card
    before = flash_ops.launches
    try:
        reqs = [eng.submit(p) for p in prompts]
        eng.drain()
    finally:
        eng.close()
    # one flash call a layer in each of the two batches' prefills
    assert flash_ops.launches - before == cfg.n_layers * 2
    for r in reqs:
        assert r.result is not None and r.result.shape == (new,)
        assert ((r.result >= 0) & (r.result < cfg.vocab)).all()
    del eng, model
    torch.cuda.empty_cache()
