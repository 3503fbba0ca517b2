"""The multi-device slice on the card, over an NCCL world of one rank (a
(1, 1) mesh: the round has one card): the three kernel wrappers on
``DTensor``s launch their kernels through ``local_map`` and give the
direct calls' bits, and reduced qwen3's sharded train step gives the plain
step's bits.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor the JAX package:

    python -m pytest -q --noconftest -m cuda tests/test_torch_sharding_cuda.py
"""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world, make_mesh_for
    made = init_world("cuda")
    try:
        yield make_mesh_for(1, 2)
    finally:
        if made:
            dist.destroy_process_group()


def _put(t, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    return distribute_tensor(t, mesh, [Replicate(), Replicate()])


def test_kernel_wrappers_launch_on_dtensors(mesh):
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.rwkv6 import ops as wkv
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    x, s = rnd(4, 256, 5120), rnd(5120, dtype=torch.float32)
    q, k, v = rnd(2, 512, 8, 128), rnd(2, 512, 2, 128), rnd(2, 512, 2, 128)
    r, kk, vv = rnd(2, 64, 4, 64), rnd(2, 64, 4, 64), rnd(2, 64, 4, 64)
    w = torch.rand((2, 64, 4, 64), generator=g, device="cuda") * 0.5 + 0.4
    u, s0 = rnd(4, 64, dtype=torch.float32), rnd(2, 4, 64, 64,
                                                 dtype=torch.float32)
    cases = [
        (rms, lambda f: rms.rmsnorm(*map(f, (x, s)))),
        (flash, lambda f: flash.flash_attention(*map(f, (q, k, v)),
                                                window=128)),
        (wkv, lambda f: wkv.wkv6(*map(f, (r, kk, vv, w, u, s0)))[0]),
    ]
    for ops, call in cases:
        want = call(lambda t: t)
        before = ops.launches
        got = call(lambda t: _put(t, mesh))
        assert ops.launches == before + 1, ops.__name__
        assert torch.equal(got.full_tensor(), want), ops.__name__


def test_sharded_train_step_is_the_plain_step(mesh):
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.models import init_lm
    from repro_torch.optim import AdamW
    from repro_torch.runtime.steps import TrainState, make_train_step
    from repro_torch.sharding.context import sharding_rules
    from repro_torch.sharding.rules import (NamedSharding, batch_spec,
                                            logical_to_physical,
                                            param_sharding, place)
    cfg = get_config("qwen3_32b", reduced=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticTokenStream(
        cfg, 64, 4, accum=2).batch(0).items()}

    def run(sharded):
        opt = AdamW(lr=1e-3)
        m = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
        b = batch
        if sharded:
            logical_to_physical(mesh, m, param_sharding(m, mesh))
            bs = batch_spec(mesh)
            b = {k: place(t, NamedSharding(mesh, (None,) + bs[k]))
                 for k, t in batch.items()}
        step = make_train_step(cfg, opt)
        if sharded:
            with sharding_rules(mesh):
                _, met = step(TrainState(m, opt.init(m)), b)
        else:
            _, met = step(TrainState(m, opt.init(m)), b)
        return float(met["loss"]), {
            n: (p.full_tensor() if sharded else p).detach()
            for n, p in m.named_parameters()}
    loss0, p0 = run(False)
    loss1, p1 = run(True)
    assert loss0 == loss1
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
