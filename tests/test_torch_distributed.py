"""The port's multi-rank paths on the CPU: gloo process groups, one
subprocess per rank (``_torch_gloo.run_gloo``).

* the sharded train step of reduced qwen3 on a (2, 4) mesh against the
  port's own unsharded step (the reference's sharded step cannot run on
  this jax, so it is held against the step that ``test_torch_train.py``
  holds against the reference);
* ``compressed_psum`` on 8 ranks: the reference's bounds, and the
  reference's own reduced values on the same input;
* the harness's teardown: no gloo thread left at a rank's exit;
* the elastic remesh of reduced hymba from 8 to 4 ranks;
* the production meshes on the fake backend (256 and 512 ranks);
* the three kernel wrappers on ``DTensor``s through ``local_map`` (the
  plain versions here, the same wrapper) against the call on whole
  tensors;
* q8 AdamW moments on a mesh: their block layout and a q8 step against
  the plain one.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from _torch_gloo import REPO, run_gloo


def test_sharded_train_step_matches_unsharded_step():
    """Three train steps on a (2, 4) mesh against the unsharded steps.
    Every loss agrees to 1e-4 of its value and every ``grad_norm`` to
    2e-3: a row-parallel product rounds each rank's partial sums to bf16
    before their sum, as the reference's GSPMD does.  The
    parameters' update is held as a whole and leaf by leaf, ||du -
    du_ref|| / ||du_ref||:
    AdamW moves an element by at most about lr whatever its gradient, so
    a wrong gradient moves this toward 1, and a gradient off by a constant
    factor shows in ``grad_norm`` (bounds as in
    ``test_torch_sharded_training.py``)."""
    res = run_gloo("""
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.models import init_lm
        from repro_torch.models.convert import whole
        from repro_torch.optim import AdamW
        from repro_torch.runtime.steps import TrainState, make_train_step
        from repro_torch.sharding.context import sharding_rules
        from repro_torch.sharding.rules import (NamedSharding, batch_spec,
                                                logical_to_physical,
                                                param_sharding, place)
        cfg = get_config("qwen3_32b", reduced=True)
        mesh = make_mesh_for(WORLD, model_parallel=4)
        rng = np.random.RandomState(0)
        batches = [{k: torch.from_numpy(rng.randint(
            0, cfg.vocab, (2, 4, 32)).astype(np.int32))
            for k in ("tokens", "labels")} for _ in range(3)]
        bs = batch_spec(mesh)

        def train(sharded):
            m = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
            p0 = {n: p.detach().clone() for n, p in m.named_parameters()}
            if sharded:
                logical_to_physical(mesh, m, param_sharding(m, mesh))
            opt = AdamW(lr=1e-3)
            step = make_train_step(cfg, opt)
            st, mets = TrainState(m, opt.init(m)), []
            for batch in batches:
                if sharded:
                    batch = {k: place(v, NamedSharding(mesh, (None,) + bs[k]))
                             for k, v in batch.items()}
                    with sharding_rules(mesh):
                        st, met = step(st, batch)
                else:
                    st, met = step(st, batch)
                mets.append([float(met["loss"]), float(met["grad_norm"])])
            return m, mets, {n: whole(p.detach()) - p0[n]
                             for n, p in m.named_parameters()}
        _, plain, du_ref = train(False)
        m, placed, du = train(True)
        sharded = [n for n, p in m.named_parameters()
                   if any(q.is_shard() for q in p.placements)]
        err = sum(float((du[n] - du_ref[n]).square().sum())
                  for n in du_ref) ** 0.5
        ref = sum(float(d.square().sum()) for d in du_ref.values()) ** 0.5
        leaf = max(float((du[n] - du_ref[n]).norm() / du_ref[n].norm())
                   for n in du_ref)
        print(json.dumps({
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "plain": plain, "placed": placed, "upd": err / ref,
            "leaf": leaf,
            "n_sharded": len(sharded), "n_leaves": len(du)}))
    """, world=8)
    assert res["mesh"] == {"data": 2, "model": 4}
    assert res["n_sharded"] > res["n_leaves"] // 2, res
    for (loss, gn), (s_loss, s_gn) in zip(res["plain"], res["placed"]):
        assert abs(s_loss - loss) <= 1e-4 * loss, res
        assert abs(s_gn - gn) <= 2e-3 * gn, res
    assert res["upd"] <= 0.25 and res["leaf"] <= 0.6, res


_REF_PSUM = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.optim import compressed_psum
mesh = jax.make_mesh((8,), ("data",))
x = np.random.RandomState(0).randn(8, 64, 256).astype(np.float32)
def body(xs, errs):
    g, e = compressed_psum({"g": xs}, {"g": errs}, "data")
    return g["g"], e["g"]
f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data"))))
red, errs = f(x, jnp.zeros_like(x))
np.save(sys.argv[1], np.asarray(red)[0])
np.save(sys.argv[2], np.asarray(errs))
"""


def test_compressed_psum_error_feedback_matches_reference(tmp_path):
    """Int8 error-feedback compression on 8 ranks: the mean is recovered to
    within quantization error, the feedback drives the long-run average
    error down (the reference's bounds), and the first reduction equals
    the reference's on the same input."""
    red_path = str(tmp_path / "red.npy")
    err_path = str(tmp_path / "err.npy")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _REF_PSUM, red_path,
                          err_path], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = run_gloo(f"""
        from repro_torch.optim.compress import (compressed_psum,
                                                init_error_feedback)
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
        x = np.random.RandomState(0).randn(8, 64, 256).astype(np.float32)
        g = {{"g": torch.from_numpy(x[RANK])}}
        errs = init_error_feedback(g)
        red, errs = compressed_psum(g, errs, mesh["data"])
        true_mean = x.mean(0)
        err1 = float(np.abs(red["g"].numpy() - true_mean).max())
        ref_red = np.load({red_path!r})
        ref_err = np.load({err_path!r})[RANK]
        d_ref = float(np.abs(red["g"].numpy() - ref_red).max())
        d_err = float(np.abs(errs["g"].numpy() - ref_err).max())
        acc = np.zeros_like(true_mean)
        e = init_error_feedback(g)
        for _ in range(20):
            r, e = compressed_psum(g, e, mesh["data"])
            acc += r["g"].numpy()
        err_avg = float(np.abs(acc / 20 - true_mean).max())
        print(json.dumps({{"err1": err1, "err_avg": err_avg, "d_ref": d_ref,
                          "d_err": d_err}}))
    """, world=8)
    assert res["err1"] < 0.05, res          # single-shot quantization error
    assert res["err_avg"] < 0.02, res       # EF drives the average error down
    assert res["d_ref"] < 1e-6, res
    assert res["d_err"] < 1e-6, res


def test_gloo_harness_joins_the_groups_threads_before_exit():
    """A snippet that keeps a ``DeviceMesh`` of its groups (as the
    compressed_psum test does) leaves no gloo thread alive when its ranks
    reach interpreter teardown: each rank counts its threads at exit."""
    res = run_gloo("""
        import atexit
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
        t = torch.ones(4)
        dist.all_reduce(t, group=mesh["data"].get_group())
        live = len(os.listdir("/proc/self/task"))
        atexit.register(lambda live=live: print(json.dumps({
            "live": live, "at_exit": len(os.listdir("/proc/self/task"))})))
    """, world=8)
    assert res["live"] > 1, res         # gloo's threads, while in use
    assert res["at_exit"] == 1, res


def test_elastic_remesh_preserves_state():
    """Re-sharding reduced hymba's parameters from the mesh of 8 ranks onto
    the mesh of the first 4 (a device loss) keeps the values equal."""
    res = run_gloo("""
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh_for, mesh_axes
        from repro_torch.models import init_lm
        from repro_torch.sharding.rules import (logical_to_physical,
                                                param_sharding)
        cfg = get_config("hymba_1_5b", reduced=True)
        ref = {n: p.detach().clone() for n, p in init_lm(
            cfg, torch.Generator().manual_seed(0),
            device="cpu").named_parameters()}
        m = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
        mesh8 = make_mesh_for(8, model_parallel=4)
        logical_to_physical(mesh8, m, param_sharding(m, mesh8))
        n_sharded = sum(any(q.is_shard() for q in p.placements)
                        for p in m.parameters())
        host = {n: p.full_tensor() for n, p in m.named_parameters()}
        mesh4 = make_mesh_for(4, model_parallel=2)
        placed = {n: torch.nn.Parameter(v) for n, v in host.items()}
        shardings = param_sharding(placed, mesh4)
        from repro_torch.sharding.rules import place
        diff = 0.0
        if RANK < 4:
            p4 = {n: place(v, shardings[n]) for n, v in host.items()}
            back = {n: v.full_tensor() for n, v in p4.items()}
            diff = max(float((back[n] - ref[n]).abs().max()) for n in ref)
        print(json.dumps({"diff": diff, "n_sharded": n_sharded,
                          "mesh8": mesh_axes(mesh8),
                          "mesh4": mesh_axes(mesh4)}))
    """, world=8)
    assert res["diff"] == 0.0
    assert res["n_sharded"] > 0
    assert res["mesh8"] == {"data": 2, "model": 4}
    assert res["mesh4"] == {"data": 2, "model": 2}


def test_production_meshes_on_the_fake_backend():
    code = textwrap.dedent("""
        import json
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_production_mesh, mesh_axes
        out = {}
        for world, multi in ((256, False), (512, True)):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            mesh = make_production_mesh(multi_pod=multi)
            out[str(world)] = [mesh.device_type, mesh_axes(mesh)]
            dist.destroy_process_group()
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"256": ["cpu", {"data": 16, "model": 16}],
                   "512": ["cpu", {"pod": 2, "data": 16, "model": 16}]}


def test_kernel_wrappers_on_dtensors_equal_whole_tensor_calls():
    """RMSNorm, flash attention and WKV6 on a 2-rank mesh, for every
    placement a model gives them (rows or heads sharded, a sharded
    reduction dim that must be gathered, heads that do not split with the
    KV heads, replicated): the wrapper's result, gathered, equals the
    call on whole tensors; so do RMSNorm's gradients."""
    res = run_gloo("""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.rmsnorm.ops import rmsnorm
        from repro_torch.kernels.rwkv6.ops import wkv6
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("model",))
        g = torch.Generator().manual_seed(0)

        def rnd(*shape, dtype=torch.float32):
            return torch.randn(shape, generator=g).to(dtype)

        def put(t, pl):
            return distribute_tensor(t, mesh, [pl], src_data_rank=None)
        diffs = {}
        x, s = rnd(4, 6, 32, dtype=torch.bfloat16), rnd(32)
        want = rmsnorm(x, s)
        for pl in (Shard(0), Shard(1), Shard(2), Replicate()):
            got = rmsnorm(put(x, pl), put(s, Replicate()))
            diffs[f"rmsnorm {pl}"] = float(
                (got.full_tensor().float() - want.float()).abs().max())
        xf = rnd(4, 6, 32).requires_grad_()
        sf = rnd(32).requires_grad_()
        gy = rnd(4, 6, 32)
        (rmsnorm(xf, sf) * gy).sum().backward()
        xd = put(xf.detach(), Shard(0)).requires_grad_()
        sd = put(sf.detach(), Replicate()).requires_grad_()
        (rmsnorm(xd, sd) * put(gy, Shard(0))).sum().backward()
        diffs["rmsnorm dx"] = float(
            (xd.grad.full_tensor() - xf.grad).abs().max())
        diffs["rmsnorm dscale"] = float(
            (sd.grad.full_tensor() - sf.grad).abs().max())
        for hkv in (4, 1):
            q, k, v = rnd(2, 16, 4, 64), rnd(2, 16, hkv, 64), \\
                rnd(2, 16, hkv, 64)
            want = flash_attention(q, k, v, window=8)
            for pl in (Shard(0), Shard(2), Shard(1), Replicate()):
                got = flash_attention(put(q, pl), put(k, pl), put(v, pl),
                                      window=8)
                diffs[f"flash hkv={hkv} {pl}"] = float(
                    (got.full_tensor() - want).abs().max())
        r, k, v = rnd(2, 12, 4, 16), rnd(2, 12, 4, 16), rnd(2, 12, 4, 16)
        w = torch.rand((2, 12, 4, 16), generator=g) * 0.5 + 0.4
        u, s0 = rnd(4, 16), rnd(2, 4, 16, 16)
        y_want, s_want = wkv6(r, k, v, w, u, s0)
        for pl in (Shard(0), Shard(2), Shard(3), Replicate()):
            y, sT = wkv6(put(r, pl), put(k, pl), put(v, pl), put(w, pl),
                         put(u, Replicate()), put(s0, Replicate()))
            diffs[f"wkv6 {pl}"] = max(
                float((y.full_tensor() - y_want).abs().max()),
                float((sT.full_tensor() - s_want).abs().max()))
        print(json.dumps(diffs))
    """, world=2)
    assert len(res) == 18, res
    bad = {k: d for k, d in res.items() if d > 1e-6}
    assert not bad, bad


def test_wkv6_gradients_on_dtensors_equal_whole_tensor_gradients():
    """``WKV6Fn`` through ``local_map`` on a 2-rank mesh with the batch,
    the heads, time (gathered first) or nothing sharded, and a cotangent
    on both outputs: every input's gradient, gathered, equals the
    gradient of the call on whole tensors (u's a partial sum over batch
    shards, s0's sharded with the batch and the heads), to 1e-5 of its
    scale (the same float32 sums, the batch's du in two parts)."""
    res = run_gloo("""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.kernels.rwkv6.ops import wkv6
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("model",))
        g = torch.Generator().manual_seed(1)

        def rnd(*shape):
            return torch.randn(shape, generator=g)

        def put(t, pl):
            return distribute_tensor(t, mesh, [pl], src_data_rank=None)
        r, k, v = rnd(2, 20, 4, 16), rnd(2, 20, 4, 16), rnd(2, 20, 4, 16)
        w = torch.rand((2, 20, 4, 16), generator=g) * 0.5 + 0.4
        u, s0 = rnd(4, 16), rnd(2, 4, 16, 16) * 0.1
        gy, gs = rnd(2, 20, 64), rnd(2, 4, 16, 16) * 0.1
        whole = [t.clone().requires_grad_(True) for t in (r, k, v, w, u,
                                                          s0)]
        y, sT = wkv6(*whole)
        ((y * gy).sum() + (sT * gs).sum()).backward()
        diffs = {}
        # (r, k, v, w's placement, u's, s0's): u and s0 follow the heads,
        # s0 the batch too
        for pl, u_pl, s_pl in ((Shard(0), Replicate(), Shard(0)),
                               (Shard(2), Shard(0), Shard(1)),
                               (Shard(1), Replicate(), Replicate()),
                               (Replicate(), Replicate(), Replicate())):
            ins = [put(t, pl) for t in (r, k, v, w)] + [put(u, u_pl),
                                                        put(s0, s_pl)]
            ins = [t.detach().requires_grad_(True) for t in ins]
            y, sT = wkv6(*ins)
            ((y * put(gy, Replicate())).sum()
             + (sT * put(gs, Replicate())).sum()).backward()
            for name, got, want in zip("rkvwus", ins, whole):
                err = (got.grad.full_tensor() - want.grad).abs().max()
                diffs[f"d{name} {pl}"] = float(
                    err / want.grad.abs().max())
        print(json.dumps(diffs))
    """, world=2)
    assert len(res) == 24, res
    bad = {k: d for k, d in res.items() if d > 1e-5}
    assert not bad, bad


def test_norm_shift_mix_on_dtensors_equals_whole_tensor_calls():
    """rwkv6's LayerNorm, token shift and mixes (``norm_shift_mix``) on a
    2-rank mesh with the batch, the sequence or d sharded (the last two
    gathered first: the shift crosses sequence shards, the statistics need
    whole rows) or nothing: the mixed inputs and the new shift, gathered,
    equal the call on whole tensors bit for bit; under autograd (the plain
    version, as training runs it) every input's gradient, gathered,
    equals the whole call's to 1e-6 of its scale (the batch's parameter
    gradients in two parts)."""
    res = run_gloo("""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.kernels.norm_shift_mix.ops import norm_shift_mix
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("model",))
        g = torch.Generator().manual_seed(2)
        B, S, d, K = 4, 6, 32, 5

        def put(t, pl):
            return distribute_tensor(t, mesh, [pl], src_data_rank=None)
        x = torch.randn((B, S, d), generator=g)
        shift = torch.randn((B, d), generator=g)
        scale, bias = torch.randn(d, generator=g), torch.randn(d, generator=g)
        mixes = [torch.rand(d, generator=g) for _ in range(K)]
        gys = [torch.randn((B, S, d), generator=g) for _ in range(K)]
        diffs = {}
        outs, last = norm_shift_mix(x.bfloat16(), shift, scale, bias, mixes)
        for pl, s_pl in ((Shard(0), Shard(0)), (Shard(1), Replicate()),
                         (Shard(2), Shard(1)), (Replicate(), Replicate())):
            got, got_last = norm_shift_mix(
                put(x.bfloat16(), pl), put(shift, s_pl),
                put(scale, Replicate()), put(bias, Replicate()),
                [put(m, Replicate()) for m in mixes])
            diffs[f"outs {pl}"] = max(
                float((o.full_tensor().float() - w.float()).abs().max())
                for o, w in zip(got, outs))
            diffs[f"shift {pl}"] = float(
                (got_last.full_tensor() - last).abs().max())
        whole = [t.clone().requires_grad_(True)
                 for t in (x, shift, scale, bias, *mixes)]
        o, _ = norm_shift_mix(*whole[:4], whole[4:])
        sum((a * gy).sum() for a, gy in zip(o, gys)).backward()
        for pl, s_pl in ((Shard(0), Shard(0)), (Shard(1), Replicate())):
            ins = [put(x, pl), put(shift, s_pl)] + [
                put(t, Replicate()) for t in (scale, bias, *mixes)]
            ins = [t.detach().requires_grad_(True) for t in ins]
            o, _ = norm_shift_mix(*ins[:4], ins[4:])
            sum((a * put(gy, pl)).sum() for a, gy in zip(o, gys)).backward()
            for i, (got, want) in enumerate(zip(ins, whole)):
                err = (got.grad.full_tensor() - want.grad).abs().max()
                diffs[f"d{i} {pl}"] = float(err / want.grad.abs().max())
        print(json.dumps(diffs))
    """, world=2)
    assert len(res) == 8 + 2 * 9, res
    bad = {k: d for k, d in res.items()
           if d > (1e-6 if k.startswith("d") else 0)}
    assert not bad, bad



@pytest.mark.parametrize("arch", ["qwen3_32b", "qwen2_moe_a2_7b"])
def test_sequence_sharded_train_step_matches_the_plain_step(arch):
    """The dry run's default for training, Megatron-style sequence
    parallelism (``seq_shard=True``), on a (2, 4) mesh against the plain
    step: the loss to 1e-4 of its value and ``grad_norm`` to 2e-3 (C10's
    tolerances).  Every norm's output is gathered along the sequence
    before its products and every block output reduced into the stream's
    layout, so no product views a sequence-sharded (B, S) as one axis;
    the MoE router runs on each rank's tokens.  Remat's recompute, which
    autograd runs on the card's device thread, re-enters the sharding
    rules (``recompute_context``): here on another thread too."""
    res = run_gloo(f"""
        import threading
        from repro_torch.configs import get_config
        from repro_torch.data.pipeline import batch_specs
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.models import init_lm
        from repro_torch.optim import AdamW
        from repro_torch.runtime.steps import TrainState, make_train_step
        from repro_torch.sharding import context
        from repro_torch.sharding.rules import (NamedSharding, batch_spec,
                                                logical_to_physical,
                                                param_sharding, place)
        cfg = get_config("{arch}", reduced=True)
        mesh = make_mesh_for(WORLD, model_parallel=4)
        rng = np.random.RandomState(0)
        batch = {{k: torch.from_numpy(rng.randint(0, cfg.vocab, shape)
                                      .astype(np.int32))
                  for k, (shape, _) in batch_specs(cfg, 32, 4, 2).items()}}
        bs = batch_spec(mesh)
        out = []
        for sharded in (False, True):
            m = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
            if sharded:
                logical_to_physical(mesh, m, param_sharding(m, mesh))
            opt = AdamW(lr=1e-3)
            st = TrainState(m, opt.init(m))
            step = make_train_step(cfg, opt, seq_shard=sharded)
            if sharded:
                b = {{k: place(v, NamedSharding(mesh, (None,) + bs[k]))
                      for k, v in batch.items()}}
                with context.sharding_rules(mesh):
                    st, met = step(st, b)
                    _, recompute = context.recompute_context()
            else:
                st, met = step(st, batch)
            out.append([float(met["loss"]), float(met["grad_norm"])])
        seen = []

        def other_thread():
            with recompute:
                seen.append(context._mesh() is mesh)
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
        print(json.dumps({{"plain": out[0], "seq": out[1],
                          "thread": seen}}))
    """, world=8)
    (l0, g0), (l1, g1) = res["plain"], res["seq"]
    assert abs(l1 - l0) <= 1e-4 * abs(l0), res
    assert abs(g1 - g0) <= 2e-3 * abs(g0), res
    assert res["thread"] == [True], res


def test_q8_step_on_a_mesh_matches_the_plain_q8_step():
    """A reduced qwen3 train step with q8 moments on a (2, 4) mesh against
    the same step on plain tensors.  Only the first update is held (q8
    training diverges within a few steps, ROADMAP.md C7), at the
    tensor-parallel tolerances of the f32 sharded step (C10): the loss to
    1e-4 of its value, the update to 0.25 of its norm as a whole and 0.6
    leaf by leaf, and the moments after the step, dequantized, to the
    same 0.25 of their norm."""
    res = run_gloo("""
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.models import init_lm
        from repro_torch.models.convert import whole
        from repro_torch.optim import AdamW, Q8State, dequantize_q8
        from repro_torch.runtime.steps import TrainState, make_train_step
        from repro_torch.sharding.context import sharding_rules
        from repro_torch.sharding.rules import (NamedSharding, batch_spec,
                                                logical_to_physical,
                                                param_sharding, place)
        cfg = get_config("qwen3_32b", reduced=True)
        mesh = make_mesh_for(WORLD, model_parallel=4)
        rng = np.random.RandomState(0)
        batch0 = {k: torch.from_numpy(rng.randint(
            0, cfg.vocab, (2, 4, 32)).astype(np.int32))
            for k in ("tokens", "labels")}
        bs = batch_spec(mesh)

        def train(sharded):
            m = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
            p0 = {n: p.detach().clone() for n, p in m.named_parameters()}
            if sharded:
                logical_to_physical(mesh, m, param_sharding(m, mesh))
            opt = AdamW(lr=1e-3, quantized=True)
            st = TrainState(m, opt.init(m))
            step = make_train_step(cfg, opt)
            if sharded:
                batch = {k: place(v, NamedSharding(mesh, (None,) + bs[k]))
                         for k, v in batch0.items()}
                with sharding_rules(mesh):
                    st, met = step(st, batch)
            else:
                st, met = step(st, batch0)
            du = {n: whole(p.detach()) - p0[n]
                  for n, p in m.named_parameters()}
            mom = {n: dequantize_q8(whole(q.codes), whole(q.scales),
                                    p0[n].shape)
                   for n, q in st.opt.m.items() if isinstance(q, Q8State)}
            placed = sum(isinstance(q, Q8State) and
                         hasattr(q.codes, "device_mesh")
                         for q in st.opt.m.values())
            return float(met["loss"]), du, mom, placed
        loss0, du0, mom0, _ = train(False)
        loss1, du1, mom1, placed = train(True)

        def rel(a, b, names):
            return (sum(float((a[n] - b[n]).square().sum()) for n in names)
                    / sum(float(b[n].square().sum()) for n in names)) ** 0.5
        print(json.dumps({
            "loss": [loss0, loss1], "update": rel(du1, du0, du0),
            "leaf": max(rel(du1, du0, [n]) for n in du0
                        if float(du0[n].abs().max()) > 0),
            "moments": rel(mom1, mom0, mom0), "n_q8": len(mom0),
            "placed": placed}))
    """, world=8)
    assert res["n_q8"] > 0 and res["placed"] == res["n_q8"], res
    assert abs(res["loss"][1] - res["loss"][0]) <= 1e-4 * abs(res["loss"][0])
    assert res["update"] < 0.25, res
    assert res["leaf"] < 0.6, res
    assert res["moments"] < 0.25, res


def test_q8_moments_on_a_mesh_are_laid_out_by_opt_leaf_sharding():
    """On a (2, 4) mesh the q8 codes and scales of every leaf are
    ``DTensor``s placed as ``launch.specs.opt_leaf_sharding`` says, and as
    ``state_sharding`` returns: rows over ``data``, blocks over ``model``
    where the block count divides (a (16, 1024) leaf's 8 blocks), blocks
    that pad the last axis (1000 into 8 blocks of 128), and an output
    projection whose 3 blocks do not divide ``data``'s 2 (rows over
    ``model``, blocks whole).  Two AdamW
    updates on the mesh equal the same updates on plain tensors, the
    parameters to 1e-6 and the codes to one step (the clip's norm is a
    sum in another order, so a value at a rounding boundary may round the
    other way)."""
    res = run_gloo("""
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.launch.specs import opt_leaf_sharding
        from repro_torch.models.convert import whole
        from repro_torch.optim import AdamW, Q8State
        from repro_torch.sharding.rules import (NamedSharding,
                                                param_sharding, place,
                                                state_sharding)
        mesh = make_mesh_for(WORLD, model_parallel=4)
        g = torch.Generator().manual_seed(3)
        shapes = {"wq": (16, 1024), "wv": (8, 1000), "wo": (12, 384)}
        plain = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
        grads = [{n: torch.randn(s, generator=g) for n, s in shapes.items()}
                 for _ in range(2)]
        p_sh = param_sharding(plain, mesh)
        placed = {n: place(t.clone(), p_sh[n]) for n, t in plain.items()}
        opt = AdamW(lr=1e-2, quantized=True, warmup=1)
        st0, st1 = opt.init(plain), opt.init(placed)
        one = opt_leaf_sharding(mesh, None)
        laid, ladder = True, {}
        for n in shapes:
            want = one(st0.m[n], p_sh[n])
            got = st1.m[n]
            laid &= (got.codes.placements == want.codes.placements
                     and got.scales.placements == want.scales.placements)
            ladder[n] = [want.codes.spec, want.scales.spec]
        sh = state_sharding(st1, p_sh)
        laid &= all(sh["m"][n] == one(st0.m[n], p_sh[n]) for n in shapes)
        for gr in grads:
            opt.update(gr, st0, plain)
            opt.update({n: place(t, p_sh[n]) for n, t in gr.items()}, st1,
                       placed)
        laid &= all(isinstance(st1.v[n], Q8State) and
                    st1.v[n].codes.placements == one(
                        st0.v[n], p_sh[n]).codes.placements for n in shapes)
        print(json.dumps({
            "laid": bool(laid), "ladder": ladder,
            "param": max(float((whole(placed[n]) - plain[n]).abs().max())
                         for n in shapes),
            "codes": max(int((whole(s1[n].codes).int()
                              - s0[n].codes.int()).abs().max())
                         for s0, s1 in ((st0.m, st1.m), (st0.v, st1.v))
                         for n in shapes)}))
    """, world=8)
    assert res["laid"], res
    assert res["ladder"] == {"wq": [["data", "model", None],
                                    ["data", "model"]],
                             "wv": [["data", "model", None],
                                    ["data", "model"]],
                             "wo": [["model", None, None], ["model", None]]}
    assert res["param"] <= 1e-6, res
    assert res["codes"] <= 1, res


def test_submesh_pool_needs_a_card_or_host_devices(monkeypatch):
    import torch
    from repro_torch.runtime.spacesharing import SubmeshPool
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SubmeshPool()
    pool = SubmeshPool(devices=["cpu"] * 4, n_lanes=2)
    assert len(pool) == 2 and pool.device(1) == torch.device("cpu")
    assert len(SubmeshPool(devices=["cpu"], n_lanes=2)) == 1


def test_submesh_pool_splits_a_device_mesh():
    """Where a process group spans the devices, a lane is a sub-mesh: a
    4-rank mesh splits into two (2, 1) ``("data", "model")`` lanes over
    ranks 0-1 and 2-3."""
    res = run_gloo("""
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.runtime.spacesharing import SubmeshPool
        pool = SubmeshPool(init_device_mesh("cpu", (WORLD,)), n_lanes=2)
        print(json.dumps([[lane.mesh.tolist(), list(lane.mesh_dim_names)]
                          for lane in pool.lanes]
                         + [str(pool.device(RANK))]))
    """, world=4)
    assert res == [[[[0], [1]], ["data", "model"]],
                   [[[2], [3]], ["data", "model"]], "cpu"]


def test_sharded_train_state_checkpoints_as_the_plain_one(tmp_path):
    """A train state placed on a (2, 2) mesh saves the same files as the
    plain state (every leaf gathered whole; every rank takes part and
    rank 0 alone writes, into one directory), and every rank restores
    from that directory into a placed state with each leaf back in its
    own placements and values."""
    res = run_gloo(f"""
        import os
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.models import init_lm
        from repro_torch.optim import AdamW
        from repro_torch.runtime.steps import TrainState
        from repro_torch.sharding.rules import (logical_to_physical,
                                                param_sharding)
        cfg = get_config("qwen3_32b", reduced=True)
        opt = AdamW()

        def state(placed, seed):
            m = init_lm(cfg, torch.Generator().manual_seed(seed),
                        device="cpu")
            if placed:
                logical_to_physical(mesh, m, param_sharding(m, mesh))
            return TrainState(m, opt.init(m))
        mesh = make_mesh_for(WORLD, 2)
        root = {str(tmp_path)!r}
        plain_dir = os.path.join(root, "plain")
        placed_dir = os.path.join(root, "placed")
        CheckpointManager(plain_dir, async_save=False,
                          writer=RANK == 0).save(3, state(False, 0))
        CheckpointManager(placed_dir, async_save=False,
                          writer=RANK == 0).save(3, state(True, 0))
        dist.barrier()
        same = all(
            np.array_equal(np.load(os.path.join(plain_dir, "step_3", f)),
                           np.load(os.path.join(placed_dir, "step_3", f)))
            for f in os.listdir(os.path.join(plain_dir, "step_3"))
            if f.endswith(".npy"))
        like = state(True, 1)
        before = {{n: p.placements for n, p in like.params.named_parameters()}}
        CheckpointManager(placed_dir).restore(like, step=3)
        ref = dict(state(False, 0).params.named_parameters())
        diff = max(float((p.full_tensor() - ref[n]).abs().max())
                   for n, p in like.params.named_parameters())
        kept = all(p.placements == before[n]
                   for n, p in like.params.named_parameters())
        print(json.dumps({{"same_files": same, "diff": diff, "kept": kept,
                          "dirs": sorted(os.listdir(root)),
                          "steps": os.listdir(placed_dir),
                          "files": len(os.listdir(os.path.join(
                              placed_dir, "step_3")))}}))
    """, world=4)
    assert res["same_files"] and res["files"] > 10, res
    assert res["dirs"] == ["placed", "plain"], res
    assert res["steps"] == ["step_3"], res
    assert res["diff"] == 0.0 and res["kept"], res


def test_train_launcher_under_torchrun_prints_the_one_rank_lines(tmp_path):
    """``torchrun --nproc-per-node 2`` runs the train launcher on a (1, 2)
    mesh of gloo ranks: rank 0 prints, and its ``step N:`` lines equal a
    world of one rank's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.train", "--reduced", "--device",
            "cpu", "--steps", "5"]

    def steps(cmd):
        res = subprocess.run(cmd + args, env=env, capture_output=True,
                             text=True, timeout=300, cwd=str(tmp_path))
        assert res.returncode == 0, res.stdout + res.stderr[-3000:]
        return [ln for ln in res.stdout.splitlines()
                if ln.startswith(("step ", "device:"))]
    two = steps([sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "2"])
    one = steps([sys.executable])
    assert two[0].startswith("device: cpu | mesh: {'data': 1, 'model': 2}")
    assert one[0].startswith("device: cpu | mesh: {'data': 1, 'model': 1}")
    assert two[1:] == one[1:] and one[1].startswith("step 5: loss=")


def test_train_launcher_under_torchrun_resumes_from_one_checkpoint(tmp_path):
    """Under ``torchrun --nproc-per-node 2`` rank 0 alone writes each
    checkpoint, into ``--ckpt`` itself, and both ranks resume from it: a
    run of 3 steps then one of 5 prints the uninterrupted run's
    ``step 5:`` line."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    ckpt = str(tmp_path / "ck")

    def run(steps, *extra):
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
             "--reduced", "--device", "cpu", "--steps", str(steps), *extra],
            env=env, capture_output=True, text=True, timeout=300,
            cwd=str(tmp_path))
        assert res.returncode == 0, res.stdout + res.stderr[-3000:]
        return res.stdout.splitlines()
    whole = run(5)
    run(3, "--ckpt", ckpt, "--ckpt-every", "2")
    assert sorted(os.listdir(ckpt)) == ["step_2"]
    resumed = run(5, "--ckpt", ckpt, "--ckpt-every", "2")
    assert "resumed from step 2" in resumed, resumed
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_4"]
    step5 = [ln for ln in whole if ln.startswith("step 5:")]
    assert step5 and step5 == [ln for ln in resumed
                               if ln.startswith("step 5:")], (whole, resumed)
