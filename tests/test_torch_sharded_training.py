"""Training on meshes of two gloo ranks: three ``make_train_step``s of
every config of ``ARCH_IDS`` with its parameters and batch placed as
``DTensor``s, against the same steps on plain tensors; and the blocked
attention of long sequences on each rank's shard."""
import pytest

from _torch_gloo import run_gloo


# The sharded step against the plain one.  ``loss1`` bounds the first
# step's loss (a forward before any update): a data-parallel mesh splits
# only the batch, and a tensor-parallel one also rounds each rank's partial
# sums of a row-parallel product to bf16 before their sum, as the
# reference's GSPMD does (its own bound for its sharded step is 1e-3).
# Later losses follow updates made from those gradients.  ``upd`` bounds
# the parameters' update after three steps, ||du - du_ref|| / ||du_ref||
# over all leaves, and ``leaf`` the same ratio for each leaf: AdamW moves
# an element by at most about lr whatever its gradient, so a gradient that
# is wrong moves these toward 1 or more, and a gradient off by a constant
# factor shows in ``grad_norm``.  On (1, 2) the MoE configs come nearest
# (0.13 and 0.38: their routing follows the rounding).
_BOUNDS = {1: {"loss1": 1e-5, "upd": 0.05, "leaf": 0.1},
           2: {"loss1": 1e-4, "upd": 0.25, "leaf": 0.6}}


@pytest.mark.parametrize("model_parallel", [2, 1])
def test_every_arch_trains_on_a_two_rank_mesh(model_parallel):
    """On a (1, 2) mesh (tensor-parallel) and a (2, 1) mesh (data-parallel),
    three steps of every config against the same steps on plain tensors:
    each step's loss and ``grad_norm``, and every parameter leaf's
    update."""
    res = run_gloo(f"""
        from repro_torch.configs import ARCH_IDS, get_config
        from repro_torch.data import SyntheticTokenStream
        from repro_torch.launch.mesh import make_mesh_for, mesh_axes
        from repro_torch.models import init_lm
        from repro_torch.models.convert import whole
        from repro_torch.optim import AdamW
        from repro_torch.runtime.steps import TrainState, make_train_step
        from repro_torch.sharding.context import sharding_rules
        from repro_torch.sharding.rules import (NamedSharding, batch_spec,
                                                logical_to_physical,
                                                param_sharding, place)
        mesh = make_mesh_for(WORLD, {model_parallel})
        bs = batch_spec(mesh)
        out = {{"mesh": mesh_axes(mesh)}}

        def train(cfg, batches, sharded):
            m = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
            p0 = {{n: p.detach().clone() for n, p in m.named_parameters()}}
            if sharded:
                logical_to_physical(mesh, m, param_sharding(m, mesh))
            opt = AdamW(lr=1e-3)
            step = make_train_step(cfg, opt)
            st, mets = TrainState(m, opt.init(m)), []
            for batch in batches:
                if sharded:
                    batch = {{k: place(v, NamedSharding(mesh,
                                                        (None,) + bs[k]))
                             for k, v in batch.items()}}
                    with sharding_rules(mesh):
                        st, met = step(st, batch)
                else:
                    st, met = step(st, batch)
                mets.append([float(met["loss"]), float(met["grad_norm"])])
            return mets, {{n: whole(p.detach()) - p0[n]
                          for n, p in m.named_parameters()}}
        for arch in ARCH_IDS:
            cfg = get_config(arch, reduced=True)
            stream = SyntheticTokenStream(cfg, 32, 4, accum=1)
            batches = [{{k: torch.from_numpy(v)
                        for k, v in stream.batch(i).items()}}
                       for i in range(3)]
            plain, du_ref = train(cfg, batches, False)
            placed, du = train(cfg, batches, True)
            err = sum(float((du[n] - du_ref[n]).square().sum())
                      for n in du_ref) ** 0.5
            ref = sum(float(d.square().sum()) for d in du_ref.values()) ** 0.5
            leaf = max(float((du[n] - du_ref[n]).norm() / du_ref[n].norm())
                       for n in du_ref)
            out[arch] = {{"plain": plain, "placed": placed,
                         "upd": err / ref, "leaf": leaf,
                         "n_leaves": len(du)}}
        print(json.dumps(out))
    """, world=2, timeout=400)
    assert res.pop("mesh") == {"data": 2 // model_parallel,
                               "model": model_parallel}
    assert len(res) == 10
    bound = _BOUNDS[model_parallel]
    for arch, r in res.items():
        (l1, _), (s1, _) = r["plain"][0], r["placed"][0]
        assert abs(s1 - l1) <= bound["loss1"] * l1, (arch, r)
        for (loss, gn), (s_loss, s_gn) in zip(r["plain"], r["placed"]):
            assert abs(s_loss - loss) <= 1e-4 * loss, (arch, r)
            assert abs(s_gn - gn) <= 2e-3 * gn, (arch, r)
        assert r["upd"] <= bound["upd"], (arch, r)
        assert r["leaf"] <= bound["leaf"], (arch, r)


def test_blocked_attention_runs_on_shards():
    """``_sdpa_chunked`` (the blocked attention of sequences of 2048 tokens
    and more) on ``DTensor``s with the heads or the batch sharded, forward
    and gradients, against the call on whole tensors."""
    res = run_gloo("""
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.models import attention as A
        from repro_torch.sharding.context import sharding_rules
        cfg = get_config("qwen3_32b", reduced=True)
        mesh = make_mesh_for(WORLD, 2)
        g = torch.Generator().manual_seed(0)
        qkv = [torch.randn(shape, generator=g) for shape in
               ((2, 256, 4, 16), (2, 256, 2, 16), (2, 256, 2, 16))]
        dout = torch.randn((2, 256, 64), generator=g)
        leaves = [t.clone().requires_grad_() for t in qkv]
        want = A._sdpa_chunked(cfg, *leaves, window=64, q_chunk=64,
                               kv_chunk=128)
        want.backward(dout)
        diffs = {}
        for pl in ([Replicate(), Shard(2)], [Shard(0), Replicate()]):
            d = [distribute_tensor(t, mesh, pl, src_data_rank=None
                                   ).requires_grad_() for t in qkv]
            with sharding_rules(mesh):
                got = A._sdpa_chunked(cfg, *d, window=64, q_chunk=64,
                                      kv_chunk=128)
                got.backward(distribute_tensor(
                    dout, mesh, got.placements, src_data_rank=None))
            diffs[str(pl)] = max(
                [float((got.full_tensor() - want).abs().max())]
                + [float((t.grad.full_tensor() - w.grad).abs().max())
                   for t, w in zip(d, leaves)])
        print(json.dumps(diffs))
    """, world=2)
    assert len(res) == 2
    assert all(d < 1e-6 for d in res.values()), res
