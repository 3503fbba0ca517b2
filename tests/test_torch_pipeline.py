"""The port's GPipe pipeline (``repro_torch.runtime.pipeline``) on gloo
ranks against the sequential version, forward and backward: the cases of
``tests/test_pipeline.py``."""
import textwrap

from _torch_gloo import run_gloo

_COMMON = """
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.runtime.pipeline import pipeline_apply, pipeline_loss_fn

def stage_fn(w_stage, x):
    for i in range(w_stage.shape[0]):
        x = torch.tanh(x @ w_stage[i])
    return x

def sequential(ws, xs):
    out = xs
    for s in range(ws.shape[0]):
        out = stage_fn(ws[s], out)
    return out
"""


def test_pipeline_forward_matches_sequential():
    res = run_gloo(_COMMON + textwrap.dedent("""
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("pod", "data"))
        S, L_per, d = 4, 2, 16          # 4 stages x 2 layers
        rng = np.random.RandomState(0)
        ws = torch.from_numpy(rng.randn(S, L_per, d, d).astype(np.float32)
                              * 0.3)
        n_micro, mb = 6, 8
        xs = torch.from_numpy(rng.randn(n_micro, mb, d).astype(np.float32))
        wd = distribute_tensor(ws, mesh, [Shard(0), Replicate()],
                               src_data_rank=None)
        got = pipeline_apply(stage_fn, mesh, axis="pod")(wd, xs)
        err = float((got - sequential(ws, xs)).abs().max())
        print(json.dumps({"err": err, "shape": list(got.shape)}))
    """), world=8)
    assert res["shape"] == [6, 8, 16]
    assert res["err"] < 1e-5, res


def test_pipeline_backward_matches_sequential():
    res = run_gloo(_COMMON + textwrap.dedent("""
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
        S, L_per, d = 2, 2, 8
        rng = np.random.RandomState(1)
        ws = torch.from_numpy(rng.randn(S, L_per, d, d).astype(np.float32)
                              * 0.3)
        xs = torch.from_numpy(rng.randn(4, 4, d).astype(np.float32))
        ys = torch.from_numpy(rng.randn(4, 4, d).astype(np.float32))

        def loss_tail(outs, ys):
            return torch.mean((outs - ys) ** 2)
        wd = distribute_tensor(ws, mesh, [Shard(0), Replicate()],
                               src_data_rank=None).requires_grad_()
        loss = pipeline_loss_fn(stage_fn, loss_tail, mesh, axis="pod")
        value = loss(wd, xs, ys)
        value.backward()
        g_pipe = wd.grad.full_tensor()
        wr = ws.clone().requires_grad_()
        ref = loss_tail(sequential(wr, xs), ys)
        ref.backward()
        err = float((g_pipe - wr.grad).abs().max())
        print(json.dumps({"err": err, "loss_err": abs(float(value - ref)),
                          "grad_norm": float(wr.grad.norm())}))
    """), world=8)
    assert res["grad_norm"] > 0
    assert res["loss_err"] < 1e-5, res
    assert res["err"] < 1e-5, res
