"""Serving on meshes of two gloo ranks: every config of ``ARCH_IDS``
through ``launch.serve.generate`` with its model, caches and batch placed
as ``DTensor``s, against the same call on plain tensors."""
import pytest

from _torch_gloo import run_gloo


@pytest.mark.parametrize("model_parallel", [2, 1])
def test_every_arch_serves_on_a_two_rank_mesh(model_parallel):
    """``launch.serve.generate`` on a (1, 2) mesh (tensor-parallel) and a
    (2, 1) mesh (data-parallel) for every config, row by row against the
    call on plain tensors: while a row's tokens agree, its logits agree
    within the bf16 tolerance of the launcher's bf16 weights, and its
    greedy token is the same unless the plain logits' top two are closer
    than twice that row's difference (a near-tie, which a row-parallel
    product's bf16 partial sums may break either way, as the reference's
    GSPMD rounds them).  A row that took the other token is not compared
    after it: its inputs differ.  Three in four rows are compared to the
    end.  An MoE config is held to 0.1 of the scale: a prompt token whose
    router scores are that close may go to another expert (4.4e-2 for
    qwen2-moe on (1, 2) with torch 2.11), where a sharding fault moves
    the logits by the scale itself."""
    res = run_gloo(f"""
        from repro_torch.configs import ARCH_IDS, get_config
        from repro_torch.launch.mesh import make_mesh_for, mesh_axes
        from repro_torch.launch.serve import generate
        mesh = make_mesh_for(WORLD, {model_parallel})
        out = {{"mesh": mesh_axes(mesh)}}
        for arch in ARCH_IDS:
            cfg = get_config(arch, reduced=True)
            plain = generate(cfg, new_tokens=4, device="cpu")
            placed = generate(cfg, new_tokens=4, device="cpu", mesh=mesh)
            scale = max(float(a.abs().max()) for a in plain["logits"])
            worst, forced, whole_rows = 0.0, 0, 0
            for r in range(plain["tokens"].shape[0]):
                for i, (a, b) in enumerate(zip(plain["logits"],
                                               placed["logits"])):
                    d = float((a[r] - b[r]).abs().max())
                    worst = max(worst, d / scale)
                    if plain["tokens"][r, i] != placed["tokens"][r, i]:
                        top = a[r].topk(2).values
                        forced += float(top[0] - top[1]) > 2 * d
                        break
                else:
                    whole_rows += 1
            out[arch] = {{"worst": worst, "forced": forced,
                         "moe": cfg.moe is not None,
                         "whole_rows": whole_rows,
                         "rows": int(plain["tokens"].shape[0])}}
        print(json.dumps(out))
    """, world=2, timeout=400)
    assert res.pop("mesh") == {"data": 2 // model_parallel,
                               "model": model_parallel}
    assert len(res) == 10
    for arch, r in res.items():
        bound = 0.1 if r["moe"] else 2e-2
        assert r["worst"] <= bound and r["forced"] == 0, (arch, r)
    rows = sum(r["rows"] for r in res.values())
    assert sum(r["whole_rows"] for r in res.values()) >= 0.75 * rows, res
