"""The port's dry run (``repro_torch.launch.{specs,dryrun,hlostats}``)
against the reference's (``repro.launch``), and its counter against the
port's own steps.

* pure functions against the reference: ``plan_accum`` and
  ``make_optimizer``'s q8 choice for every arch, shape and production mesh;
  ``opt_leaf_sharding``'s specs for every q8 leaf of ``nemotron_4_340b`` on
  shape-only meshes (the reference's on ``jax.sharding.AbstractMesh``);
  ``_wire_bytes`` for every kind and group size;
* the counter on the fake backend (a subprocess each, as
  ``test_torch_distributed.py`` runs the production meshes): each rank's
  local work, a repeated count, a toy cell on (2, 4), the useful share of
  a dense train cell, the CLI's JSON;
* each kernel's operator on fake CUDA tensors: the kernel's output shapes
  and types, one launch counted by its formula, nothing launched.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import hlostats
from repro_torch.launch.specs import (make_optimizer, opt_leaf_sharding,
                                      plan_accum)
from repro_torch.models import LM
from repro_torch.models.config import SHAPES
from repro_torch.models.convert import reference_path
from repro_torch.optim import AdamW, Q8State
from repro_torch.sharding.rules import param_sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _fake_world(code: str, world: int, timeout: float = 600) -> dict:
    """Runs ``code`` in a subprocess on rank 0 of a fake world of
    ``world`` ranks (``WORLD`` in the snippet); its last line of output is
    parsed as JSON."""
    prog = textwrap.dedent("""\
        import json, os, sys
        import numpy as np
        import torch
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        torch.set_num_threads(1)
        WORLD = {world}
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=WORLD)
        """).format(world=world) + textwrap.dedent(code) + \
        "\ndist.destroy_process_group()\n"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


# ----------------------------------------------------------------------
# pure functions against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_accum_and_q8_choice_match_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.launch.specs import make_optimizer as ref_make_optimizer
    from repro.launch.specs import plan_accum as ref_plan_accum
    assert make_optimizer(get_config(arch)).quantized == \
        ref_make_optimizer(ref_config(arch)).quantized
    for shape, names in MESHES.values():
        axes = dict(zip(names, shape))
        ref_mesh = types.SimpleNamespace(shape=axes)
        for cell in SHAPES.values():
            assert plan_accum(cell, axes) == ref_plan_accum(cell, ref_mesh), \
                (arch, cell.name, axes)


def _ref_q8_shardings(tree):
    """{"/"-joined reference path: (codes spec, scales spec)} of a tree of
    ``Q8State`` shardings."""
    from repro.optim import Q8State as RefQ8State
    out = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, RefQ8State)):
        if isinstance(sh, RefQ8State):
            keys = [str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path]
            out["/".join(keys)] = (tuple(sh.codes.spec),
                                   tuple(sh.scales.spec))
    return out


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def test_opt_leaf_sharding_of_nemotron_q8_leaves_matches_reference():
    """Every q8 moment of ``nemotron_4_340b`` (the configs over 200e9
    parameters train with q8 moments): the codes' and scales' specs on
    (16, 16) and (2, 16, 16) equal the reference's, a stacked leaf's
    without its leading layer axis; the embedding's 144 blocks against pod
    x data = 32 take ``data`` down the ladder."""
    from repro.configs import get_config as ref_config
    from repro.launch.specs import make_optimizer as ref_make_optimizer
    from repro.launch.specs import state_shapes as ref_state_shapes
    from repro.launch.specs import train_state_sharding as ref_tss
    cfg = get_config("nemotron_4_340b")
    rcfg = ref_config("nemotron_4_340b")
    ref_st = ref_state_shapes(rcfg, ref_make_optimizer(rcfg))
    model = LM(cfg, torch.device("meta"))
    state = AdamW(quantized=True).init(model)
    q8 = {n: m for n, m in state.m.items() if isinstance(m, Q8State)}
    assert len(q8) == sum(model.reference_ndim(n) >= 2
                          for n, _ in model.named_parameters())
    checked, embed = 0, {}
    for name, (shape, names) in MESHES.items():
        axes = dict(zip(names, shape))
        ref = _ref_q8_shardings(ref_tss(AbstractMesh(shape, names), rcfg,
                                        ref_st).opt.m)
        ps = param_sharding(model, axes)
        one = opt_leaf_sharding(axes, None)
        for n, leaf in q8.items():
            got = one(leaf, ps[n])
            path, g = reference_path(cfg, n)
            want_c, want_s = ref[path]
            if g is not None:           # stacked: the inner spec
                assert want_c[0] is None and want_s[0] is None
                want_c, want_s = want_c[1:], want_s[1:]
            assert _pad(got.codes.spec, leaf.codes.dim()) == \
                _pad(want_c, leaf.codes.dim()), (name, n)
            assert _pad(got.scales.spec, leaf.scales.dim()) == \
                _pad(want_s, leaf.scales.dim()), (name, n)
            checked += 1
        embed[name] = got_embed = one(q8["embed"], ps["embed"]).codes.spec
        assert got_embed[1] in ("data", ("pod", "data"))
    assert checked == 2 * len(q8)
    assert embed["2x16x16"][1] == "data"


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_bytes_match_reference(kind):
    from repro.launch.hlostats import _wire_bytes as ref_wire_bytes
    for g in (1, 2, 8, 16):
        for nbytes in (0.0, 4096.0, 3.5e9):
            assert hlostats._wire_bytes(kind, nbytes, g) == \
                ref_wire_bytes(kind, nbytes, g), (kind, g, nbytes)


# ----------------------------------------------------------------------
# the kernels' operators on fake CUDA tensors
# ----------------------------------------------------------------------
def _fake_cuda(*specs):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    with mode:
        return mode, [torch.empty(s, dtype=d, device="cuda")
                      for s, d in specs]


@pytest.mark.parametrize("kernel", ["rmsnorm", "flash_attention", "wkv6",
                                    "norm_shift_mix"])
def test_kernel_operator_fakes_and_counted_formula(kernel):
    """Each wrapper on fake CUDA tensors goes through its operator's fake:
    the kernel's output shapes and types (those of the plain version on
    real CPU tensors of the same shapes), one launch recorded by the
    counter with the kernel's own formula, and no launch on the card's
    count."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.norm_shift_mix import ops as nsm
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.rwkv6 import ops as wkv
    bf, f32 = torch.bfloat16, torch.float32
    if kernel == "norm_shift_mix":
        # the time mix's site: K = 5 mixes
        B, S, d, K = 2, 7, 256, 5
        mod, specs = nsm, [((B, S, d), bf), ((B, d), f32), ((d,), f32),
                           ((d,), f32)] + [((d,), f32)] * K

        def call(x, shift, scale, bias, *mixes):
            outs, new_shift = nsm.norm_shift_mix(x, shift, scale, bias,
                                                 mixes)
            return (*outs, new_shift)
        io = B * S * d
        want = (7 * io + 2 * K * io,
                io * 2 + B * d * 4 + 2 * d * 4 + K * d * 4 + K * io * 2
                + B * d * 4)
    elif kernel == "rmsnorm":
        mod, specs = rms, [((2, 7, 256), bf), ((256,), f32)]
        call = rms.rmsnorm
        N, d = 14, 256
        want = (4 * N * d, 2 * N * d * 2 + d * 4)
    elif kernel == "flash_attention":
        mod, specs = flash, [((2, 96, 8, 64), bf), ((2, 96, 2, 64), bf),
                             ((2, 96, 2, 64), bf)]

        def call(q, k, v):
            return flash.flash_attention(q, k, v, window=32)
        # causal with a window of 32: rows 0..31 see i + 1 keys, the rest 32
        pairs = sum(min(i + 1, 32) for i in range(96))
        nbytes = 2 * (2 * 96 * 8 * 64 * 2) + 2 * (2 * 96 * 2 * 64 * 2)
        want = (4 * 2 * 8 * 64 * pairs, nbytes)
    else:
        mod, specs = wkv, [((2, 5, 4, 64), bf)] * 3 + [
            ((2, 5, 4, 64), f32), ((4, 64), f32), ((2, 4, 64, 64), f32)]
        call = wkv.wkv6
        io = 2 * 5 * 4 * 64
        want = (5 * 64 * 64 * 2 * 5 * 4,
                3 * io * 2 + io * 4 + 4 * 64 * 4 + 2 * (2 * 4 * 64 * 64 * 4)
                + io * 2)
    mode, args = _fake_cuda(*specs)
    before = mod.launches
    with mode:
        outs = []
        stats = hlostats.count_step(lambda: outs.append(call(*args)))
    got = outs[0] if isinstance(outs[0], tuple) else (outs[0],)
    g = torch.Generator().manual_seed(0)
    real = [torch.randn(s, generator=g).to(d) for s, d in specs]
    if kernel == "wkv6":
        real[3] = torch.rand(specs[3][0], generator=g) * 0.5 + 0.4
    plain = call(*real)
    plain = plain if isinstance(plain, tuple) else (plain,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in plain]
    assert all(t.device.type == "cuda" for t in got)
    assert dict(stats.kernel_launches) == {kernel: 1}
    assert (stats.flops, stats.memory_bytes) == want
    assert mod.launches == before


@pytest.mark.parametrize("direction", ["forward keeping states",
                                       "backward"])
def test_wkv6_training_operators_fake_and_counted_formula(direction):
    """WKV6's two training launches on fake CUDA tensors: the forward that
    keeps the state every 16 steps (``repro_torch::wkv6_fwd_save``,
    counted as a ``wkv6`` launch) and the backward
    (``repro_torch::wkv6_bwd``, counted as ``wkv6_bwd`` by its own
    formula: 13·hd² float32 flops a token and head, each operand and the
    kept states once) give the plain versions' shapes and types, count one
    launch each, and launch nothing."""
    from repro_torch.kernels.rwkv6 import ops as wkv
    bf, f32 = torch.bfloat16, torch.float32
    B, T, H, hd = 2, 37, 4, 64
    nch = -(-T // 16)
    io = B * T * H * hd
    fwd_specs = [((B, T, H, hd), bf)] * 3 + [((B, T, H, hd), f32),
                                             ((H, hd), f32),
                                             ((B, H, hd, hd), f32)]
    if direction == "backward":
        specs = fwd_specs[:5] + [((B, H, nch, hd, hd), f32),
                                 ((B, T, H * hd), bf), ((B, H, hd, hd), f32)]
        call, name = wkv.wkv6_bwd_cuda, "wkv6_bwd"
        outs = 3 * io * 2 + io * 4 + H * hd * 4 + B * H * hd * hd * 4
        ins = 3 * io * 2 + io * 4 + H * hd * 4 + B * H * nch * hd * hd * 4 \
            + io * 2 + B * H * hd * hd * 4
        want = (13 * hd * hd * B * T * H, ins + outs)
    else:
        specs = fwd_specs
        call, name = wkv.wkv6_cuda_saving, "wkv6"
        want = (5 * hd * hd * B * T * H,
                3 * io * 2 + io * 4 + H * hd * 4 + B * H * hd * hd * 4
                + io * 2 + B * H * hd * hd * 4 + B * H * nch * hd * hd * 4)
    mode, args = _fake_cuda(*specs)
    before = (wkv.launches, wkv.launches_bwd)
    with mode:
        outs = []
        stats = hlostats.count_step(lambda: outs.append(call(*args)))
    g = torch.Generator().manual_seed(0)
    real = [torch.randn(s, generator=g).to(d) for s, d in specs]
    real[3] = torch.rand(specs[3][0], generator=g) * 0.5 + 0.4
    plain = (wkv.wkv6_bwd_plain if direction == "backward"
             else wkv.wkv6_plain_saving)(*real)
    assert [(tuple(t.shape), t.dtype) for t in outs[0]] == \
        [(tuple(t.shape), t.dtype) for t in plain]
    assert all(t.device.type == "cuda" for t in outs[0])
    assert dict(stats.kernel_launches) == {name: 1}
    assert (stats.flops, stats.memory_bytes) == want
    assert (wkv.launches, wkv.launches_bwd) == before


# ----------------------------------------------------------------------
# the counter on the fake backend
# ----------------------------------------------------------------------
def test_counter_counts_each_ranks_local_work():
    """A reduced qwen3 train cell (seq 32, batch 8, two microbatches) on a
    (2, 1) mesh counts exactly half the flops of the same step on plain
    fake tensors; a second count of the cell equals the first, field by
    field (sharding propagation's global-shape operations, cached after
    the first call, are not counted).  The dense cell's useful share,
    6·N·D over the counted flops, lies in (0.5, 1]: remat runs each
    block's forward twice (6/8), the attention's products and the
    embedding's lookup, which 6·N·D counts as a product, pull the other
    ways (0.8477 here)."""
    res = _fake_world("""
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import roofline_terms
        from repro_torch.launch.hlostats import HLOStats, count_step
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.launch.specs import build_cell
        from repro_torch.models.config import ShapeCell
        cfg = get_config("qwen3_32b", reduced=True)
        cell = ShapeCell("toy", 32, 8, "train")
        mesh = make_mesh_for(2, model_parallel=1)
        out = {}
        for name, m in (("plain", None), ("mesh", mesh)):
            counts = []
            for _ in range(2):
                low = build_cell(cfg, cell, m, device="cpu", plan=(2, 4))
                with low.fake_mode:
                    counts.append(count_step(low.fn, *low.arg_specs)
                                  .as_dict())
            out[name] = counts
        st = HLOStats(flops=out["mesh"][0]["flops"])
        out["useful"] = roofline_terms(st, None, 2, cfg, cell)[
            "useful_flops_ratio"]
        print(json.dumps(out))
    """, world=2)
    plain, mesh = res["plain"], res["mesh"]
    assert 0.5 < res["useful"] <= 1.0, res["useful"]
    assert plain[0]["flops"] > 0
    assert mesh[0]["flops"] * 2 == plain[0]["flops"]
    assert plain[0]["total_collective_bytes"] == 0
    assert mesh[0]["collective_counts"]
    assert mesh[1] == mesh[0]
    assert plain[1] == plain[0]


def test_toy_cell_on_a_two_by_four_mesh():
    """The counterpart of the reference's ``test_dryrun_cell_compiles_on_
    toy_mesh``: reduced ``gemma3_12b``, a 64 x 8 train cell on a (2, 4)
    mesh of a fake world of 8 ranks.  Flops, memory bytes, a peak and
    collectives of at least two kinds."""
    res = _fake_world("""
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import count_cell
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.models.config import ShapeCell
        cfg = get_config("gemma3_12b", reduced=True)
        cell = ShapeCell("toy", 64, 8, "train")
        mesh = make_mesh_for(8, model_parallel=4)
        c = count_cell(cfg, cell, mesh, device="cpu")
        print(json.dumps({"hlo": c["stats"].as_dict(),
                          "peak": c["peak_bytes"], "meta": c["meta"]}))
    """, world=8)
    hlo = res["hlo"]
    assert hlo["flops"] > 0 and hlo["memory_bytes"] > 0
    assert res["peak"] > 0
    kinds = [k for k, n in hlo["collective_counts"].items() if n > 0]
    assert len(kinds) >= 2, hlo
    assert hlo["wire_bytes"] > 0
    assert res["meta"]["traced"] == ["1x1"]


def test_extrapolated_depth_and_accumulation_equal_the_full_count():
    """A reduced qwen3 cell of 4 layers and 4 microbatches, counted at one
    and two layers and microbatches and extrapolated (the dry run's trip
    counts), equals the count of the whole step: flops, bytes and every
    collective and kernel count."""
    res = _fake_world("""
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import count_cell
        from repro_torch.launch.hlostats import count_step
        from repro_torch.launch.mesh import make_mesh_for
        from repro_torch.launch.specs import build_cell
        from repro_torch.models.config import ShapeCell
        cfg = dataclasses.replace(get_config("qwen3_32b", reduced=True),
                                  n_layers=4)
        cell = ShapeCell("toy", 32, 16, "train")
        mesh = make_mesh_for(4, model_parallel=2)
        c = count_cell(cfg, cell, mesh, device="cpu", plan=(4, 4))
        low = build_cell(cfg, cell, mesh, device="cpu", plan=(4, 4))
        with low.fake_mode:
            whole = count_step(low.fn, *low.arg_specs).as_dict()
        print(json.dumps({"extrapolated": c["stats"].as_dict(),
                          "whole": whole, "meta": c["meta"]}))
    """, world=4)
    assert res["meta"]["accum"] == 4 and res["meta"]["groups"] == 4
    assert res["meta"]["traced"] == ["1x1", "1x2", "2x1", "2x2"]
    got, want = res["extrapolated"], res["whole"]
    for k in ("flops", "memory_bytes", "wire_bytes"):
        assert got[k] == pytest.approx(want[k], rel=1e-9), k
    assert got["collective_counts"] == want["collective_counts"]
    assert got["kernel_launches"] == want["kernel_launches"]


def test_dryrun_cli_writes_the_reference_keys(tmp_path):
    """``python -m repro_torch.launch.dryrun --device cpu --reduced`` on a
    decode cell in a fake world of 256 ranks writes the reference's
    top-level keys, and counts rwkv6's train cell (the WKV6 backward):
    the CLI's main on a 64-step train cell registered beside train_4k,
    whose 4096-step plain loops take minutes on fake CPU tensors.  On the
    CPU the plain versions run, so no kernel is counted; on the card the
    same cell counts WKV6's forward twice a layer and microbatch and its
    backward once (``chip_smoke.py``'s phase 11a,
    ``test_wkv6_training_operators_fake_and_counted_formula``)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", "--reduced", "--arch", "rwkv6_1_6b", "--shape",
         "decode_32k", "--out", str(tmp_path)], env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads((tmp_path / "rwkv6_1_6b__decode_32k__single.json")
                     .read_text())
    assert {"arch", "shape", "mesh", "chips", "compile_s", "memory",
            "xla_cost_analysis", "hlo", "roofline", "meta"} <= set(got)
    assert got["mesh"] == {"data": 16, "model": 16} and got["chips"] == 256
    assert {"peak_bytes_per_device", "fits_hbm", "hbm_fraction"} <= \
        set(got["memory"])
    assert {"compute_s", "memory_s", "collective_s", "dominant",
            "model_flops_per_device", "useful_flops_ratio",
            "roofline_fraction"} <= set(got["roofline"])
    code = textwrap.dedent(f"""
        from repro_torch.launch.dryrun import main
        from repro_torch.models.config import SHAPES, ShapeCell
        SHAPES["train_64"] = ShapeCell("train_64", 64, 256, "train")
        main(["--device", "cpu", "--reduced", "--arch", "rwkv6_1_6b",
              "--shape", "train_64", "--out", {str(tmp_path)!r}])
    """)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    train = json.loads((tmp_path / "rwkv6_1_6b__train_64__single.json")
                       .read_text())
    assert "skipped" not in train and "error" not in train
    assert {"memory", "hlo", "roofline", "meta"} <= set(train)
    assert train["meta"]["traced"] == ["1x1", "2x1"]
    assert train["roofline"]["model_flops_per_device"] > 0
    assert train["hlo"]["kernel_launches"] == {}
