"""One run of one cell: resolve it by name, set it up, measure its window,
trace a cycle where asked, and decide ``correct``.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the model's sizes as run, its plain reference's family, the precision it
states and the limit of its comparison) and a traffic mix
(``traffic/<mix>.json``).  Per-layer metrics are readers
(``metrics/<name>.py``, each ``read(ctx)`` giving a number or ``None``).
Adding a cell, a configuration, a mix or a metric adds files and entries;
no file here changes."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

from . import check, generator, loop, weights

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# JAX and the JAX package: none may be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Rounds of two cycles of the mix that set-up runs before the window: on
# the H100 two took the allocator's reserve to its level in most runs.
SETTLE_ROUNDS = 2


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds, each
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def resolve(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``bench`` (default: the repository's
    ``BENCHMARK.json``) with its configuration, mix and metrics."""
    if bench is None:
        bench = json.loads((REPO / "BENCHMARK.json").read_text())
    w = _named(bench["workloads"], name, "workload")
    conf = _named(bench["configs"], w["config"], "config")
    config = json.loads((REPO / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    generator.check_mix(mix)

    def here(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if here(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), config, mix, e2e, layer)


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(family: str):
    return importlib.import_module(f"perfbench.reference.{family}")


def arch_config(model: dict):
    """The program's ``ArchConfig`` holding the configuration's sizes."""
    from repro_torch.models.config import ArchConfig, MoEConfig, SSMConfig
    kw = dict(model)
    if kw.get("ssm") is not None:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    if kw.get("moe") is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    return ArchConfig(**kw)


def nvidia_smi() -> Dict[str, str]:
    """The card's name, SM clock, power draw and limit, temperature."""
    keys = ("name", "clocks.sm", "power.draw", "power.limit",
            "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return {"error": repr(e)}
    return dict(zip(keys, (v.strip() for v in out.split(","))))


def allocator(dev) -> Dict[str, int]:
    """The caching allocator's counters that show growth and retries."""
    import torch
    st = torch.cuda.memory_stats(dev)
    return {k: st.get(k, 0) for k in (
        "num_alloc_retries", "num_device_alloc", "num_device_free",
        "reserved_bytes.all.current", "reserved_bytes.all.peak",
        "allocated_bytes.all.peak")}


def settle(clients: loop.Clients, cycles,
           reserved: Callable[[], int]) -> List[int]:
    """``SETTLE_ROUNDS`` rounds of two cycles of the mix
    (``cycles(first)``: the warm-up stream's batches from cycle ``first``
    on), dispatched as the window dispatches them, so that the lanes'
    pools in the caching allocator hold what the window's pairings of
    lengths ask of them before it opens, where each new segment would
    stall it.  A fixed amount of work, so that set-up is the same in
    every run.  Returns the allocator's reserve before and after each
    round."""
    seen = [reserved()]
    for r in range(SETTLE_ROUNDS):
        clients.run(cycles(2 * r), float("inf"), cycles=2)
        seen.append(reserved())
    return seen


def build(cell: Cell, seed: int, device):
    """The system under test on the seed's weights: (cfg, scheduler,
    clients)."""
    import torch
    from repro_torch.core import make_scheduler
    from repro_torch.models import LM
    from repro_torch.runtime import ServingEngine
    m, mix = cell.config["model"], cell.mix
    cfg = arch_config(m)
    ref = reference(cell.config["reference"])
    lm = LM(cfg, torch.device("meta"))
    lm.load_state_dict(weights.make(ref.param_specs(m), seed, device),
                       strict=True, assign=True)
    sched = make_scheduler("parallel", device=str(device))
    engines = [ServingEngine(cfg, lm, batch_size=int(mix["batch"]),
                             max_new_tokens=int(mix["new_tokens"]),
                             scheduler=sched, device=str(device))
               for _ in range(int(mix["in_flight"]))]
    return cfg, sched, loop.Clients(engines, int(mix["new_tokens"]))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             log: Optional[dict] = None) -> dict:
    """One run: the result's fields, ``checks`` last.  ``log``, where
    given, is filled with each batch's times and the card's readings."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    mix, model = cell.mix, cell.config["model"]

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t_enter = time.perf_counter()
    cfg, sched, clients = build(cell, seed, dev)
    t_built = time.perf_counter()
    clients.warm(generator.warmup_batches(mix, cfg.vocab, seed))
    sync()
    t_warm = time.perf_counter()
    reserve = []
    if on_card:                 # the CPU's runs are the tests', no pools
        reserve = settle(clients, lambda first: generator.batches(
            mix, cfg.vocab, seed, first, stream=3),
            lambda: torch.cuda.memory_reserved(dev))
        sync()
    setup_s = time.perf_counter() - t_start
    if log is not None:
        log["setup_phases"] = {
            "start_s": t_enter - t_start, "build_s": t_built - t_enter,
            "warm_s": t_warm - t_built,
            "settle_s": t_start + setup_s - t_warm,
            "settle_reserve": reserve}
    if log is not None and on_card:
        log["smi_before"] = nvidia_smi()
        log["allocator_before"] = allocator(dev)
    stats_open = sched.stats()
    win = clients.run(generator.batches(mix, cfg.vocab, seed), seconds)
    stats_close = sched.stats()
    if log is not None and on_card:
        log["smi_after"] = nvidia_smi()
        log["allocator_after"] = allocator(dev)
    summary = None
    if trace:
        from .devtrace import profiled, summarize
        first = win.records[-1].batch.cycle + 1
        with profiled() as (prof, span):
            clients.span = span
            traced = clients.run(generator.batches(mix, cfg.vocab, seed,
                                                   first), 0.0)
            sync()
        clients.span = None
        summary = summarize(prof.events(),
                            [r.batch.length for r in traced.records],
                            int(mix["in_flight"]))
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    for eng in clients.engines:
        eng.close()
    sched.close()
    del clients, sched
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    n_failed = check.failed(win.records, cfg.vocab, int(mix["new_tokens"]))
    attempted = sum(len(r.requests) for r in win.records)
    samples = check.draw(win.records, int(mix["check_per_length"]), seed)
    ref = reference(cell.config["reference"])
    t_ref = time.perf_counter()
    w = weights.make(ref.param_specs(model), seed, dev)
    gaps = check.served_gaps(ref, model, w, samples, dev)
    del w
    ref_s = time.perf_counter() - t_ref
    limit = cell.config["check"]["limit"]
    widest = float(gaps.max()) if len(gaps) else float("inf")
    due = int(mix["check_per_length"]) * len(mix["lengths"])
    correct = (n_failed == 0 and len(samples) == due and limit is not None
               and widest <= limit)

    ctx = SimpleNamespace(cell=cell, model=model, mix=mix, window=win,
                          stats_open=stats_open, stats_close=stats_close,
                          trace=summary, setup_s=setup_s)
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"tokens_per_s": win.rate, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": n_failed, "metrics": metrics,
              "device": {"memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": summary.idle_gaps()}
    result["checks"] = {
        "logit_gap": {"value": widest, "limit": limit},
        "failed": {"value": n_failed, "limit": 0},
        "compared": {"value": len(samples), "limit": due}}
    if log is not None:
        log.update(
            seed=seed, setup_s=setup_s, reference_s=ref_s,
            window={"seconds": win.seconds, "tokens": win.tokens,
                    "batches": len(win.records)},
            batches=[{"index": r.batch.index, "cycle": r.batch.cycle,
                      "length": r.batch.length, "client": r.client,
                      "dispatch": r.t_dispatch - win.t_open,
                      "flush_s": r.flush_s, "done": r.t_done - win.t_open}
                     for r in win.records],
            gaps=[float(g) for g in gaps], samples=samples)
        if summary is not None:
            log["device_ops_all"] = summary.device_ops(top=None)
    return result
