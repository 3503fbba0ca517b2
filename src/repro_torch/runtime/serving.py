"""Batched serving engine on top of the port's scheduler.

Requests are queued, grouped into fixed-shape batches (same prompt length →
one compiled prefill/decode pair, no retracing), and each batch's
prefill+decode pipeline is issued as a *computational element*: independent
batches land on separate scheduler lanes and overlap (the paper's
space-sharing applied to inference), while the shared read-only weights are
tracked as a const dependency — exactly the two-branch pattern of Fig. 2.

Multi-tenant QoS: ``submit(..., tenant=, priority=, deadline_s=)`` tags each
request.  Batches are assembled per (shape, tenant, priority) and issued in
**weighted-fair** order (stride scheduling — each tenant's virtual time
advances by 1/weight per batch), and the underlying launches carry the tags
so the scheduler's priority-weighted space-sharing and per-tenant stats see
them.  Deadline'd requests add **EDF batch assembly**: each tenant's ready
batches order earliest-deadline-first, and while any tenant's head batch
carries a deadline the earliest one issues ahead of the stride order (the
stride clock still charges it, so fairness debt is preserved).  A
``max_batch_wait_s`` bound holds under-full batches back for late arrivals
instead of issuing fragments, flushing them once the oldest member ages out
(or its deadline draws near).  ``submit`` and ``flush`` are thread-safe via
the scheduler's submission pipeline lock.

On ``device="cuda"`` (the default) each batch runs on its lane's CUDA
stream and prefill goes through the hand-written kernels: flash attention
(``use_flash`` defaults to True there, False on the CPU) for the families
with attention (dense, MoE, hymba), the WKV6 recurrence for the ssm family
(RWKV6), and RMSNorm wherever the model normalizes with it.
``init_cache`` gives each batch its per-layer caches: KV caches for
attention layers, recurrent states for rwkv layers and hymba's Mamba heads
(a nested ``"mamba"`` dict the model replaces at each step).  Requests are
tokens only, as the reference's engine takes them: an encoder-decoder's
frames and a vision model's patches come through ``launch.serve``.

Per-slot ragged positions (token-level continuous batching) would need a
vector-``pos`` decode mask; noted as future work in DESIGN.md.
"""
from __future__ import annotations

import collections
import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import (DEFAULT_TENANT, GrScheduler, make_scheduler,
                    priority_weight)
from ..core.frontend import GrFunction, function
from ..core.managed import ManagedValue
from ..models import init_cache
from ..models.config import ArchConfig
from .steps import make_decode_step, make_prefill_step


@dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (prompt_len,)
    new_tokens: int
    tenant: str = DEFAULT_TENANT
    priority: int = 0
    deadline_s: Optional[float] = None   # per-request latency SLO (relative)
    t_submit: float = 0.0                # host clock at submit()
    result: Optional[np.ndarray] = None

    @property
    def deadline_t(self) -> float:
        """Absolute deadline (+inf when the request has none)."""
        if self.deadline_s is None:
            return float("inf")
        return self.t_submit + self.deadline_s


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, *, batch_size: int = 2,
                 max_new_tokens: int = 16,
                 scheduler: Optional[GrScheduler] = None,
                 capture: bool = True,
                 max_batch_wait_s: Optional[float] = None,
                 device: str = "cuda",
                 use_flash: Optional[bool] = None) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine: device='cuda' but no CUDA device is "
                "available; pass device='cpu' to serve on the host")
        held = next(params.parameters()).device
        if held.type != self.device.type:
            raise ValueError(f"ServingEngine: the weights lie on {held}, "
                             f"the engine runs on {self.device}")
        self.cfg = cfg
        self.batch = batch_size
        self.max_new = max_new_tokens
        # Age bound for under-full batches: flush() holds a partial batch
        # back (for late same-shape arrivals) until its oldest member has
        # waited this long.  None = issue partials immediately (legacy).
        self.max_batch_wait_s = max_batch_wait_s
        self._owns_sched = scheduler is None
        self.sched = scheduler or make_scheduler("parallel", device=device)
        # Steady-state batches of one shape repeat the identical episode;
        # capture/replay amortizes DAG inference + lane assignment across
        # them (one plan per (prompt_len, new_tokens) signature).
        self.capture = capture and self.sched.policy == "parallel"
        self.params_v = ManagedValue(self.sched, params, name="weights")
        self._queue: "collections.deque[Request]" = collections.deque()
        self._rid = 0
        # The reference's use_flash switch, on by default on the card.
        self.use_flash = (self.device.type == "cuda" if use_flash is None
                          else use_flash)
        self._prefill = make_prefill_step(cfg, use_flash=self.use_flash)
        self._decode = make_decode_step(cfg)
        self._pending: List[tuple] = []
        # Declared once per (prompt_len, new_tokens) shape and reused for
        # every batch of that shape: capture plans key on the declared
        # function's identity, so a stable GrFunction per shape is what lets
        # steady-state batches replay one plan instead of re-recording.
        self._fns: Dict[tuple, GrFunction] = {}

    # ------------------------------------------------------------------
    def submit(self, tokens: np.ndarray, new_tokens: int = 0, *,
               tenant: str = DEFAULT_TENANT, priority: int = 0,
               deadline_s: Optional[float] = None) -> Request:
        """Queue one request.  ``tenant``/``priority`` drive weighted-fair
        batch assembly and the scheduler's space-sharing weights;
        ``deadline_s`` (seconds from now) makes the request's batch EDF-rank
        ahead of deadline-free work and carries into the scheduler's
        deadline-aware execution."""
        with self.sched.pipeline:
            req = Request(self._rid, np.asarray(tokens, np.int32),
                          new_tokens or self.max_new,
                          tenant=tenant, priority=priority,
                          deadline_s=deadline_s,
                          t_submit=self.sched.executor.host_now())
            self._rid += 1
            self._queue.append(req)
            return req

    # ------------------------------------------------------------------
    def _batch_fn(self, prompt_len: int, new_tokens: int) -> GrFunction:
        """The declared batch kernel for one (prompt_len, new_tokens) shape:
        const weights, const prompt tokens, out generated tokens."""
        key = (prompt_len, new_tokens)
        gf = self._fns.get(key)
        if gf is not None:
            return gf
        cfg = self.cfg
        max_len = prompt_len + new_tokens
        prefill, decode = self._prefill, self._decode

        def kernel(params, toks, _out):
            cache = init_cache(cfg, toks.shape[0], max_len, toks.device)
            logits, cache = prefill(params, {"tokens": toks}, cache)
            nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
            outs = [nxt]
            for i in range(new_tokens - 1):
                nxt, _, cache = decode(params, nxt, cache, prompt_len + i)
                outs.append(nxt)
            return torch.cat(outs, dim=1)

        # NOTE: the declared name is shape-keyed, not rid-keyed, so repeated
        # same-shape batches match one cached plan (and the kernel history
        # aggregates per shape).
        gf = function(kernel, modes=("const", "const", "out"),
                      name=f"serve_p{prompt_len}_n{new_tokens}",
                      scheduler=self.sched)
        self._fns[key] = gf
        return gf

    def flush(self, force: bool = False) -> None:
        """Assemble queued requests into fixed-shape batches and issue them
        through the scheduler (each batch = one lane-schedulable element).

        Batches are formed per (shape, tenant, priority) and issued in
        weighted-fair order: the tenant with the smallest virtual time goes
        next, and issuing one batch advances its clock by ``1/weight`` —
        priority-3 tenants therefore issue 8 batches for every priority-0
        batch while both have work queued, yet nobody starves.

        Deadline'd requests rank their batch earliest-deadline-first within
        the tenant, and an urgent head batch (finite deadline) issues ahead
        of the stride order; deadline-free flushes are bit-identical to the
        stride-only engine.  With ``max_batch_wait_s`` set, an under-full
        batch is *held* (requeued) until its oldest request has waited that
        long or a member's deadline is within the wait bound — late
        same-shape arrivals then fill it instead of padding.  ``force=True``
        issues everything regardless of age (drain/shutdown path)."""
        with self.sched.timeline.span("serve.flush"), self.sched.pipeline:
            wait = getattr(self, "max_batch_wait_s", None)
            now = self.sched.executor.host_now()
            by_key: Dict[tuple, List[Request]] = collections.defaultdict(list)
            while self._queue:
                r = self._queue.popleft()
                by_key[(len(r.tokens), r.new_tokens,
                        r.tenant, r.priority)].append(r)
            # Per-tenant queue of ready batches, highest priority first (a
            # tenant's priority-3 batch must not wait behind its own
            # priority-0 batch; the stride charge below then uses the right
            # weight) with shape as a deterministic tie-break.
            ready: Dict[str, collections.deque] = {}
            held: List[Request] = []
            for (plen, ntok, tenant, prio), reqs in sorted(
                    by_key.items(), key=lambda kv: (-kv[0][3], kv[0][:2])):
                # Stable deadline sort: urgent requests pack into the first
                # batch of their shape; deadline-free requests (all +inf)
                # keep FIFO arrival order.
                reqs.sort(key=lambda r: r.deadline_t)
                for i in range(0, len(reqs), self.batch):
                    group = reqs[i:i + self.batch]
                    edl = min(r.deadline_t for r in group)
                    if (wait is not None and not force
                            and len(group) < self.batch
                            and now - min(r.t_submit for r in group) < wait
                            and edl - now > wait):
                        held.extend(group)
                        continue
                    ready.setdefault(tenant, collections.deque()).append(
                        (edl, plen, ntok, prio, group))
            if held:
                self._queue.extendleft(reversed(held))
            if not ready:
                return
            # Within each tenant: earliest deadline first.  Stable, and all
            # deadline-free batches key at +inf, so a deadline-free flush
            # preserves the (-priority, shape) order built above exactly.
            ready = {t: collections.deque(sorted(dq, key=lambda b: b[0]))
                     for t, dq in ready.items()}
            # Stride scheduling over this flush's tenants.  Virtual time is
            # per-flush: every flush drains the whole queue, so there is no
            # standing backlog for cross-flush debt to arbitrate — and a
            # persisted vtime would let a long-idle tenant return anchored
            # to a stale minimum and claim an unbounded burst.
            vt = {t: 0.0 for t in ready}
            while any(ready.values()):
                live = [t for t in ready if ready[t]]
                # EDF across tenant heads while any head is deadline'd; the
                # stride clock below still charges the issue, so the
                # weighted-fair debt is settled once deadlines drain.
                if min(ready[t][0][0] for t in live) < float("inf"):
                    tenant = min(live, key=lambda t: (ready[t][0][0], t))
                else:
                    tenant = min(live, key=lambda t: (vt[t], t))
                _, plen, ntok, prio, group = ready[tenant].popleft()
                vt[tenant] += 1.0 / priority_weight(prio)
                # the batch's span, traced by its first request's rid
                with self.sched.timeline.span("serve.issue",
                                              trace_id=group[0].rid):
                    self._issue_batch(plen, ntok, tenant, prio, group)

    def _issue_batch(self, plen: int, ntok: int, tenant: str, prio: int,
                     group: List[Request]) -> None:
        toks = np.stack([r.tokens for r in group])
        pad = self.batch - len(group)
        if pad:  # fixed shapes -> no retracing
            toks = np.concatenate(
                [toks, np.zeros((pad, plen), np.int32)])
        t_in = self.sched.array(toks, name=f"prompts_{group[0].rid}")
        t_out = self.sched.array(
            np.zeros((self.batch, ntok), np.int32),
            name=f"gen_{group[0].rid}")
        # Priority/tenant are call-scoped options and part of the plan
        # signature, so tenants never share a plan's weighting.
        opts = dict(priority=prio, tenant=tenant)
        dls = [r.deadline_s for r in group if r.deadline_s is not None]
        if dls:
            # The *declared* (relative) window, not the remaining slack:
            # deadline_s is part of the capture-plan signature, so a stable
            # value is what lets steady-state deadline'd batches keep
            # replaying one plan.  The absolute deadline_t is stamped at
            # launch, i.e. the window restarts at issue time.
            opts["deadline_s"] = min(dls)
        gf = self._batch_fn(plen, ntok).with_options(**opts)
        ctx = (self.sched.capture(gf.name) if self.capture
               else contextlib.nullcontext())
        with ctx:
            gf(self.params_v, t_in, t_out)
        self._pending.append((group, t_out))

    def collect(self) -> List[Request]:
        """Host-reads each batch's output (syncing only its lane) and
        attaches results to the requests."""
        with self.sched.timeline.span("serve.collect"):
            done = []
            for group, t_out in self._pending:
                vals = np.asarray(t_out)
                for j, r in enumerate(group):
                    r.result = vals[j]
                    done.append(r)
            self._pending.clear()
            return done

    def stats(self) -> dict:
        return self.sched.stats()

    def tenant_stats(self) -> dict:
        """Per-tenant QoS (makespan, queueing delay, latency p50/p99)."""
        return self.sched.tenant_stats()

    # ------------------------------------------------------------------
    def drain(self) -> List[Request]:
        """Flush everything still queued (ignoring the batch-age hold) and
        collect every pending batch — no request left in flight."""
        done: List[Request] = []
        while self._queue or self._pending:
            if self._queue:
                self.flush(force=True)
            done.extend(self.collect())
        return done

    def close(self) -> None:
        """Drain in-flight work; close the scheduler only when the engine
        created it (a caller-supplied scheduler — e.g. the daemon's shared
        one — outlives any single engine)."""
        self.drain()
        if self._owns_sched:
            self.sched.close()
        else:
            self.sched.sync()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
