"""Pipeline parallelism over the ``pod`` axis (GPipe-style): the port of
``repro.runtime.pipeline``.

The multi-pod mesh's slowest links are the inter-pod ones; instead of pure
DP over ``pod`` (per-step gradient reduce-scatter across pods), the layer
stack can be split into one *stage per pod* and microbatches streamed
through with point-to-point handoffs — inter-pod traffic becomes one
activation tensor per microbatch instead of the full gradient set.

Every rank runs the same program on its own stage's parameters (a leading
``n_stages`` axis sharded over the pipeline axis).  The GPipe schedule runs
``n_micro + n_stages - 1`` ticks: each tick applies the local stage to the
activation received last tick (stage 0 takes microbatch ``t``) and hands
the result to the next rank of the axis; the last stage commits microbatch
``t - (S - 1)``.  The handoff is ``send``/``recv`` inside an autograd
function whose backward sends the gradient one stage back, so
``torch.autograd`` flows through the schedule as ``jax.grad`` flows
through the reference's ``ppermute``.  Every rank takes part in every
tick's handoff, forward and backward, in the same order, so no pair of
ranks waits on the other.  Bubble fraction = (S-1)/(T+S-1).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _peers(mesh, axis: str):
    """(process group of ``axis``, this rank's stage, the global ranks of
    the previous and next stage or None)."""
    group = mesh.get_group(axis)
    stage = dist.get_group_rank(group, dist.get_rank())
    n = dist.get_world_size(group)
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage < n - 1 else None
    return group, stage, prev, nxt


def _exchange(send, to, recv_like, frm, group):
    """Sends ``send`` to rank ``to`` and receives a tensor shaped as
    ``recv_like`` from rank ``frm`` (either may be None); returns the
    received tensor, or zeros."""
    got = torch.zeros_like(recv_like)
    ops = []
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, got, frm, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


class _Handoff(torch.autograd.Function):
    """Forward: send y to the next stage, return what the previous stage
    sent (zeros on stage 0), as ``ppermute`` over the forward pairs.
    Backward: the transpose, one stage back."""

    @staticmethod
    def forward(ctx, y, group, prev, nxt):
        ctx.peers = (group, prev, nxt)
        return _exchange(y, nxt, y, prev, group)

    @staticmethod
    def backward(ctx, g):
        group, prev, nxt = ctx.peers
        return _exchange(g, prev, g, nxt, group), None, None, None


class _SumOverAxis(torch.autograd.Function):
    """All-reduce over the axis.  Every rank then holds the same value and
    computes the same loss from it, so each rank's gradient of its own
    contribution is the incoming gradient itself."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _local_stage(a, stage: int):
    """This rank's stage of a leaf with a leading ``n_stages`` axis: the
    local shard of a ``DTensor`` sharded over the axis, or row ``stage``
    of a whole tensor."""
    if hasattr(a, "to_local"):
        return a.to_local()[0]
    return a[stage]


def pipeline_apply(stage_fn: Callable, mesh, axis: str = "pod"):
    """Build a pipelined forward: ``f(stage_params, x_micro) -> y_micro``.

    * ``stage_params``: a tensor or a dict/list/tuple of tensors whose
      leaves have a leading ``n_stages`` axis (``DTensor``s sharded over
      ``axis`` on their first dim, or whole tensors every rank holds).
    * ``x_micro``: (n_micro, micro_batch, ...) — the same on every rank.
    * ``stage_fn(params_stage, x) -> x`` applies one stage.

    Returns the outputs (n_micro, micro_batch, ...) on every rank: the last
    stage's, summed over the axis with zeros from the others.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))

    def run(params, xs):
        group, stage, prev, nxt = _peers(mesh, axis)
        local = _tree_map(lambda a: _local_stage(a, stage), params)
        n_micro = xs.shape[0]
        inflight = torch.zeros_like(xs[0])
        outputs = []
        for t in range(n_micro + n_stages - 1):
            # which microbatch enters the pipe this tick (stage 0 only);
            # both inputs stay in the graph on every rank, so that every
            # rank's backward reaches every handoff
            x_in = torch.where(torch.tensor(stage == 0),
                               xs[t if t < n_micro else 0], inflight)
            y = stage_fn(local, x_in)
            inflight = (_Handoff.apply(y, group, prev, nxt) if n_stages > 1
                        else y)
            if t >= n_stages - 1:      # microbatch t-(S-1) leaves the pipe
                outputs.append(y)
        last = float(stage == n_stages - 1)
        outs = torch.stack(outputs) * last
        # the final handoff's output is unused: tie it in with weight 0
        outs = outs + 0.0 * inflight.sum()
        return _SumOverAxis.apply(outs, group) if n_stages > 1 else outs

    return run


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_loss_fn(stage_fn: Callable, loss_tail: Callable, mesh,
                     axis: str = "pod"):
    """Differentiable pipelined loss: ``loss_tail(last_stage_output,
    labels)``.  ``loss.backward()`` flows through the handoff schedule
    (GPipe's recompute-free backward); each rank's stage parameters get
    their own gradient."""
    fwd = pipeline_apply(stage_fn, mesh, axis)

    def loss(stage_params, xs, ys):
        outs = fwd(stage_params, xs)
        return loss_tail(outs, ys)

    return loss
