"""LM stack of the port: every family of ``repro.models.transformer``
(dense, MoE, ssm (RWKV6), hybrid (Hymba: attention and Mamba heads in
parallel), encoder-decoder (Seamless) and the vision-stub VLM (InternVL)).

The reference scans layer *groups* with ``lax.scan`` over stacked
parameters; here each layer is its own ``Block`` module in one flat
``ModuleList`` and a Python loop walks them.  Layer ``g * len(kinds) + i``
is position ``i`` of group ``g`` in the reference (gemma3: five
``attn_local`` layers, then one ``attn_global``).  An encoder-decoder model
also has ``encoder``, a ``ModuleList`` of ``attn_global`` blocks (the
reference's stacked ``params["encoder"]``), ``enc_norm`` and
``frontend_proj``; a vision model has ``frontend_proj``, which projects the
stub's patch embeddings over the first token positions.

Caches are a list of per-layer dicts, updated in place where the reference
returns new ones: ``{"k", "v"}`` bf16 tensors written in place for
attention layers (a ring buffer of the window's size for sliding-window and
hymba layers), ``{"shift", "wkv", "cmix_shift"}`` float32 states for rwkv
layers and a nested ``"mamba": {"h", "conv"}`` float32 state for hymba
layers, whose entries are replaced by the new states, and ``{"cross_k",
"cross_v"}`` bf16 tensors for the decoder's cross-attention, filled by
prefill from the encoder's output.  An MoE config's blocks hold a
``moe.MoE`` where the others hold an ``MLP``, as the reference's
``_ffn_part`` does; its aux losses are summed into an ``aux`` dict where a
caller passes one, and dropped otherwise (serving).

Numerics follow the reference: parameters cast at every matmul, a bf16
residual stream from the embedding on, bf16 caches and f32 logits.

Three entry points per model, each taking the batch's ``frames``
(encoder-decoder) and ``patches`` (vision) as the reference does:
* ``forward_train``  — full-sequence logits (+ MoE aux losses), under
  autograd; ``remat=True`` recomputes each block in the backward pass;
* ``forward_prefill``— full sequence, returns last-token logits + caches;
* ``forward_decode`` — one token against the caches.

Parameters are created with ``requires_grad=False``, for serving; a trainer
makes them trainable (``make_train_step`` does).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import mamba as M
from . import moe as MOE
from . import rwkv as R
from ..kernels import as_dtensor, is_dtensor, kernel_placements
from ..sharding.context import (recompute_context, shard_activations,
                                to_stream, use_weight)
from .config import ArchConfig
from .layers import MLP, Norm, normal_init

# ----------------------------------------------------------------------
# per-position layer kinds within one scan group of the reference
# ----------------------------------------------------------------------
def layer_kinds(cfg: ArchConfig) -> List[str]:
    if cfg.family == "ssm":
        return ["rwkv"]
    if cfg.family == "hybrid":
        return ["hymba"]
    g = cfg.layer_group
    if g > 1:  # local:global pattern (gemma3: 5 local then 1 global)
        return ["attn_local"] * (g - 1) + ["attn_global"]
    if cfg.sliding_window > 0 and cfg.global_every == 0:
        return ["attn_local"]
    return ["attn_global"]


def stack_kinds(cfg: ArchConfig) -> List[str]:
    """The kind of every layer, in execution order."""
    kinds = layer_kinds(cfg)
    n_groups = cfg.n_layers // len(kinds)
    return kinds * n_groups


class Block(nn.Module):
    """One layer: the reference's ``init_block`` groups, each the module of
    its name (``ln1``, ``attn``, ``mamba``, ``ln_cross``, ``cross``,
    ``ln2``, ``ffn`` or ``moe``; ``rwkv`` and ``cmix``)."""

    def __init__(self, cfg: ArchConfig, kind: str, generator, device,
                 dtype=torch.float32, cross: bool = False) -> None:
        super().__init__()
        self.kind = kind
        self.window = (cfg.sliding_window if kind in ("attn_local", "hymba")
                       else 0)
        self.ln1 = Norm(cfg, cfg.d_model, device, dtype)
        if kind == "rwkv":
            self.rwkv = R.TimeMix(cfg, generator, device, dtype)
            self.ln2 = Norm(cfg, cfg.d_model, device, dtype)
            self.cmix = R.ChannelMix(cfg, generator, device, dtype)
            return
        self.attn = A.Attention(cfg, generator, device, dtype)
        if kind == "hymba":
            self.mamba = M.Mamba(cfg, generator, device, dtype)
        if cross:
            self.ln_cross = Norm(cfg, cfg.d_model, device, dtype)
            self.cross = A.Attention(cfg, generator, device, dtype,
                                     cross=True)
        self.ln2 = Norm(cfg, cfg.d_model, device, dtype)
        if cfg.moe is not None:
            self.moe = MOE.MoE(cfg, generator, device, dtype)
        else:
            self.ffn = MLP(cfg, cfg.d_model, cfg.d_ff, generator, device,
                           dtype)


class LM(nn.Module):
    """Embedding, a flat stack of blocks, final norm and LM head; the
    encoder stack and the frontend projection where the config has them."""

    def __init__(self, cfg: ArchConfig, device,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = normal_init((cfg.vocab, cfg.d_model), generator, device,
                                 dtype=dtype)
        self.final_norm = Norm(cfg, cfg.d_model, device, dtype)
        self.lm_head = (None if cfg.tie_embeddings else
                        normal_init((cfg.d_model, cfg.vocab), generator,
                                    device, dtype=dtype))
        cross = cfg.n_encoder_layers > 0
        self.blocks = nn.ModuleList(
            Block(cfg, kind, generator, device, dtype, cross=cross)
            for kind in stack_kinds(cfg))
        self.encoder = nn.ModuleList(
            Block(cfg, "attn_global", generator, device, dtype)
            for _ in range(cfg.n_encoder_layers))
        self.enc_norm = (Norm(cfg, cfg.d_model, device, dtype) if cross
                         else None)
        self.frontend_proj = (
            normal_init((cfg.d_model, cfg.d_model), generator, device,
                        dtype=dtype)
            if cross or cfg.frontend == "vision" else None)

    def reference_ndim(self, name: str) -> int:
        """The rank of parameter ``name`` in the reference's layout, which
        stacks every block and encoder parameter with a leading layer axis
        (the optimizer's weight decay and q8 moments follow that rank)."""
        return self.get_parameter(name).dim() + name.startswith(
            ("blocks.", "encoder."))


def init_lm(cfg: ArchConfig, generator: torch.Generator,
            device="cuda", dtype=torch.float32) -> LM:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (a ``torch.Generator`` on ``device``) — not the
    reference's numbers; ``convert.from_jax_params`` carries those over."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_lm: device='cuda' but no CUDA device is "
                           "available; pass device='cpu' for the host")
    return LM(cfg, device, generator, dtype)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda",
               dtype=torch.bfloat16, *, cross_len: int = 0
               ) -> List[Dict[str, object]]:
    """Per-layer caches: bf16 (``dtype``) keys and values for attention
    layers, float32 states for rwkv layers (which ignore ``max_len``) and
    for hymba's Mamba heads (``"mamba": {"h", "conv"}``), and with
    ``cross_len`` the cross-attention's ``cross_k``/``cross_v`` (B,
    cross_len, Hkv, hd).  ``cross_len`` is keyword-only: the reference's
    fourth positional argument is ``cross_len``, this one's ``device``."""
    caches: List[Dict[str, object]] = []
    for kind in stack_kinds(cfg):
        if kind == "rwkv":
            st = R.init_rwkv_state(cfg, batch, device)
            st["cmix_shift"] = torch.zeros((batch, cfg.d_model),
                                           dtype=torch.float32, device=device)
            caches.append(st)
            continue
        # sliding-window layers only ever attend to the last `window` keys:
        # their cache is a ring buffer of that size
        n = max_len
        if kind in ("attn_local", "hymba") and cfg.sliding_window > 0:
            n = min(max_len, cfg.sliding_window)
        c: Dict[str, object] = dict(A.init_kv_cache(cfg, batch, n, device,
                                                    dtype))
        if kind == "hymba":
            c["mamba"] = M.init_mamba_state(cfg, batch, device)
        if cross_len:
            shape = (batch, cross_len, cfg.n_kv_heads, cfg.hd)
            c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
            c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
        caches.append(c)
    return caches


# ----------------------------------------------------------------------
# block apply
# ----------------------------------------------------------------------
def _apply_rwkv_block(cfg, blk: Block, x, state, seq: bool):
    h = blk.ln1(x)
    mixer = R.apply_rwkv_seq if seq else R.apply_rwkv_step
    y, _ = mixer(cfg, blk.rwkv, h, state)
    x = x + y
    y2, cshift = R.apply_channel_mix(cfg, blk.cmix, blk.ln2(x),
                                     state["cmix_shift"])
    state["cmix_shift"] = cshift.float()
    return x + y2


def _ffn_part(cfg, blk: Block, x, aux: Optional[dict]):
    h = shard_activations(blk.ln2(x))
    if not hasattr(blk, "moe"):
        return x + to_stream(blk.ffn(h), x)
    y, a = MOE.apply_moe(cfg, blk.moe, h)
    if aux is not None:
        aux["moe_aux"] = aux.get("moe_aux", 0.0) + a["moe_aux"]
        aux["moe_z"] = aux.get("moe_z", 0.0) + a["moe_z"]
        aux.setdefault("moe_kept", []).append(a["moe_kept"])
    return x + to_stream(y, x)


def apply_block_seq(cfg, blk: Block, x, positions, *, cache=None,
                    enc_out=None, bidirectional: bool = False,
                    use_flash: bool = False, aux: Optional[dict] = None):
    """Full-sequence mode.  Writes the block's keys/values (attention), new
    states (rwkv, hymba's Mamba heads) and cross keys/values (from
    ``enc_out``) into ``cache`` in place and returns the new residual
    stream; an MoE block adds its aux losses and kept-token counts to
    ``aux`` where one is given."""
    if blk.kind == "rwkv":
        return _apply_rwkv_block(cfg, blk, x, cache, seq=True)
    h = shard_activations(blk.ln1(x))
    y, (k, v) = A.attend_full(cfg, blk.attn, h, positions, window=blk.window,
                              use_flash=use_flash,
                              bidirectional=bidirectional)
    if blk.kind == "hymba":
        state = (cache["mamba"] if cache is not None
                 else M.init_mamba_state(cfg, x.shape[0], x.device))
        ym, mstate = M.apply_mamba_seq(cfg, blk.mamba, h, state)
        y = 0.5 * (y + ym)
    x = x + to_stream(y, x)
    cross = hasattr(blk, "cross") and enc_out is not None
    if cross:
        yc, (ck, cv) = A.attend_cross(
            cfg, blk.cross, shard_activations(blk.ln_cross(x)), enc_out)
        x = x + to_stream(yc, x)
    x = _ffn_part(cfg, blk, x, aux)
    if cache is not None:
        S = k.shape[1]
        W = cache["k"].shape[1]
        for name, t in (("k", k), ("v", v)):
            c = cache[name]
            if W < S:
                # ring buffer: token t lives at slot t % W
                tail, r = t[:, S - W:].to(c.dtype), S % W
                c.copy_(torch.cat([tail[:, W - r:], tail[:, :W - r]], 1))
            else:
                c[:, :S] = t.to(c.dtype)
        if blk.kind == "hymba":
            cache["mamba"] = mstate
        if cross:
            cache["cross_k"].copy_(ck)
            cache["cross_v"].copy_(cv)
    return x


def apply_block_decode(cfg, blk: Block, x, cache, pos: int):
    """Single-token mode; updates ``cache`` in place."""
    if blk.kind == "rwkv":
        return _apply_rwkv_block(cfg, blk, x, cache, seq=False)
    h = blk.ln1(x)
    y, kv = A.attend_decode(cfg, blk.attn, h, cache, pos, window=blk.window)
    cache.update(kv)
    if blk.kind == "hymba":
        ym, cache["mamba"] = M.apply_mamba_step(cfg, blk.mamba, h,
                                                cache["mamba"])
        y = 0.5 * (y + ym)
    x = x + y
    if hasattr(blk, "cross"):
        x = x + A.attend_cross_decode(cfg, blk.cross, blk.ln_cross(x), cache)
    return _ffn_part(cfg, blk, x, None)


# ----------------------------------------------------------------------
# forward passes
# ----------------------------------------------------------------------
def _embed(cfg, params: LM, tokens, frontend=None):
    """bf16 token embeddings; a vision model's patch embeddings
    (``frontend``, (B, P, d)), projected by ``frontend_proj`` in bf16,
    take the first P positions."""
    # The reference casts the whole table to bf16 and then gathers;
    # gathering the rows first and casting them gives the same values.
    # (``F.embedding``: its backward has a DTensor rule in every torch the
    # port runs on, where indexing's has not.)
    table = use_weight(params.embed, ("model", None))
    x = shard_activations(F.embedding(tokens.long(), table).to(
        torch.bfloat16))
    if cfg.frontend == "vision" and frontend is not None:
        n = frontend.shape[1]
        if n > x.shape[1]:
            raise ValueError(f"{cfg.name}: {n} patch embeddings do not fit "
                             f"a prompt of {x.shape[1]} tokens")
        fp = frontend.to(x.dtype) @ params.frontend_proj.to(x.dtype)
        x = torch.cat([fp, x[:, n:]], dim=1)
    return x


def _encode(cfg, params: LM, frames):
    """Seamless encoder: frames (B, S_enc, d) from the audio-frontend stub,
    projected in bf16, through the bidirectional encoder blocks and
    ``enc_norm``."""
    x = frames.to(torch.bfloat16) @ params.frontend_proj.to(torch.bfloat16)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for blk in params.encoder:
        x = apply_block_seq(cfg, blk, x, positions, bidirectional=True)
    return params.enc_norm(x)


def _frontends(cfg, params: LM, batch):
    """(encoder output or None, patch embeddings or None) of a batch."""
    enc_out = (_encode(cfg, params, batch["frames"]) if cfg.n_encoder_layers
               else None)
    return enc_out, batch.get("patches")


def _logits(cfg, params: LM, x):
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    head = use_weight(head.to(x.dtype), (None, "model"))
    return (x @ head).float()


@torch.no_grad()
def forward_prefill(cfg: ArchConfig, params: LM, batch, cache,
                    use_flash: bool = False):
    """Full-sequence prefill that fills the caches.
    Returns (last-token logits (B,V) f32, cache)."""
    tokens = batch["tokens"]
    enc_out, patches = _frontends(cfg, params, batch)
    x = _embed(cfg, params, tokens, patches)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    for blk, c in zip(params.blocks, cache):
        x = apply_block_seq(cfg, blk, x, positions, cache=c, enc_out=enc_out,
                            use_flash=use_flash)
    x = params.final_norm(x[:, -1:, :])
    return _logits(cfg, params, x)[:, 0], cache


@torch.no_grad()
def forward_decode(cfg: ArchConfig, params: LM, tokens, cache, pos: int):
    """tokens: (B, 1); pos: index of the new token.
    Returns (logits (B, V) f32, cache)."""
    x = _embed(cfg, params, tokens)
    for blk, c in zip(params.blocks, cache):
        x = apply_block_decode(cfg, blk, x, c, pos)
    x = params.final_norm(x)
    return _logits(cfg, params, x)[:, 0], cache


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def _train_block(cfg, blk: Block, x, positions, use_flash: bool,
                 enc_out=None):
    """One block of ``forward_train``: (x, moe_aux, moe_z).  The aux losses
    are outputs, not additions to a caller's dict, so that remat's
    recompute adds nothing twice."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if blk.kind == "rwkv":
        state = R.init_rwkv_state(cfg, x.shape[0], x.device)
        state["cmix_shift"] = torch.zeros((x.shape[0], cfg.d_model),
                                          dtype=torch.float32,
                                          device=x.device)
        return _apply_rwkv_block(cfg, blk, x, state, seq=True), zero, zero
    aux: dict = {}
    x = apply_block_seq(cfg, blk, x, positions, enc_out=enc_out,
                        use_flash=use_flash, aux=aux)
    return x, aux.get("moe_aux", zero), aux.get("moe_z", zero)


def forward_train(cfg: ArchConfig, params: LM, batch, use_flash: bool = False,
                  remat: bool = False, seq_shard: bool = False):
    """batch: dict(tokens (B,S) int, + frames (encoder-decoder) or patches
    (vision) where the config takes them).
    Returns (logits_f32 (B,S,V), {"moe_aux", "moe_z"} f32 scalars).
    ``remat=True`` checkpoints each block (recompute in backward) to bound
    activation memory, as the reference checkpoints each scanned group
    (its encoder is not checkpointed, nor is this one).  ``seq_shard``
    shards the residual stream's sequence dim over "model" between blocks
    (Megatron-style sequence parallelism; a no-op outside a mesh): each
    norm's output, which feeds the column-parallel products, is gathered
    along the sequence first (``shard_activations``), as Megatron's
    sequence parallelism gathers it."""
    tokens = batch["tokens"]
    enc_out, patches = _frontends(cfg, params, batch)
    x = _embed(cfg, params, tokens, patches)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    moe_aux = moe_z = torch.zeros((), dtype=torch.float32, device=x.device)
    seq_ax = "model" if seq_shard else None
    if seq_shard:
        x = shard_activations(x, seq_axis=seq_ax)
    for blk in params.blocks:
        if remat:
            x, a, z = checkpoint(_train_block, cfg, blk, x, positions,
                                 use_flash, enc_out, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=recompute_context)
        else:
            x, a, z = _train_block(cfg, blk, x, positions, use_flash,
                                   enc_out)
        moe_aux = moe_aux + a
        moe_z = moe_z + z
        if seq_shard:
            x = shard_activations(x, seq_axis=seq_ax)
    x = shard_activations(params.final_norm(x))
    return _logits(cfg, params, x), {"moe_aux": moe_aux, "moe_z": moe_z}


def _gold_on_shards(logits, labels):
    """The gold logits of a ``DTensor`` (B, S, V) on each rank's rows: the
    gather reads whole vocab rows (a sharded vocab is gathered first), and
    runs on the rank's shard, so neither it nor its backward's scatter
    makes a (B, S, V) tensor on every rank."""
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    pl = kernel_placements(logits, (0, 1))
    fn = local_map(lambda lg, lb: lg.gather(-1, lb.long()[..., None])[..., 0],
                   out_placements=list(pl), in_placements=(pl, pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(logits, as_dtensor(labels, mesh))


def cross_entropy_loss(logits, labels, z_loss: float = 1e-4):
    """logits (B,S,V) f32; labels (B,S) int; returns the scalar mean loss
    plus ``z_loss`` times the mean squared log-partition, as the
    reference.  The gold logit is a gather, where the reference uses a
    one-hot reduction for its sharded vocab axis: the values are the same."""
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        gold = _gold_on_shards(logits, labels)
    else:
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse ** 2)
    return loss
