"""Architecture configuration for the model zoo.

One `ArchConfig` covers every assigned architecture family: dense decoder
transformers (GQA/RoPE/sliding-window/qk-norm/squared-ReLU), MoE, RWKV6,
hybrid attention+SSM (Hymba), encoder-decoder (Seamless) and modality-stub
backbones (InternVL, Seamless audio).  `src/repro_torch/configs/<id>.py` files
instantiate the exact published configs; `reduced()` derives the smoke-test
versions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0        # qwen2-moe: shared experts (always-on)
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "rwkv6"              # "rwkv6" | "mamba"
    head_dim: int = 64               # rwkv6 head size
    state_dim: int = 16              # mamba state per channel (hymba ssm_state)
    expand: int = 2                  # mamba inner expansion
    conv_dim: int = 4                # mamba depthwise conv width


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default: d_model // n_heads
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    mlp: str = "swiglu"              # swiglu | geglu | gelu | relu2
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # local/global attention pattern (gemma3): window size for local layers,
    # one global layer every `global_every` layers (0 = all global).
    sliding_window: int = 0
    global_every: int = 0
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (seamless): encoder layer count; frontend stub kind
    n_encoder_layers: int = 0
    frontend: Optional[str] = None   # "audio" | "vision" | None
    n_frontend_tokens: int = 0       # patches / frames provided by the stub
    # ------------------------------------------------------------------
    source: str = ""                 # provenance note ([arXiv/hf; tier])

    # -- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §4)."""
        return (self.family in ("ssm", "hybrid")
                or (self.sliding_window > 0 and self.global_every > 0))

    @property
    def layer_group(self) -> int:
        """Layers per scan group (local/global patterns repeat every
        `global_every`; uniform stacks scan layer-by-layer)."""
        return self.global_every if self.global_every > 1 else 1

    # -- parameter counting (for roofline MODEL_FLOPS) --------------------
    def param_count(self, active_only: bool = False) -> int:
        d, ff, hd = self.d_model, self.d_ff, self.hd
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
        o = self.n_heads * hd * d
        attn = qkv + o
        gates = 3 if self.mlp in ("swiglu", "geglu") else 2
        if self.moe:
            e = self.moe
            ff_all = e.n_experts * gates * d * e.d_ff_expert + d * e.n_experts
            ff_act = e.top_k * gates * d * e.d_ff_expert + d * e.n_experts
            if e.n_shared_experts:
                shared = gates * d * e.d_ff_expert * e.n_shared_experts
                ff_all += shared
                ff_act += shared
        else:
            ff_all = ff_act = gates * d * ff
        if self.family == "ssm":                       # rwkv6 time+channel mix
            attn = 5 * d * d + d * d // 2              # r,k,v,g,o + lora/decay
            ff_all = ff_act = 2 * d * self.d_ff
        if self.family == "hybrid" and self.ssm:
            inner = self.ssm.expand * d
            attn += 2 * d * inner + inner * (2 * self.ssm.state_dim + 1)
        per_layer = attn + (ff_act if active_only else ff_all)
        total = self.n_layers * per_layer
        total += self.n_encoder_layers * (attn + gates * d * ff)
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(total)

    # -- reduced config for CPU smoke tests -------------------------------
    def reduced(self) -> "ArchConfig":
        changes = dict(
            n_layers=max(2, self.layer_group),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 // max(1, self.q_groups)),
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            sliding_window=16 if self.sliding_window else 0,
            n_frontend_tokens=4 if self.n_frontend_tokens else 0,
        )
        if self.moe:
            # capacity_factor=n_experts -> cap == S*k: no token drops, so
            # decode matches the full forward exactly in the smoke tests
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=min(8, self.moe.n_experts),
                top_k=min(2, self.moe.top_k), d_ff_expert=32,
                n_shared_experts=min(1, self.moe.n_shared_experts),
                capacity_factor=float(min(8, self.moe.n_experts)))
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, head_dim=16, state_dim=4)
        return dataclasses.replace(self, **changes)


# shape cells assigned to every architecture (system prompt)
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
