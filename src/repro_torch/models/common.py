"""Shared model config, and the sharding hooks the port does without.

Counterpart of ``repro/models/common.py``.  ``ArchConfig`` is the
reference's, field for field, so one config describes the same model on
both sides.  The reference annotates activations with logical axes
(``shard``) under a rule table (``sharding_rules``) for GSPMD tensor
parallelism; the port has none — each party is one process on one card
— so both are no-ops kept for the reader who looks for them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # --- attention ---
    rope: str = "rope"           # rope | mrope | none | sinusoidal
    rope_theta: float = 1e4
    qkv_bias: bool = False
    window: int = 0              # sliding-window size; 0 = full attention
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0
    # --- hybrid (RG-LRU / Griffin) ---
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    # --- enc-dec (whisper) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0              # encoder frames (1500 for whisper)
    # --- frontend ---
    frontend: str = "tokens"      # tokens | embeddings (audio/vlm stubs)
    # --- misc ---
    act: str = "silu"             # silu | gelu | geglu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: Any = "float32"
    compute_dtype: Any = "bfloat16"
    remat: bool = True
    #: "full" rematerializes everything; "dots" saves matmul outputs
    #: (less recompute FLOPs, more activation memory) — §Perf knob.
    remat_policy: str = "full"
    #: MoE position-in-expert: "cumsum" ([T,E] scans) or "sort"
    #: (argsort over [T·k] keys — far less HBM traffic) — §Perf knob.
    moe_dispatch: str = "cumsum"
    #: storage dtype of the SSM/LRU scan tree ("float32" | "bfloat16") —
    #: bf16 halves the dominant HBM term of recurrent archs (§Perf).
    scan_dtype: str = "float32"
    # how many trailing layers fall outside the scanned homogeneous stack
    # (RecurrentGemma's 38 = 12×(rec,rec,attn) + 2×rec)
    n_tail_layers: int = 0

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS roofline term)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, st, dtr = self.d_inner, self.ssm_state, self.dt_rank
            per = (d * 2 * di + di * self.ssm_conv
                   + di * (dtr + 2 * st) + dtr * di + 2 * di + di * d
                   + d)
            return emb + self.n_layers * per
        qk = d * self.n_heads * self.d_head + d * self.n_kv_heads * self.d_head * 2
        op = self.n_heads * self.d_head * d
        attn = qk + op
        if self.family == "hybrid":
            w = self.lru_width or d
            rec = (2 * d * w + 4 * w + (2 * w * w + 3 * w) + w * d
                   + 3 * d * self.d_ff + 2 * d)
            pattern = self.block_pattern or ("rec", "rec", "attn")
            n_groups = (self.n_layers - self.n_tail_layers) // len(pattern)
            n_rec = (n_groups * sum(1 for k in pattern if k == "rec")
                     + self.n_tail_layers)
            n_att = n_groups * sum(1 for k in pattern if k == "attn")
            att_layer = attn + 3 * d * self.d_ff + 2 * d
            return emb + n_rec * rec + n_att * att_layer
        if self.n_experts:
            ff = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
        else:
            mult = 3 if self.act in ("silu", "geglu") else 2
            ff = mult * d * self.d_ff
        per = attn + ff + 2 * d
        total = emb + self.n_layers * per
        if self.enc_dec:
            enc_per = attn + (2 * d * self.d_ff) + 2 * d
            cross = attn
            total += self.n_enc_layers * enc_per + self.n_layers * cross
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = self.n_layers * self.n_experts * 3 * d * self.d_ff_expert
        active = self.n_layers * self.top_k * 3 * d * self.d_ff_expert
        return full - all_experts + active


# ---------------------------------------------------------------------------
# Sharding hooks (no tensor parallelism in the port)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def sharding_rules(rules: dict[str, Any] | None):
    """No-op: the port places no activation on a mesh axis."""
    del rules
    yield


def shard(x, *logical_axes: str | None):
    """No-op: returns ``x`` (the reference's GSPMD annotation)."""
    del logical_axes
    return x


def dtype_of(cfg: ArchConfig, which: str) -> torch.dtype:
    name = getattr(cfg, which)
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[str(name)]
