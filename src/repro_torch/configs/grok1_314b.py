"""grok-1-314b — 64L d6144 48H (GQA kv=8) d_ff=32768, MoE 8e top-2.

[hf:xai-org/grok-1; unverified]
"""
import dataclasses
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, d_ff_expert=32768,
    rope="rope", rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=64, vocab=256, n_experts=4, top_k=2, d_ff_expert=64, remat=False)
