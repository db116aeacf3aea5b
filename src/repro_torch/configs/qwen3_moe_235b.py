"""qwen3-moe-235b-a22b — 94L d4096 64H (GQA kv=4) MoE 128e top-8.

[hf:Qwen/Qwen3-235B-A22B family; assignment spec verbatim]
Expert FF width 1536 (the assignment's d_ff), vocab 151936.
"""
import dataclasses
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab=151936,
    n_experts=128, top_k=8, d_ff_expert=1536,
    rope="rope", rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=32, vocab=256, n_experts=4, top_k=2, d_ff_expert=32, remat=False)
