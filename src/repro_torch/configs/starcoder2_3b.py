"""starcoder2-3b — 30L d3072 24H (GQA kv=2) d_ff=12288 vocab=49152.

[arXiv:2402.19173; hf] — GQA + RoPE, LayerNorm, gelu MLP, qkv bias,
sliding window 4096.
"""
import dataclasses
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_head=128,
    d_ff=12288, vocab=49152,
    rope="rope", rope_theta=1e6, qkv_bias=True,
    act="gelu", norm="layernorm", norm_eps=1e-5, window=4096,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, window=8, remat=False)
