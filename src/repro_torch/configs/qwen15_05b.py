"""qwen1.5-0.5b — 24L d1024 16H (kv=16, MHA) d_ff=2816 vocab=151936.

[hf:Qwen/Qwen1.5-0.5B; hf] — QKV bias, tied embeddings.
"""
import dataclasses
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=2816, vocab=151936,
    rope="rope", rope_theta=1e4, qkv_bias=True, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=256, remat=False)
