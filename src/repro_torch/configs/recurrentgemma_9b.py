"""recurrentgemma-9b — 38L d4096 16H (MQA kv=1) d_ff=12288.

[arXiv:2402.19427; unverified] — Griffin: repeating (rec, rec,
local-attn) triads (12 triads + 2 tail recurrent layers), RG-LRU width
4096, local attention window 2048, GeGLU, vocab 256000.
Runs long_500k (ring-buffer window cache + O(1) recurrent state).
"""
import dataclasses
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_head=256,
    d_ff=12288, vocab=256000,
    block_pattern=("rec", "rec", "attn"), n_tail_layers=2,
    lru_width=4096, window=2048,
    rope="rope", rope_theta=1e4, act="geglu",
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=4, n_tail_layers=1, d_model=64, n_heads=4,
    n_kv_heads=1, d_head=16, d_ff=128, vocab=256, lru_width=64,
    window=8, remat=False)
