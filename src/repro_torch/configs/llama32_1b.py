"""llama3.2-1b — 16L d2048 32H (GQA kv=8) d_ff=8192 vocab=128256.

[hf:meta-llama/Llama-3.2-1B; unverified] — tied embeddings, rope 5e5.
"""
import dataclasses
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
    d_ff=8192, vocab=128256,
    rope="rope", rope_theta=5e5, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, remat=False)
