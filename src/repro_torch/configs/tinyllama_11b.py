"""tinyllama-1.1b — 22L d2048 32H (GQA kv=4) d_ff=5632 vocab=32000.

[arXiv:2401.02385; hf] — llama2-arch small.
"""
import dataclasses
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_head=64,
    d_ff=5632, vocab=32000,
    rope="rope", rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, remat=False)
