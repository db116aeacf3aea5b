"""falcon-mamba-7b — 64L d4096 attn-free mamba1, ssm_state=16.

[arXiv:2410.05355; unverified] — d_inner = 2·d = 8192, conv 4,
dt_rank = d/16 = 256, vocab 65024.  Runs long_500k (O(1) state decode).
"""
import dataclasses
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_head=1,
    d_ff=0, vocab=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2, dt_rank=256,
    rope="none",
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, vocab=256, ssm_state=4, dt_rank=8,
    remat=False)
