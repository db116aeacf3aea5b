"""qwen2-vl-2b — 28L d1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

[arXiv:2409.12191; hf] — M-RoPE (3-section rotary over t/h/w position
streams; text streams coincide), dynamic-resolution vision frontend
STUB: input_specs provides precomputed patch/text embeddings
[B, S, 1536].  QKV bias, tied embeddings (2B).
"""
import dataclasses
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab=151936,
    rope="mrope", rope_theta=1e6, qkv_bias=True, tie_embeddings=True,
    frontend="embeddings",
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, remat=False)
