"""whisper-large-v3 — enc-dec, 32+32L d1280 20H (MHA) d_ff=5120.

[arXiv:2212.04356; unverified] — conv frontend STUB: input_specs
provides post-conv frame embeddings [B, 1500, 1280].  LayerNorm + GELU,
sinusoidal encoder positions, learned decoder positions, tied decoder
embedding, vocab 51866.
"""
import dataclasses
from repro_torch.models.common import ArchConfig

ARCH = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_head=64,
    d_ff=5120, vocab=51866,
    enc_dec=True, n_enc_layers=32, enc_seq=1500,
    rope="none", act="gelu", norm="layernorm", norm_eps=1e-5,
    tie_embeddings=True, frontend="frames",
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=256, enc_seq=16,
    remat=False)
