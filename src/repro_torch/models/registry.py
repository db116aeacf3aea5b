"""Model API registry: family -> (init, loss, prefill, cache, decode).

Counterpart of ``repro/models/registry.py``: the transformer API
(``init``, ``loss_fn``, ``prefill``, ``init_cache``, ``decode_step``)
for the decoder-only families (dense, MoE, SSM, hybrid; the reference
routes them all through it) and the enc-dec API (``models/encdec.py``),
chosen by ``cfg.enc_dec`` as the reference chooses.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import encdec, transformer
from .common import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Callable
    loss_fn: Callable
    prefill: Callable
    init_cache: Callable
    decode_step: Callable


def _tf_init_cache(params, cfg, batch, kv_len, **kw):
    """The cache on the parameters' device unless ``device=`` says."""
    kw.setdefault("device", params["embed"]["table"].device)
    return transformer.init_cache(cfg, batch, kv_len, **kw)


TRANSFORMER_API = ModelApi(
    init=transformer.init,
    loss_fn=transformer.loss_fn,
    prefill=transformer.prefill,
    init_cache=_tf_init_cache,
    decode_step=transformer.decode_step,
)

ENCDEC_API = ModelApi(
    init=encdec.init,
    loss_fn=encdec.loss_fn,
    prefill=encdec.prefill,
    init_cache=encdec.init_cache,
    decode_step=encdec.decode_step,
)


def get_api(cfg: ArchConfig) -> ModelApi:
    return ENCDEC_API if cfg.enc_dec else TRANSFORMER_API
