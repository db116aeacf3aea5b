"""Model API registry: family -> (init, loss, prefill, cache, decode).

Counterpart of ``repro/models/registry.py`` for the dense, MoE, SSM
and hybrid families: the transformer API's ``init``, ``loss_fn``,
``prefill``, ``init_cache`` and ``decode_step`` (the reference routes
``moe``, ``ssm`` and ``hybrid`` through the same API).  The other
families raise ``NotImplementedError`` (``transformer.check_family``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import transformer
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


def get_api(cfg: ArchConfig) -> ModelApi:
    transformer.check_family(cfg)
    return TRANSFORMER_API
