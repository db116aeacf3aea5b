"""Parameter layout policy at tensor parallelism 1.

Counterpart of ``repro/launch/sharding.py`` (:73-120) for the port,
which has no ``model`` axis: one policy maps every parameter leaf to the
dim it is split along among the parties (ZeRO / MPC-FSDP), from its
path and shape:

* the ``model`` axis (size 1 here) still claims a dim first, as in the
  reference's (n, 1) mesh: the largest, or the vocab dim of an
  embedding or LM head;
* the party axis takes the largest remaining dim divisible by the party
  count; a leaf with none (a norm scale, a bias: one dim left after the
  model axis) stays whole on every party.

Leaves under ``layers`` are layer-stacked: dim 0 is the scan axis and is
never split.  ``path`` is spelled as the reference spells it
(``core.tree.path_str``; a group leaf as ``layers/['b0_attn']/...``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.models.common import ArchConfig

#: device memory of the reference's chip, which its layout rule assumes
REFERENCE_HBM_BYTES = 16e9

#: the axis names of the reference's mesh: ``model`` (size 1 here) and
#: the party axis
MODEL, PARTY = "model", "data"


def _is_stacked(path: str) -> bool:
    return "layers" in path or path.startswith("tail")


def _pick_dim(shape, divisor: int, *, skip: set[int], prefer=None):
    """Largest dim divisible by ``divisor`` (prefer listed dims first)."""
    order = list(prefer or []) + sorted(
        range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if i in skip or i >= len(shape):
            continue
        if shape[i] % divisor == 0 and shape[i] >= divisor:
            return i
    return None


def param_spec(path: str, shape, n_party: int, fsdp: bool) -> tuple:
    """The reference's ``PartitionSpec`` of a leaf on an (n_party, 1) mesh
    as a tuple: ``"model"``, ``"data"`` (the party axis) or ``None`` per
    dim."""
    spec: list = [None] * len(shape)
    skip: set[int] = {0} if _is_stacked(path) else set()
    prefer = None
    if "embed" in path or "lm_head" in path or "dec_pos" in path:
        # vocab/table rows on the model axis (Megatron vocab-parallel)
        prefer = [int(np.argmax(shape))]
    if "router" in path:
        prefer = []
    mdim = _pick_dim(shape, 1, skip=skip, prefer=prefer)
    if mdim is not None and len(shape) - len(skip) >= 1:
        spec[mdim] = MODEL
        skip = skip | {mdim}
    if fsdp:
        pdim = _pick_dim(shape, n_party, skip=skip)
        if pdim is not None:
            spec[pdim] = PARTY
    return tuple(spec)


def party_dim(path: str, shape, n_party: int) -> int | None:
    """The dim of a leaf of shape ``shape`` split among ``n_party``
    parties under MPC-FSDP, or ``None`` (kept whole)."""
    spec = param_spec(path, shape, n_party, fsdp=True)
    return spec.index(PARTY) if PARTY in spec else None


def needs_fsdp(cfg: ArchConfig,
               hbm_bytes: float = REFERENCE_HBM_BYTES) -> bool:
    """Replicated fp32 params + Adam moments must fit 60 % of
    ``hbm_bytes`` (the reference chip's 16 GB by default, so the port
    picks the layout the reference picks)."""
    return cfg.param_count() * (4 + 8) > 0.6 * hbm_bytes
