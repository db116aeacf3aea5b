"""The party group: how a process joins it, on which backend and card.

Counterpart of ``repro/launch/mesh.py``.  The reference's parties are
the ``data`` (and ``pod``) axes of a device mesh; the port's are the
ranks of a ``torch.distributed`` process group, one process per party.
Without an initialized group the world is one party — what the
reference runs on one chip (mesh (1, 1)).  The port has no tensor
parallelism: the reference's ``model`` axis has no counterpart.  The
group's size and this process's party id are ``fl.spmd.party_count``
and ``fl.spmd.party_index``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def choose_backend(local_world_size: int, device) -> str:
    """``nccl`` when each rank has a card of its own; ``gloo`` when the
    ranks share one card (NCCL refuses two ranks on one device) or run on
    the CPU.

    ``local_world_size``: the ranks on this node (``torchrun``'s
    ``LOCAL_WORLD_SIZE``), held against this node's cards — over several
    nodes the whole world may well outnumber one node's cards.
    """
    device = torch.device(device)
    if (device.type == "cuda"
            and torch.cuda.device_count() >= local_world_size):
        return "nccl"
    return "gloo"


def rank_device(backend: str, device, local_rank: int) -> torch.device:
    """The device a rank computes on: its own card under NCCL, the one
    shared card (or the CPU) under gloo."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank if backend == "nccl" else 0)


def init_from_env(device) -> dict:
    """Join the party group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``), or stay a world of one when it
    describes none.  Without ``LOCAL_WORLD_SIZE`` every rank is taken
    to be on this node.  Returns ``{"world", "rank", "backend", "device"}``.
    """
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or "RANK" not in os.environ:
        return {"world": 1, "rank": 0, "backend": None,
                "device": torch.device(device)}
    backend = choose_backend(
        int(os.environ.get("LOCAL_WORLD_SIZE", str(world))), device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = rank_device(backend, device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return {"world": dist.get_world_size(), "rank": dist.get_rank(),
            "backend": backend, "device": dev}
