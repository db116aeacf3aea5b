"""Atomic, resumable checkpoints of nested dicts of tensors.

Counterpart of ``repro/checkpoint/checkpointer.py``, in its layout, so
each package restores the other's checkpoint of the same tree:
``<dir>/step_<N:08d>/{manifest.json, arrays.npz}``, one array per leaf
keyed by its path as the reference spells a JAX key path
(``['params']/['layers']/['b0_attn']/['attn']/['wq']``,
``core.tree.path_str``).  A save writes a temporary directory and
renames it, so a crash mid-save never corrupts the latest checkpoint:
``latest_step``/``restore`` pick the newest complete manifest, a
partly written directory is ignored, and ``keep`` bounds the disk used
(the oldest are pruned).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core.tree import flatten_with_path, path_str, unflatten


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> dict:
    return {path_str(p): leaf for p, leaf in flatten_with_path(tree)}


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------

    def save(self, step: int, tree) -> str:
        """Write ``tree`` (tensors on any device, or numpy arrays) as the
        checkpoint of ``step``; returns its directory."""
        arrays = {k: _host_array(v)
                  for k, v in _flatten_with_paths(tree).items()}
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays.keys()),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()
        return final

    def _prune(self):
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------

    def list_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if not os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                continue  # incomplete (crashed) save
            steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None):
        """Restore into the structure of ``template`` (shapes checked):
        ``(tree, step)``.  A tensor leaf of the template comes back as a
        tensor on its device with its dtype; any other leaf as numpy."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        flat = flatten_with_path(template)
        out = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for p, tmpl in flat:
                key = path_str(p)
                arr = data[key]
                want = tuple(tmpl.shape) if hasattr(tmpl, "shape") \
                    else np.shape(tmpl)
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"shape mismatch for {key}: ckpt {arr.shape} vs "
                        f"template {want}")
                if isinstance(tmpl, torch.Tensor):
                    arr = torch.from_numpy(np.array(arr)).to(
                        device=tmpl.device, dtype=tmpl.dtype)
                out.append(arr)
        return unflatten([p for p, _ in flat], out), step
