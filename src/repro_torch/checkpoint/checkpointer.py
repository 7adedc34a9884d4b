"""Atomic, optionally asynchronous checkpointing of the port, in the JAX
``Checkpointer``'s layout (``repro.checkpoint.checkpointer``), so each
package reads the other's steps:

    <dir>/step_<n>.tmp/  ->  atomic rename  ->  <dir>/step_<n>/
        arrays.npz   leaves keyed by JAX's tree path strings
                     (``params/...``, ``opt/.step``, ``opt/.m/...``;
                     :func:`repro_torch.tree.flatten_with_paths`)
        meta.json    {"step", "time", "keys" (sorted)}
    <dir>/LATEST     the last committed step

A bf16 tensor is written as JAX writes an ``ml_dtypes`` bfloat16 array: a
2-byte void payload (``|V2`` once loaded), its bits unchanged; it is read
back by its bits (:func:`repro_torch.models.weights.tensor_from_numpy`).
An asynchronous save copies every leaf to the host before its writer
thread starts, so the caller may update its tensors at once.  The last
``keep`` steps are kept.  ``restore(..., shardings=)`` restores across
meshes (``checkpointer.py:101-117``): each rank keeps its own slice of
every leaf, as the placement's spec cuts it on its mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.weights import tensor_from_numpy
from repro_torch.tree import flatten_with_paths, tree_map, unflatten_like


def to_numpy(leaf) -> np.ndarray:
    """A host copy of a leaf, never a view of it: a tensor's values (bf16
    as its 2-byte payload), a number or an array as numpy makes it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.array(leaf)


def _like(arr: np.ndarray, ref):
    """``arr`` as a leaf of ``ref``'s kind: a tensor on ``ref``'s device
    in its dtype, a Python number, or a numpy array of its dtype."""
    if isinstance(ref, torch.Tensor):
        dev = "cpu" if ref.device.type == "meta" else ref.device
        return tensor_from_numpy(arr, copy=False).to(device=dev,
                                                     dtype=ref.dtype)
    if isinstance(ref, (bool, int, float)):
        return type(ref)(arr)
    return np.asarray(arr).astype(np.asarray(ref).dtype)


class Checkpointer:
    def __init__(self, directory: str, *, async_save: bool = False,
                 keep: int = 3):
        self.dir = directory
        self.async_save = async_save
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any):
        host = tree_map(to_numpy, tree)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree: Any):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        leaves = flatten_with_paths(host_tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **leaves)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "keys": sorted(leaves)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic commit
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Step ``step`` (default the latest) in ``like``'s structure,
        each leaf on ``like``'s device and in its dtype.  Raises
        ``ValueError`` if the step lacks a leaf of ``like`` or stores one
        at another shape (a checkpoint of another config).  With
        ``shardings`` (a tree of ``core.sharding.NamedSharding`` of
        ``like``'s structure, as ``core.broadcast.placement_shardings``
        gives it for a mesh and a policy) each leaf of ``like`` is the
        whole leaf, and this rank gets its slice of it, on its mesh's
        device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}", "arrays.npz")
        refs = flatten_with_paths(like)
        with np.load(path) as data:
            missing = sorted(set(refs) - set(data.files))
            if missing:
                raise ValueError(f"{path} has no {missing[:3]} (of "
                                 f"{len(missing)} leaves missing)")
            leaves = {}
            for key, ref in refs.items():
                arr = data[key]
                if arr.shape != tuple(np.shape(ref)):
                    raise ValueError(
                        f"{path}: {key} is stored at {arr.shape}, not "
                        f"{tuple(np.shape(ref))}")
                leaves[key] = _like(arr, ref)
        tree = unflatten_like(like, leaves)
        if shardings is not None:
            tree = tree_map(lambda t, s: s.local_slice(
                t.to(s.mesh.device)).contiguous(), tree, shardings)
        return tree
