"""Atomic, async checkpointing in the reference's on-disk layout.

Port of :mod:`repro.distributed.checkpoint`.  Layout, the same as the
reference's:

    <dir>/step_<N>/
        manifest.json        tree structure, shapes, dtypes, step
        leaf_00000.npy ...   one file per leaf, in ``jax.tree.flatten``'s
                             order (:mod:`repro_torch.training.pytree`)

bfloat16 leaves are written as numpy ``V2`` (their raw 16 bits) and read
back the same way, as numpy stores the reference's bf16 arrays; no
``ml_dtypes`` is needed.  So a checkpoint of either package restores in
the other.

* **atomic commit** — written to ``step_<N>.tmp``, then renamed: a crash
  mid-save never corrupts the latest checkpoint;
* **async** — :class:`AsyncCheckpointer` snapshots to host memory
  synchronously and writes in a background thread;
* **elastic** — ``restore(..., shardings=)`` places each leaf on a
  ``DeviceMesh`` with the placements of
  :func:`repro_torch.distributed.sharding.named` (``distribute_tensor``),
  whatever mesh wrote the checkpoint: a ``DTensor`` is saved whole
  (``full_tensor``), so the files are the reference's layout either way.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.training import pytree

PyTree = Any


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as ``V2`` raw bits."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):  # gathered whole (a collective)
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype.kind == "V" else str(arr.dtype)


def save(tree: PyTree, directory: str, step: int) -> str:
    """Synchronous atomic save.  Returns the committed path.  A tree that
    holds ``DTensor``s is saved by every rank of their mesh together: each
    leaf is gathered whole on every rank, rank 0 writes, and all wait for
    the commit."""
    flat, structure = pytree.flatten(tree)
    shared = any(_is_dtensor(leaf) for leaf in flat)
    arrs = [_to_numpy(leaf) for leaf in flat]
    final = os.path.join(directory, f"step_{step:08d}")
    if not shared or torch.distributed.get_rank() == 0:
        _write(arrs, repr(structure), directory, final, step)
    if shared:
        torch.distributed.barrier()
    return final


def _is_dtensor(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and hasattr(leaf, "full_tensor")


def _write(arrs, treedef: str, directory: str, final: str,
           step: int) -> None:
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": treedef, "leaves": []}
    for i, arr in enumerate(arrs):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"file": fname, "shape": list(arr.shape),
                                   "dtype": _dtype_name(arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _gc(directory, keep=3)


class AsyncCheckpointer:
    """Snapshot-now, write-later checkpointing."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save_async(self, tree: PyTree, directory: str, step: int) -> None:
        self.wait()
        host_tree = pytree.tree_map(_to_numpy_copy, tree)  # the snapshot

        def run():
            try:
                self.last_path = save(host_tree, directory, step)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _to_numpy_copy(leaf) -> np.ndarray:
    """A snapshot that later updates of ``leaf`` cannot reach (on the CPU
    a tensor's ``numpy()`` shares its memory)."""
    return np.array(_to_numpy(leaf), copy=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, like) -> torch.Tensor:
    if arr.dtype.kind == "V":  # bfloat16's raw bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def restore(template: PyTree, directory: str, step: Optional[int] = None,
            shardings: Optional[PyTree] = None) -> PyTree:
    """Restore into the structure of ``template``, each leaf in the file's
    type.  Without ``shardings`` a leaf goes to the device of the
    template's leaf.  With ``shardings`` (a tree matching ``template`` of
    what :func:`repro_torch.distributed.sharding.named` returns, or one
    such value for every leaf) each leaf becomes a ``DTensor`` placed on
    its mesh with ``distribute_tensor``: the elastic path, onto a mesh
    other than the one that saved it.  Every rank of the mesh calls it."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_t, structure = pytree.flatten(template)
    if len(flat_t) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"template has {len(flat_t)}")
    if shardings is None:
        flat_s = [None] * len(flat_t)
    elif hasattr(shardings, "placements"):  # one sharding for every leaf
        flat_s = [shardings] * len(flat_t)
    else:
        flat_s = pytree.flatten_up_to(structure, shardings)
    out = []
    for t_leaf, meta, sh in zip(flat_t, manifest["leaves"], flat_s):
        arr = np.load(os.path.join(path, meta["file"]))
        if sh is None:
            out.append(_from_numpy(arr, t_leaf))
        else:
            out.append(sh.place(_from_numpy(arr, None)))
    return pytree.unflatten(structure, out)


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
