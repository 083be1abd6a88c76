"""Atomic, asynchronous checkpoints of a train state.

Port of the JAX package's ``train/checkpoint.py``, in the same on-disk
layout, so that either package restores the other's checkpoints::

  <dir>/step_<N>/
    manifest.json     {"step", "leaves": [{"path", "file", "shape",
                                            "dtype"}]}
    leaf_<i>.npy      one file per leaf, in JAX's flattening order (dict
                      keys sorted, lists in order)

* **atomic publish**: a checkpoint is written to ``step_<N>.tmp`` and
  renamed after its manifest is fsync'd, so a crash mid-write never leaves
  a checkpoint that :func:`latest_steps` lists;
* **async**: :class:`AsyncCheckpointer` copies the state to host memory
  synchronously, then writes it on a thread while training goes on, and
  keeps the ``keep`` newest;
* bf16 leaves are stored as their ``uint16`` bits with ``"dtype":
  "bfloat16"`` in the manifest (numpy has no bf16), as the reference
  stores them.

A state of ``DTensor`` leaves (laid out on a mesh) is saved as its global
arrays: every rank gathers each leaf, rank 0 writes, so the layout on disk
stays the reference's.  ``restore`` places each leaf on ``device``, or with
``shardings`` (a tree of :class:`repro_torch.sharding.NamedSharding`) as a
``DTensor`` of that layout on its mesh, whatever mesh wrote it: the
elastic restore.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import collectives as coll
from repro_torch.device import resolve_device


def _tree_paths(tree_: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) in JAX's flattening order: dict keys sorted."""
    if isinstance(tree_, dict):
        items = [(str(k), tree_[k]) for k in sorted(tree_)]
    elif isinstance(tree_, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree_)]
    else:
        return [(prefix, tree_)]
    out = []
    for k, v in items:
        out += _tree_paths(v, f"{prefix}/{k}" if prefix else k)
    return out


def _rebuild(tree_: Any, leaves: dict, prefix: str = "") -> Any:
    """``tree_``'s structure with each leaf replaced by ``leaves[path]``."""
    def path(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree_, dict):
        return {k: _rebuild(v, leaves, path(k)) for k, v in tree_.items()}
    if isinstance(tree_, (list, tuple)):
        return type(tree_)(_rebuild(v, leaves, path(i))
                           for i, v in enumerate(tree_))
    return leaves[prefix]


def _host(leaf) -> np.ndarray:
    """A leaf as numpy, bf16 as its uint16 bits; returns (array, the
    logical dtype's name)."""
    if torch.is_tensor(leaf):
        t = coll.gather(leaf.detach()).cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save(ckpt_dir: str, state: Any, step: int) -> str:
    """Synchronous atomic checkpoint.  Returns the published path.  Every
    rank of a world calls it (a ``DTensor`` leaf is gathered); rank 0
    writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not coll.is_writer():
        for _, leaf in _tree_paths(state):
            _host(leaf)
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for i, (path, leaf) in enumerate(_tree_paths(state)):
        arr, logical = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        entries.append({"path": path, "file": fname,
                        "shape": list(arr.shape), "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": entries}, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def snapshot(state: Any) -> Any:
    """The state copied to host memory (CPU tensors), structure kept."""
    def copy(leaf):
        if torch.is_tensor(leaf):
            return coll.gather(leaf.detach()).to("cpu", copy=True)
        return np.array(leaf, copy=True)
    return _rebuild(state, {p: copy(l) for p, l in _tree_paths(state)})


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write to disk on a worker
    thread, keep the ``keep`` newest checkpoints."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save_async(self, state: Any, step: int):
        self.wait()
        host_state = snapshot(state)

        def work():
            try:
                save(self.ckpt_dir, host_state, step)
                self._gc()
            except BaseException as e:      # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Block until the pending write is published; re-raise its
        error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in latest_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list[int]:
    """The published steps under ``ckpt_dir``, ascending (an unfinished
    ``.tmp`` is not one)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
                  if name.startswith("step_") and not name.endswith(".tmp"))


def restore(ckpt_dir: str, state_like: Any, *, step: int | None = None,
            device=None, shardings: Any = None) -> tuple[Any, int]:
    """The checkpoint of ``step`` (default: the latest) in the structure of
    ``state_like`` (its leaves may be meta tensors), as tensors on
    ``device`` (``None``: the GPU, raising when there is none); with
    ``shardings``, each leaf as a ``DTensor`` laid out by its sharding
    (each rank keeps its block).  Returns (state, step)."""
    device = resolve_device(device)
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = step if step is not None else steps[-1]
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    sh = dict(_tree_paths(shardings)) if shardings is not None else {}
    leaves = {}
    for name, _ in _tree_paths(state_like):
        e = by_path[name]
        arr = np.load(os.path.join(path, e["file"]))
        if e["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        t = t.to(device)
        if name in sh:
            t = coll.distribute(t, sh[name].spec, sh[name].mesh)
        leaves[name] = t
    return _rebuild(state_like, leaves), manifest["step"]
