"""Checkpointing: atomic save/restore of nested dicts of tensors + an async
writer.  The counterpart of ``repro.training.checkpoint``, in its on-disk
layout, so either package restores what the other wrote:
``step_%08d/leaf_%05d.npy`` (leaves in sorted-key order inside a dict
and index order inside a list, as ``jax.tree_util`` flattens them),
``meta.json`` and the ``COMMITTED`` marker.

Fault-tolerance contract: a checkpoint directory is only advertised (via the
``COMMITTED`` marker) after every array has been written and fsynced, so a
node failure mid-save can never leave a half checkpoint that restore would
pick up.  ``latest_step`` skips uncommitted directories, giving
checkpoint/restart semantics on preemption.  ``AsyncCheckpointer`` moves the
serialization off the training thread (device-to-host copy happens at call
time; disk IO overlaps the next step).

bfloat16 leaves are refused: numpy has no bfloat16, and the training state
is float32 (the reference trains in float32).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.training.pytree import children, leaves, tree_map, unflatten

_MARKER = "COMMITTED"


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("checkpoint: bfloat16 leaves are not saved; "
                            "keep the training state in float32")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _paths(tree, prefix: str = "") -> list[str]:
    """Each leaf's path, in flattening order: ``/layers/0/msg/1/w``."""
    kids = children(tree)
    if kids is None:
        return [prefix or "/"]
    return [p for key, child in kids
            for p in _paths(child, f"{prefix}/{key}")]


def save(ckpt_dir: str | Path, step: int, tree) -> Path:
    """Atomic synchronous checkpoint."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = [leaf if isinstance(leaf, np.ndarray) else _to_host(leaf)
            for leaf in leaves(tree)]
    for i, leaf in enumerate(flat):
        np.save(tmp / f"leaf_{i:05d}.npy", leaf)
    (tmp / "meta.json").write_text(json.dumps({
        "step": step, "n_leaves": len(flat), "paths": _paths(tree)}))
    with open(tmp / _MARKER, "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / _MARKER).exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def _like(arr: np.ndarray, template, path: str):
    """The loaded array as ``template`` holds it: a tensor on its device
    (with its ``requires_grad``), else the array."""
    if not isinstance(template, torch.Tensor):
        return arr
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {path}: shape {arr.shape}, "
                         f"expected {tuple(template.shape)}")
    t = torch.from_numpy(arr)
    if t.dtype != template.dtype:
        raise ValueError(f"checkpoint leaf {path}: dtype {t.dtype}, "
                         f"expected {template.dtype}")
    return t.to(template.device).requires_grad_(template.requires_grad)


def restore(ckpt_dir: str | Path, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like`` (shape/dtype template):
    ``(tree, step)``, each tensor leaf a new tensor on its template's
    device.  A checkpoint of another shape, leaf count or dtype raises."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    if not (d / _MARKER).exists():
        raise FileNotFoundError(f"checkpoint {d} not committed")
    flat = leaves(tree_like)
    n_saved = json.loads((d / "meta.json").read_text())["n_leaves"]
    if n_saved != len(flat):
        raise ValueError(f"checkpoint {d} holds {n_saved} leaves, the "
                         f"tree {len(flat)}")
    loaded = [_like(np.load(d / f"leaf_{i:05d}.npy"), t, p)
              for i, (t, p) in enumerate(zip(flat, _paths(tree_like)))]
    return unflatten(tree_like, loaded), step


def prune(ckpt_dir: str | Path, keep: int = 3) -> None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return
    committed = sorted(d for d in ckpt_dir.iterdir()
                       if d.name.startswith("step_")
                       and (d / _MARKER).exists())
    for d in committed[:-keep]:
        shutil.rmtree(d)


class AsyncCheckpointer:
    """Overlaps checkpoint IO with training (one in-flight save).  A save
    that failed in its thread raises from the next ``save`` or ``wait``."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.saved_steps: list[int] = []

    def save(self, step: int, tree) -> None:
        self.wait()
        # device->host copy now; disk IO in the background
        host_tree = tree_map(_to_host, tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree)
                prune(self.ckpt_dir, self.keep)
                self.saved_steps.append(step)
            except Exception as e:      # re-raised on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
