"""Manifest-based checkpoints with atomic renames and async writes.

The PyTorch counterpart of ``repro.checkpoint.ckpt``, with the same format
on disk, so each package reads the other's checkpoints:

    <dir>/step_<N:08d>/manifest.json + one leaf_<i:05d>.npy per leaf

The manifest maps each leaf's key to ``file`` / ``shape`` / ``dtype`` /
``stored_dtype``. Keys are the leaf's tree path joined by ``"/"``, spelled
as JAX's tree paths are: dict keys (visited in sorted order) as themselves,
sequence items as ``[i]``, NamedTuple fields as ``.name``. bf16 leaves go
to disk as their uint16 bit pattern (``stored_dtype`` "uint16") and come
back bit for bit.

Writes go to a ``.tmp`` directory that is renamed into place, so
``latest_step`` only ever sees complete checkpoints. Every filesystem step
of ``save_checkpoint`` hosts the ``ckpt.torn_write`` injection point
(``repro_torch.testing.faults``); the stage names, in write order, are
``CRASH_STAGES``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..testing import faults

_SEP = "/"

#: ``save_checkpoint`` crash-point stages, in the order they are hit (the
#: ``leaf`` stage fires once per leaf). ``pre_rename`` is the torn window:
#: temp dir complete, manifest written, final rename not yet issued.
CRASH_STAGES = ("post_tmp_dir", "leaf", "pre_rename", "post_rename")


def _crash_point(stage: str) -> None:
    """``ckpt.torn_write`` hook: one dict-emptiness check when quiet."""
    if faults.active():
        faults.raise_if("ckpt.torn_write", tag=stage)


def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _leaves(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in JAX's tree order: dicts by sorted key, lists and
    tuples by index, NamedTuples by field; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _leaves(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [pl for f in tree._fields for pl in _leaves(getattr(tree, f), path + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _leaves(v, path + (f"[{i}]",))]
    return [(path, tree)]


def _rebuild(template: Any, values: Iterator) -> Any:
    """``template``'s structure with its leaves taken in order from ``values``."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], values) for k in sorted(template)}
        return {k: out[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*[_rebuild(getattr(template, f), values)
                                for f in template._fields])
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, values) for v in template)
    return next(values)


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """(array as stored on disk, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    extra: Optional[dict] = None) -> str:
    """Write ``tree`` (tensors, numpy arrays or numbers in dicts, lists,
    tuples and NamedTuples) as ``step``; returns the checkpoint's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _crash_point("post_tmp_dir")
    flat = {_SEP.join(p): leaf for p, leaf in _leaves(tree)}
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        fname = f"leaf_{i:05d}.npy"
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, fname), arr)
        _crash_point("leaf")
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype, "stored_dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    _crash_point("pre_rename")
    os.rename(tmp, final)
    _crash_point("post_rename")
    return final


def restore_checkpoint(ckpt_dir: str, template: Any, *,
                       step: Optional[int] = None) -> tuple[int, Any]:
    """Restore into the structure of ``template``; returns (step, tree).

    Every leaf comes back as a tensor of its stored dtype, on the device of
    the template's leaf when that is a tensor, else on the CPU.
    """
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for pth, leaf in _leaves(template):
        key = _SEP.join(pth)
        rec = manifest["leaves"][key]
        arr = np.load(os.path.join(path, rec["file"]))
        stored = rec.get("stored_dtype", str(arr.dtype))
        if str(arr.dtype) != stored:
            raise ValueError(
                f"leaf {key!r}: on-disk dtype {arr.dtype} != recorded "
                f"stored_dtype {stored!r}; checkpoint corrupt or written "
                "by an incompatible version")
        if rec["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(leaf.device) if isinstance(leaf, torch.Tensor) else t)
    return step, _rebuild(template, iter(out))


def checkpoint_extra(ckpt_dir: str, step: int) -> dict:
    """The ``extra`` metadata of a saved checkpoint, without loading any
    leaves (resumable fits check the config hash first)."""
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f).get("extra", {})


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step (None when there is none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


class AsyncCheckpointer:
    """Overlaps checkpoint IO with the caller's next steps (one write in
    flight). ``save`` snapshots every tensor to host memory before its
    thread starts, so a later in-place update of a saved tensor never
    reaches a checkpoint that is still being written."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None) -> None:
        """Snapshot ``tree`` now and write it as ``step`` in a thread."""
        self.wait()
        values = iter([leaf.detach().cpu().clone() if isinstance(leaf, torch.Tensor)
                       else np.array(leaf) for _, leaf in _leaves(tree)])
        host_tree = _rebuild(tree, values)

        def _work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra=extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; re-raises its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _gc(self) -> None:
        for s in _steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
