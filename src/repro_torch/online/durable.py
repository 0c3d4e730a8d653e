"""Crash-resumable streamed FALKON fits (DESIGN.md §11).

The PyTorch counterpart of ``repro.online.durable``.
``resumable_streamed_fit`` is the out-of-core fit with durability at the
chunk barrier: after every ``ckpt_every``-th chunk the whole solver state
(the normal-equation accumulators, the chunk cursor, the caller's
``torch.Generator`` state and a config hash) goes through the atomic-rename
checkpoints of ``repro_torch.checkpoint``. A fit killed at chunk i restarts
from the last barrier <= i and replays the remaining chunks into the same
bits: the (fp64) accumulators round-trip exactly through ``.npy``,
chunk-order accumulation is deterministic, and the final solve is a pure
function of (H, b, centers, lam, iters). So the resumed alpha equals the
uninterrupted alpha bit for bit, on the card as on the CPU.

A checkpoint written by another configuration (kernel, data shape and
chunking, target shape, centers, weights, lam, iters, tile backend) is
refused with ``ResumeMismatchError``, never blended.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from ..checkpoint import checkpoint_extra, latest_step, restore_checkpoint, save_checkpoint
from ..core import health
from ..core.falkon import FalkonModel
from ..core.gram import BackendLike, Kernel, resolve_backend
from ..stream.store import ChunkStore
from .accumulate import ACC_DTYPE, absorb, solve_accumulators

Tensor = torch.Tensor

#: Checkpoint schema version (the reference's): a mismatch is a refused
#: resume, not a guess.
SCHEMA = 1


class ResumeMismatchError(RuntimeError):
    """A checkpoint's config hash or shapes do not match the live fit."""


def _digest(arr) -> str:
    """SHA-256 of an array's dtype, shape and bytes (host-side)."""
    if isinstance(arr, Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def fit_config_hash(kernel: Kernel, store: ChunkStore, centers, a_diag,
                    lam: float, iters: int, inner_name: str) -> str:
    """The identity of one durable fit: every input that shapes the
    accumulation or the solve."""
    payload = {
        "schema": SCHEMA,
        "kernel": [kernel.name, float(kernel.sigma), float(kernel.kappa_sq)],
        "data": [int(store.shape[0]), int(store.shape[1]), int(store.chunk)],
        "targets": list(store.y.shape),
        "centers": _digest(centers),
        "a_diag": _digest(a_diag),
        "lam": float(lam),
        "iters": int(iters),
        "inner": inner_name,
    }
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()


def resumable_streamed_fit(
    kernel: Kernel,
    x,
    y=None,
    centers: Tensor = None,
    lam: float = 1e-6,
    *,
    a_diag: Tensor | None = None,
    iters: int = 20,
    backend: BackendLike = "stream",
    ckpt_dir: str,
    ckpt_every: int = 4,
    key: torch.Generator | None = None,
) -> FalkonModel:
    """Out-of-core FALKON fit, checkpointed at chunk barriers.

    ``x`` is a ``ChunkStore`` carrying y, or rows with ``y`` given
    separately (a store is built on the rows' device, the card for numpy).
    ``backend`` picks the per-tile Gram backend (``"stream"`` = K1 on the
    card, ``"stream:torch"``; a non-stream spec builds the tiles itself).
    ``key``, if given, is a ``torch.Generator`` whose state rides the
    checkpoint.

    If ``ckpt_dir`` holds a checkpoint, its config hash is checked against
    the live arguments (``ResumeMismatchError`` on a mismatch), (H, b,
    cursor) are restored and only the chunks from the cursor on are
    replayed.
    """
    if isinstance(x, ChunkStore):
        store = x
        if store.y is None:
            raise ValueError("resumable_streamed_fit needs targets; build the "
                             "ChunkStore with y")
    else:
        if y is None:
            raise ValueError("resumable_streamed_fit needs targets y")
        store = ChunkStore(x, y, device=x.device if isinstance(x, Tensor) else "cuda")
    n = store.shape[0]
    dev = store.device
    be = resolve_backend(backend, device=dev, n=n)
    inner = getattr(be, "inner", be)
    centers = torch.as_tensor(centers, dtype=torch.float32).to(dev)
    m = centers.shape[0]
    a_diag = (torch.ones((m,), dtype=torch.float32, device=dev) if a_diag is None
              else torch.as_tensor(a_diag, dtype=torch.float32).to(dev))
    cfg_hash = fit_config_hash(kernel, store, centers, a_diag, lam, iters, inner.name)

    k_shape = tuple(store.y.shape[1:])
    h = torch.zeros((m, m), dtype=ACC_DTYPE, device=dev)
    b = torch.zeros((m,) + k_shape, dtype=ACC_DTYPE, device=dev)
    key_state = (torch.zeros((), dtype=torch.uint8) if key is None else key.get_state())
    cursor = 0

    step0 = latest_step(ckpt_dir)
    if step0 is not None:
        extra = checkpoint_extra(ckpt_dir, step0)
        if extra.get("config_hash") != cfg_hash or extra.get("schema") != SCHEMA:
            raise ResumeMismatchError(
                f"checkpoint under {ckpt_dir!r} (step {step0}) was written "
                "by a different fit configuration (config hash "
                f"{extra.get('config_hash', '?')[:12]}... != {cfg_hash[:12]}...); "
                "refusing to blend incompatible runs; delete the checkpoint "
                "directory to start fresh")
        _, tree = restore_checkpoint(ckpt_dir, {"h": h, "b": b, "key": key_state}, step=step0)
        if tuple(tree["h"].shape) != (m, m) or tuple(tree["b"].shape) != (m,) + k_shape:
            raise ResumeMismatchError(
                f"checkpoint accumulators {tuple(tree['h'].shape)}/"
                f"{tuple(tree['b'].shape)} do not match the live fit "
                f"({(m, m)}/{(m,) + k_shape})")
        h, b, key_state = tree["h"], tree["b"], tree["key"]
        cursor = int(extra["cursor"])
        health.record_event("durable_fit_resume", step=step0, cursor=cursor)

    slices = store.chunk_slices()
    for i in range(cursor, len(slices)):
        sl = slices[i]
        h, b = absorb(kernel, store.x[sl], store.y[sl], centers, h, b, inner=inner,
                      chunk=store.chunk)
        done = i + 1
        if done == len(slices) or done % max(1, ckpt_every) == 0:
            save_checkpoint(ckpt_dir, done, {"h": h, "b": b, "key": key_state},
                            extra={"config_hash": cfg_hash, "schema": SCHEMA,
                                   "cursor": done, "rows": int(sl.stop)})

    alpha, resid = solve_accumulators(kernel, h, b, centers, lam, n, a_diag=a_diag,
                                      iters=iters, backend=inner)
    return FalkonModel(centers=centers, alpha=alpha, kernel=kernel, backend=be,
                       diagnostics=health.SolveDiagnostics(resid),
                       lam=float(lam), n_train=n, a_diag=a_diag)
