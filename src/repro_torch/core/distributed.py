"""Distributed BLESS / FALKON over a row-sharded dataset.

The PyTorch counterpart of ``repro.core.distributed``. A
``torch.distributed`` process group stands in for the reference's 1-D
``data`` mesh: every rank is called with the whole (replicated) X, keeps
its own slice of the rows (``shard_rows``), and runs the local contraction
on that slice through its inner backend (``backend_for_device``: the CUDA
kernels K2, K7 with a mask, K3 and K4 on the card, ``TorchBackend`` on the
CPU). The (M,) / (M, k) partials are combined with ``all_gather`` and a sum
in rank order, not ``all_reduce``: every rank then holds the same bits, run
after run. Row-parallel outputs (a Gram block, candidate scores, a predict)
are gathered back to (n, .) and sliced to n.

Without an initialized process group ``data_group()`` is None, a world of
one: rank 0, no collective, and every function is the inner backend's.

``ShardedBackend`` checks once per call (``check_replicated``, one small
collective) that every rank holds the same data: ranks that each passed
their own rows would otherwise sum partials of different datasets, or
hang on collectives of different sizes.

A group whose backend is gloo takes host tensors only, so on the card the
partials are staged through host memory for its collectives (one (M, k)
panel per call: a transport choice, not a fallback; the contraction itself
stays on the card).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .backend import Backend, ShardedBackend, backend_for_device
from .falkon import FalkonModel, falkon_fit
from .gram import Kernel

Tensor = torch.Tensor


def data_group():
    """The default process group when one is initialized, else None (a
    world of one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def world(group) -> tuple[int, int]:
    """(rank, world size) of this process in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _rows_per_rank(group, n: int) -> int:
    return -(-n // world(group)[1])


def shard_rows(group, x: Tensor) -> Tensor:
    """This rank's rows of the replicated (n, ...) ``x``; n is padded with
    zero rows up to a multiple of the world size, so every rank holds the
    same count and the pad rows sit at the end of the last ranks' slices."""
    rank, size = world(group)
    if size == 1:
        return x
    per = _rows_per_rank(group, x.shape[0])
    lo, hi = rank * per, (rank + 1) * per
    local = x[lo:hi]
    if local.shape[0] < per:
        pad = x.new_zeros((per - local.shape[0],) + tuple(x.shape[1:]))
        local = torch.cat([local, pad])
    return local


def _valid(group, local: Tensor, n_valid: int) -> Tensor:
    """The rows of ``local`` below ``n_valid`` in the global numbering: the
    reference's ``rows < n_valid`` exclusion, as a slice (the pad rows are
    the last ones)."""
    rank, _ = world(group)
    per = local.shape[0]
    return local[: max(0, min(per, n_valid - rank * per))]


def _all_gather(group, t: Tensor) -> list[Tensor]:
    """Every rank's ``t``, in rank order; one collective."""
    if group is None:
        return [t]
    ShardedBackend.collectives += 1
    src = t.detach().contiguous()
    # gloo takes host tensors: stage the card's partial through host memory
    staged = src.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world(group)[1])]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if staged else parts


def sum_ranks(group, partial: Tensor) -> Tensor:
    """Σ over ranks of ``partial``, added in rank order (the same bits on
    every rank)."""
    parts = _all_gather(group, partial)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def gather_rows(group, local: Tensor, n_valid: int) -> Tensor:
    """Row-parallel outputs gathered back to (n_valid, ...)."""
    return torch.cat(_all_gather(group, local))[:n_valid]


#: modulus of the fingerprint's sums (a prime below 2^31: the weighted sums
#: of up to 2^32 rows stay inside int64)
_FP_MOD = (1 << 31) - 1


def _fingerprint(t: Tensor | None, device: torch.device) -> Tensor:
    """(rows, elements, bit sum, row-weighted bit sum) of ``t`` as int64 on
    ``device``; (-1, -1, -1, -1) for None. The sums run over the bits read
    as integers, modulo ``_FP_MOD``, so ranks holding the same tensor agree
    whatever their reduction order, while a changed value or a reordered
    row changes them."""
    if t is None:
        return torch.full((4,), -1, dtype=torch.int64, device=device)
    t = t.detach().contiguous()
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    rows_n = t.shape[0] if t.ndim else 1
    bits = t.view(ints).reshape(rows_n, t.numel() // rows_n if rows_n else 1)
    rows = torch.remainder(torch.sum(bits, dim=1, dtype=torch.int64), _FP_MOD)
    w = torch.arange(rows_n, device=rows.device) % 1021 + 1
    sums = torch.stack([rows.sum(), torch.remainder(rows * w, _FP_MOD).sum()])
    return torch.cat([rows.new_tensor([rows_n, t.numel()]), sums]).to(device)


def check_replicated(group, *tensors: Tensor | None) -> None:
    """Raise ``ValueError`` on every rank unless every rank of ``group``
    holds the same ``tensors``: one all_gather of a fixed-size fingerprint,
    none in a world of one. The sharded functions take the whole,
    replicated data on every rank, as the reference's SPMD caller does."""
    if world(group)[1] == 1:
        return
    device = next(t.device for t in tensors if t is not None)
    parts = _all_gather(group, torch.cat([_fingerprint(t, device) for t in tensors]))
    differ = [r for r, p in enumerate(parts) if not torch.equal(p, parts[0])]
    if differ:
        raise ValueError(
            f"ShardedBackend needs the same whole data on every rank, but ranks {differ} "
            "hold other rows or values than rank 0; pass every rank the full X, y and "
            "centers (each rank keeps its own slice), or fit each rank's own data with "
            "the device's backend")


def _inner(inner: Backend | None, x: Tensor) -> Backend:
    return inner if inner is not None else backend_for_device(x.device)


def dist_knm_quadratic(group, kernel: Kernel, x_local: Tensor, z: Tensor, n_valid: int, *,
                       mask: Tensor | None = None,
                       inner: Backend | None = None) -> Callable[[Tensor], Tensor]:
    """v -> K_nM^T (K_nM v) with X row-sharded (``x_local`` from
    ``shard_rows``); ``v`` (M,) or an (M, k) panel, replicated. ``mask``
    ((n,) or (n, k) per-column row weights, row-sharded like X) gives
    column j K_nM^T diag(m_j) K_nM v_j. Each rank contracts its valid rows
    with the inner backend's quadratic op; the partials are summed in rank
    order."""
    xv = _valid(group, x_local, n_valid)
    mv = None if mask is None else _valid(group, mask, n_valid)
    local = _inner(inner, x_local).knm_quadratic(kernel, xv, z, mask=mv) if xv.shape[0] else None

    def op(v: Tensor) -> Tensor:
        part = local(v) if local is not None else v.new_zeros((z.shape[0],) + tuple(v.shape[1:]))
        return sum_ranks(group, part)

    return op


def dist_knm_t(group, kernel: Kernel, x_local: Tensor, y_local: Tensor, z: Tensor,
               n_valid: int, *, inner: Backend | None = None) -> Tensor:
    """K_nM^T y with X, y row-sharded; ``y`` (n,) -> (M,), (n, k) -> (M, k)."""
    xv = _valid(group, x_local, n_valid)
    if xv.shape[0]:
        part = _inner(inner, x_local).knm_t(kernel, xv, z, y_local[: xv.shape[0]])
    else:
        part = y_local.new_zeros((z.shape[0],) + tuple(y_local.shape[1:]))
    return sum_ranks(group, part)


def dist_knm_matvec(group, kernel: Kernel, x_local: Tensor, z: Tensor, v: Tensor,
                    n_valid: int, *, inner: Backend | None = None) -> Tensor:
    """K_nM v with X row-sharded: the predict contraction, (M,) or (M, k)
    ``v``. Row-parallel: each rank's rows are gathered back, pad rows
    sliced off."""
    local = _inner(inner, x_local).knm_matvec(kernel, x_local, z, v)
    return gather_rows(group, local, n_valid)


def falkon_fit_distributed(group, kernel: Kernel, x: Tensor, y: Tensor, centers: Tensor,
                           lam: float, *, a_diag: Tensor | None = None, iters: int = 20,
                           inner: Backend | None = None) -> FalkonModel:
    """Data-parallel FALKON: ``falkon_fit`` through a ``ShardedBackend`` on
    ``group`` (X and y whole on every rank; the (M, .) state replicated)."""
    return falkon_fit(kernel, x, y, centers, lam, a_diag=a_diag, iters=iters,
                      backend=ShardedBackend(group=group, inner=inner))
