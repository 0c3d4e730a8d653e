"""BLESS (Alg. 1) and BLESS-R (Alg. 2) — bottom-up leverage score sampling.

The PyTorch counterpart of ``repro.core.bless``. The ladder runs on the
host (H ~ log(lam0/lam)/log q levels); each level is two plain functions on
tensors:

  * a *score* phase — candidate draw, Eq. 3 scoring through the
    ``Backend.rls_scores`` seam (the fused K5 on the card up to 1024
    centers, K1 + K6 above), and the d_h reduction;
  * a *sample* phase — the with-replacement categorical draw (Alg. 1) or
    acceptance compaction (Alg. 2) and the A_h weights.

Between the phases the host fetches exactly the scalars it needs to size
the next buffers, as the reference does (DESIGN.md §8.3): Alg. 1 fetches
d_h (-> M_h) and the distinct-center count (-> the next level's dedup
buffer); Alg. 2 fetches one 2-float statistics vector per level. The
Cholesky of each level's (Mbuf, Mbuf) K_JJ adds the health ladder's own
check (``health.chol_with_jitter_ladder``).

Buffers keep the reference's *quarter-pow2* buckets (``_bucket``) for public
center sets and the multiple-of-32 ``_bucket32`` inside Alg. 2, so the
port's ``CenterSet`` shapes match the reference's.

Two exact optimizations of the reference are kept (DESIGN.md §8):

  * when a level wants more uniform candidates than there are points
    (R_h >= n), every point is scored once and carries the multiplicity c_i
    of the uniform draw (an integer ``bincount``, exact in any order);
  * the Alg. 1 center multisets are merged before the Cholesky via the
    Woodbury push-through (merged reg = harmonic sum of the duplicates'
    lam n A_jj). The sum runs over the sorted multiset by recursive
    doubling, a fixed order: a float ``index_add_`` (atomics) or a float
    ``cumsum`` (a scan) on the card adds in an order that changes from run
    to run, and the ladder would not be bit-repeatable. The public
    ``CenterSet`` keeps the raw multiset.

Randomness: one CPU ``torch.Generator`` per ladder (``as_generator``),
drawn in a fixed order; the draws move to the data's device. Paper-vs-
practice constants as in the reference (``theory_constants``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .gram import BackendLike, Kernel, resolve_backend
from .leverage import _SCORE_FLOOR, CenterSet
from .sampling import as_generator, categorical, randint, uniform

Tensor = torch.Tensor

#: sorts invalid slots after every valid index.
_SENTINEL = torch.iinfo(torch.int64).max


@dataclasses.dataclass(frozen=True)
class BlessLevel:
    """One rung of the ladder: accurate scores at scale lam_h."""

    lam: float
    centers: CenterSet  # (J_h, A_h) on a padded buffer
    d_h: float  # n/R_h * sum of candidate scores (~ d_eff(lam_h))
    m_h: int  # |J_h|
    r_h: int  # |U_h|


@dataclasses.dataclass(frozen=True)
class BlessResult:
    """Every level of one ladder (the whole regularization path)."""

    levels: list[BlessLevel]
    lam_path: list[float]

    @property
    def final(self) -> BlessLevel:
        return self.levels[-1]

    def scores(self, kernel: Kernel, x_all: Tensor, lam: float | None = None,
               *, backend: BackendLike = None) -> Tensor:
        """Approximate leverage scores for every point at the final scale."""
        from .leverage import approx_rls_all

        lvl = self.final
        return approx_rls_all(kernel, x_all, lvl.centers, lam or lvl.lam, backend=backend)


def theory_constants(t: float, q: float, n: int, h: int, delta: float = 0.1):
    """Thm. 1 (Alg. 1) constants: (q1, q2)."""
    q2 = 12.0 * q * (2 * t + 1) ** 2 / t**2 * (1 + t) * math.log(12 * h * n / delta)
    q1 = 5.0 * q2 / (q * (1 + t))
    return q1, q2


def lam_ladder(lam: float, lam0: float, q: float) -> list[float]:
    """Geometric ladder lam_0 > ... > lam_H = lam (lam_h = lam_{h-1}/q)."""
    h = max(1, math.ceil(math.log(lam0 / lam) / math.log(q)))
    lams = [lam0 / q**i for i in range(1, h)]
    lams.append(lam)  # pin the final level exactly at lam
    return lams


def _pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


def _bucket(x: int) -> int:
    """Quarter-pow2 size bucket: pow2 up to 32, then the smallest of
    {5/8, 3/4, 7/8, 1} * next-pow2 that fits (the reference's buckets, so
    center sets have its padded shapes)."""
    x = max(1, int(x))
    p = _pow2(x)
    if p <= 32:
        return p
    for c in (5 * p // 8, 3 * p // 4, 7 * p // 8):
        if c >= x:
            return c
    return p


def _bucket32(x: int) -> int:
    """Multiple-of-32 bucket for Alg. 2's internal center buffers (the
    (M, M) factor and the (R, M) quadratic form are sensitive to padding);
    public ``CenterSet`` buffers keep ``_bucket``."""
    x = max(1, int(x))
    return _bucket(x) if x <= 32 else -(-x // 32) * 32


# =============================================================================
# Shared level machinery
# =============================================================================


def _shift_in(t: Tensor, first) -> Tensor:
    """``t`` shifted right by one, ``first`` in front."""
    return torch.cat([torch.full((1,), first, dtype=t.dtype, device=t.device), t[:-1]])


def _run_sums(vals: Tensor, first: Tensor) -> Tensor:
    """Inclusive prefix sums of ``vals`` within runs that begin where
    ``first`` is set, by recursive doubling: log2(n) elementwise steps that
    add in a fixed order on every device (a float ``cumsum`` on the card is
    a scan whose rounding order changes from run to run)."""
    n = vals.shape[0]
    pos = torch.arange(n, device=vals.device)
    start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), dim=0).values
    acc = vals
    shift = 1
    while shift < n:
        prev = torch.cat([torch.zeros_like(acc[:shift]), acc[:-shift]])
        acc = acc + torch.where(pos - shift >= start, prev, torch.zeros_like(prev))
        shift *= 2
    return acc


def _dedup_centers(centers: CenterSet, lamn: float, dbuf: int):
    """Merge duplicate centers of an Alg. 1 multiset into a (dbuf,) buffer.

    Exact via the Woodbury push-through: duplicate columns j of the same
    point with regularized diagonals r_j = lam n A_jj collapse to one column
    with r = 1 / sum_j (1/r_j) (harmonic; a singleton is unchanged). The
    caller guarantees dbuf >= the distinct count (it fetched it when the
    level was sampled). The sums run over the sorted multiset in a fixed
    order (``_run_sums``): the reference's float scatter-add would add with
    atomics on the card, and the ladder would not be bit-repeatable.
    Returns (idx, mask, reg), each (dbuf,).
    """
    dev = centers.idx.device
    valid_in = centers.mask.to(dev)
    order = torch.argsort(torch.where(valid_in, centers.idx, _SENTINEL), stable=True)
    sidx = centers.idx[order]
    svalid = valid_in[order]
    sinv = torch.where(svalid, 1.0 / (lamn * centers.weight.to(dev)[order].double()),
                       torch.zeros((), dtype=torch.float64, device=dev))
    first = svalid & (sidx != _shift_in(sidx, -1))
    # a run ends where the next position starts a run or is invalid
    after = torch.cat([first[1:] | ~svalid[1:], torch.ones((1,), dtype=torch.bool, device=dev)])
    last = svalid & after
    sums = _run_sums(sinv, first)
    # the run ends, in order, are the distinct centers
    sel = torch.argsort((~last).to(torch.uint8), stable=True)[:dbuf]
    if sel.shape[0] < dbuf:
        sel = torch.cat([sel, sel.new_zeros(dbuf - sel.shape[0])])
    dd_mask = torch.arange(dbuf, device=dev) < torch.sum(last)
    dd_idx = torch.where(dd_mask, sidx[sel], torch.zeros_like(sel))
    dd_reg = torch.where(dd_mask, 1.0 / torch.clamp(sums[sel], min=1e-30),
                         torch.ones((), dtype=torch.float64, device=dev)).float()
    return dd_idx, dd_mask, dd_reg


def _rls_dedup(kernel: Kernel, x_cand: Tensor, cand_mask: Tensor, x_all: Tensor,
               centers: CenterSet, lamn: float, *, backend, dbuf: int) -> Tensor:
    """Eq. 3 scores of candidates against a (possibly multiset) center set,
    deduplicated internally, through ``backend.rls_scores``. Clipped to
    [_SCORE_FLOOR, 1]; 0 on invalid candidate slots.

    A host-resident ``x_cand`` (a ``repro_torch.stream.ChunkStore``, in the
    regime where every row is a candidate) never meets ``kernel.diag``: the
    empty-center case routes through ``rls_scores`` with an all-masked
    buffer, which is exactly K_ii / lamn, as the reference does."""
    if int(centers.count) > 0:
        dd_idx, dd_mask, dd_reg = _dedup_centers(centers, lamn, dbuf)
        s = backend.rls_scores(kernel, x_cand, x_all[dd_idx], dd_mask, dd_reg, lamn)
    elif isinstance(x_cand, Tensor):
        s = kernel.diag(x_cand) / lamn
    else:
        dev = x_all.device
        s = backend.rls_scores(kernel, x_cand, x_all[torch.zeros((dbuf,), dtype=torch.int64)],
                               torch.zeros((dbuf,), dtype=torch.bool, device=dev),
                               torch.ones((dbuf,), dtype=torch.float32, device=dev), lamn)
    s = torch.clamp(s, _SCORE_FLOOR, 1.0)
    return torch.where(cand_mask, s, torch.zeros_like(s))


# =============================================================================
# Algorithm 1 — BLESS (with replacement)
# =============================================================================


def _bless_score(gen: torch.Generator, x: Tensor, kernel: Kernel, centers: CenterSet,
                 lam_h: float, r_h: int, *, backend, rbuf: int, dbuf: int, counts: bool):
    """Level score phase: candidate draw + Eq. 3 scores + the d_h reduction.

    ``counts=True`` is the R_h >= n regime: every point is scored once and
    the uniform draw only contributes multiplicities c_i, so the quadratic
    form runs over n rows instead of R_h > n duplicate rows. Returns
    (cand_idx, s, wvec, tot, d_h) with wvec = c * s the unnormalized
    sampling weights of Alg. 1 line 8; d_h stays on the device.
    """
    n = x.shape[0]
    dev = x.device
    lamn = lam_h * n
    draws = randint(gen, n, (rbuf,), dev)
    if counts:
        cand_idx = torch.arange(n, device=dev)
        cand_mask = torch.ones((n,), dtype=torch.bool, device=dev)
        x_cand = x
        c = torch.bincount(draws[:r_h], minlength=n).float()
    else:
        cand_idx = draws
        cand_mask = torch.arange(rbuf, device=dev) < r_h
        x_cand = x[cand_idx]
        c = cand_mask.float()
    s = _rls_dedup(kernel, x_cand, cand_mask, x, centers, lamn, backend=backend, dbuf=dbuf)
    wvec = c * s
    tot = torch.clamp(torch.sum(wvec), min=1e-30)
    return cand_idx, s, wvec, tot, n / r_h * tot


def _bless_sample(gen: torch.Generator, cand_idx: Tensor, s: Tensor, wvec: Tensor,
                  tot: Tensor, r_h: int, m_h: int, *, mbuf: int, n: int):
    """Level sample phase (Alg. 1 lines 9-10): M_h categorical draws from
    wvec (with replacement), the A_h weights, and the distinct-center count
    (on the device) the host needs to size the next level's dedup buffer."""
    dev = cand_idx.device
    pos = categorical(gen, wvec, mbuf)
    j_mask = torch.arange(mbuf, device=dev) < m_h
    w = torch.where(j_mask, (r_h * m_h / n) * s[pos] / tot, torch.ones((), device=dev))
    idx = cand_idx[pos]
    center_set = CenterSet(idx=idx, weight=w.float(), mask=j_mask,
                           count=torch.tensor(m_h, dtype=torch.int64))
    sort_key = torch.sort(torch.where(j_mask, idx, _SENTINEL)).values
    n_distinct = torch.sum((sort_key != _shift_in(sort_key, -1))
                           & (torch.arange(mbuf, device=dev) < m_h))
    return center_set, n_distinct


def bless(key: int | torch.Generator, x: Tensor, kernel: Kernel, lam: float, *,
          q: float = 2.0, q1: float = 3.0, q2: float = 3.0, lam0: float | None = None,
          t: float = 1.0, m_cap: int | None = None, backend: BackendLike = None) -> BlessResult:
    """Bottom-up Leverage Score Sampling (paper Alg. 1).

    Args:
      key: seed or CPU ``torch.Generator`` (``as_generator``).
      x: (n, d) dataset.
      kernel: bounded PSD kernel.
      lam: target regularization (the paper's lambda).
      q: ladder step (> 1).
      q1: candidate-set multiplier, R_h = q1 * min(kappa^2/lam_h, n).
      q2: center multiplier, M_h = q2 * d_h.
      lam0: ladder start; defaults to the paper's kappa^2/min(t, 1).
      t: target multiplicative accuracy (only sets the default lam0).
      m_cap: optional hard cap on M_h (memory guard).
      backend: kernel-operator backend for the Eq. 3 scorer — an instance,
        a registry name ("torch" | "cuda"), or None for the data's device.

    Returns:
      BlessResult with one BlessLevel per rung.
    """
    n = x.shape[0]
    kap2 = float(kernel.kappa_sq)
    lam0 = kap2 / min(t, 1.0) if lam0 is None else lam0
    lams = lam_ladder(lam, lam0, q)
    backend = resolve_backend(backend, device=x.device)
    gen = as_generator(key)

    centers = CenterSet.empty(1)
    dbuf = 1
    levels: list[BlessLevel] = []
    for lam_h in lams:
        # -- line 4/5: uniform candidates U_h, R_h = q1 * min(kappa^2/lam_h, n)
        r_h = max(8, int(math.ceil(q1 * min(kap2 / lam_h, n))))
        rbuf = _bucket(r_h)
        cand_idx, s, wvec, tot, d_dev = _bless_score(
            gen, x, kernel, centers, lam_h, r_h, backend=backend, rbuf=rbuf, dbuf=dbuf,
            counts=n <= rbuf)
        # -- line 7/8: d_h (host fetch) -> M_h
        d_h = float(d_dev)
        m_h = max(8, int(math.ceil(q2 * d_h)))
        if m_cap is not None:
            m_h = min(m_h, m_cap)
        # -- line 9/10: J_h ~ Multinomial(P_h, U_h), A_h weights
        centers, n_distinct = _bless_sample(gen, cand_idx, s, wvec, tot, r_h, m_h,
                                            mbuf=_bucket(m_h), n=n)
        dbuf = _bucket(int(n_distinct))  # host fetch: the next dedup buffer
        levels.append(BlessLevel(lam=lam_h, centers=centers, d_h=d_h, m_h=m_h, r_h=r_h))
    return BlessResult(levels=levels, lam_path=lams)


# =============================================================================
# Algorithm 2 — BLESS-R (rejection sampling, without replacement)
# =============================================================================


def _compact(u_idx: Tensor, p: Tensor, acc: Tensor, m_h: int, *, mbuf: int,
             m_cap: int | None) -> CenterSet:
    """Compact acceptances into an (mbuf,) CenterSet; with ``m_cap`` keep
    the m_cap highest-probability acceptances (memory guard)."""
    dev = acc.device
    if m_cap is not None:
        keep = torch.argsort(torch.where(acc, -p, torch.full_like(p, torch.inf)),
                             stable=True)[:m_cap]
        acc = torch.zeros_like(acc).index_fill_(0, keep, True) & acc
        m_h = min(m_h, m_cap)
    sel = torch.argsort((~acc).to(torch.uint8), stable=True)[:mbuf]
    if sel.shape[0] < mbuf:  # a buffer wider than the candidates: pad
        sel = torch.cat([sel, sel.new_zeros(mbuf - sel.shape[0])])
    j_mask = torch.arange(mbuf, device=dev) < m_h
    return CenterSet(idx=u_idx[sel], weight=torch.where(j_mask, p[sel], 1.0).float(),
                     mask=j_mask, count=torch.tensor(m_h, dtype=torch.int64))


def _blessr_level(gen: torch.Generator, x: Tensor, kernel: Kernel, order_h: Tensor | None,
                  prev, lam_prev: float, beta: float, q2: float, r_h: int, *, backend,
                  rbuf: int, dbuf: int, m_cap: int | None):
    """One Alg. 2 level: pack the previous level's acceptances into its
    (dbuf,) center set J_{h-1}, then score and accept this level's
    candidates against it (lines 9-12). ``order_h`` None is the beta_h = 1
    regime (every point survives the pre-filter; rbuf == n). Returns
    (J_{h-1}, u_idx, p, acc, stats) with stats the (m_h, sum s) pair the
    driver fetches."""
    n = x.shape[0]
    dev = x.device
    centers = _compact(*prev, mbuf=dbuf, m_cap=m_cap)
    if order_h is None:
        u_idx = torch.arange(n, device=dev)
        x_cand = x
    else:
        u_idx = order_h[:rbuf]
        x_cand = x[u_idx]
    u_mask = torch.arange(rbuf, device=dev) < r_h
    lamn = lam_prev * n
    # Alg. 2 center sets are distinct, so no dedup pass; an empty set
    # degenerates cleanly (the all-false mask zeroes the quadratic form).
    reg = torch.where(centers.mask, lamn * centers.weight, torch.ones_like(centers.weight))
    s = backend.rls_scores(kernel, x_cand, x[centers.idx], centers.mask, reg, lamn)
    s = torch.where(u_mask, torch.clamp(s, _SCORE_FLOOR, 1.0), torch.zeros_like(s))
    p = torch.clamp(q2 * s, max=1.0)
    # -- line 11: accept j with prob p_j / beta (clipped: see App. C)
    acc = (uniform(gen, (rbuf,), dev) < torch.clamp(p / beta, max=1.0)) & u_mask
    stats = torch.stack([torch.sum(acc.float()), torch.sum(s)])
    return centers, u_idx, p, acc, stats


def bless_r(key: int | torch.Generator, x: Tensor, kernel: Kernel, lam: float, *,
            q: float = 2.0, q2: float = 3.0, lam0: float | None = None, t: float = 1.0,
            m_cap: int | None = None, backend: BackendLike = None) -> BlessResult:
    """Bottom-up Leverage Score Sampling without replacement (paper Alg. 2).

    Per level h: a Bernoulli(beta_h) pre-filter plays the role of U_h
    (beta_h = min(q2 kappa^2 / (lam_h n), 1)); each survivor j is kept with
    probability p_{h,j}/beta_h where p_{h,j} = min(q2 * l~_{J_{h-1}}(x_j,
    lam_{h-1}), 1); kept columns get weight A_jj = p_{h,j}.

    The gates of every beta_h < 1 level are drawn up front (one host fetch
    of the survivor counts); each level then packs the previous level's
    acceptances, scores, accepts, and blocks on one 2-float fetch.
    """
    n = x.shape[0]
    dev = x.device
    kap2 = float(kernel.kappa_sq)
    lam0 = kap2 / min(t, 1.0) if lam0 is None else lam0
    lams = lam_ladder(lam, lam0, q)
    backend = resolve_backend(backend, device=dev)
    gen = as_generator(key)

    betas = [min(q2 * kap2 / (lam_h * n), 1.0) for lam_h in lams]
    gated = [h for h, b in enumerate(betas) if b < 1.0]
    r_host = {h: n for h in range(len(lams))}
    orders = {}
    if gated:
        gate = uniform(gen, (len(gated), n), dev) < torch.tensor(
            [betas[h] for h in gated], device=dev)[:, None]
        survivors_first = torch.argsort((~gate).to(torch.uint8), dim=1, stable=True)
        r_host.update(zip(gated, torch.sum(gate, dim=1).tolist()))
        orders = {h: survivors_first[i] for i, h in enumerate(gated)}

    # prev = the not-yet-compacted acceptances of the last productive level;
    # the next level packs them into J_{h-1}, so ``pending`` carries that
    # level's metadata until its centers exist.
    prev = (torch.zeros((1,), dtype=torch.int64, device=dev),
            torch.ones((1,), device=dev), torch.zeros((1,), dtype=torch.bool, device=dev), 0)
    pending: dict | None = None
    dbuf = 1
    levels: list[BlessLevel] = []
    lam_prev = lam0
    for h, lam_h in enumerate(lams):
        r_h = r_host[h]
        if r_h == 0:
            lam_prev = lam_h
            continue
        identity = betas[h] >= 1.0
        rbuf = n if identity else min(_bucket(r_h), n)
        # -- lines 9-12: J_{h-1} pack + scores at lam_{h-1} + acceptances
        packed, u_idx, p, acc, stats = _blessr_level(
            gen, x, kernel, None if identity else orders[h], prev, lam_prev, betas[h], q2,
            r_h, backend=backend, rbuf=rbuf, dbuf=dbuf, m_cap=m_cap)
        if pending is not None:
            levels.append(BlessLevel(centers=packed, **pending))
            pending = None
        m_acc, s_sum = stats.tolist()  # the level's one blocking fetch
        m_h = int(m_acc)
        d_h = float(n / r_h * s_sum)
        lam_prev = lam_h
        if m_h == 0:
            continue
        m_kept = m_h if m_cap is None else min(m_h, m_cap)
        prev = (u_idx, p, acc, m_h)
        pending = dict(lam=lam_h, d_h=d_h, m_h=m_kept, r_h=r_h)
        dbuf = _bucket32(m_kept)
    if pending is not None:  # final level: nothing left to fuse it into
        centers = _compact(*prev, mbuf=_bucket(pending["m_h"]), m_cap=m_cap)
        levels.append(BlessLevel(centers=centers, **pending))
    return BlessResult(levels=levels, lam_path=lams)
