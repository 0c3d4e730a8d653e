"""Competing leverage-score samplers from the paper's Sec. 2.3.

The PyTorch counterpart of ``repro.core.baselines``, so the Table 1 /
Fig. 1 / Fig. 2 analogues can compare BLESS against the related work on one
scoring backend (Eq. 3 via ``approx_rls``, hence K5 / K1 + K6 on the card):

  * uniform          — [5]  (no scores; the fastest, highest-variance option)
  * two-pass         — [6]  El Alaoui & Mahoney
  * RECURSIVE-RLS    — [9]  Musco & Musco
  * SQUEAK           — [8]  Calandriello, Lazaric & Valko

Each method is a different schedule of ``L_J(U, lam) -> J'`` (Sec. 2.2/2.3).
Randomness comes from one CPU ``torch.Generator`` per call
(``as_generator``), drawn in a fixed order.
"""
from __future__ import annotations

import math

import torch

from .bless import _bucket
from .gram import BackendLike, Kernel, resolve_backend
from .leverage import CenterSet, approx_rls, uniform_center_set
from .sampling import as_generator, categorical, randint, uniform

Tensor = torch.Tensor


def uniform_centers(key: int | torch.Generator, n: int, m: int,
                    device: torch.device | str = "cpu") -> CenterSet:
    """Uniform column sampling [5]; A = (M/n) I (see uniform_center_set)."""
    return uniform_center_set(randint(as_generator(key), n, (m,), device), n, _bucket(m))


def _padded_set(idx: Tensor, weight: Tensor, mbuf: int) -> CenterSet:
    """A CenterSet of the given valid entries padded to ``mbuf`` slots."""
    m = idx.shape[0]
    pad = mbuf - m
    return CenterSet(
        idx=torch.cat([idx, idx.new_zeros(pad)]),
        weight=torch.cat([weight.float(), weight.new_ones(pad, dtype=torch.float32)]),
        mask=torch.arange(mbuf, device=idx.device) < m,
        count=torch.tensor(m, dtype=torch.int64),
    )


def _resample(gen: torch.Generator, x: Tensor, u_idx: Tensor, u_mask: Tensor,
              centers: CenterSet, kernel: Kernel, lam: float, m_out: int, n: int, backend,
              scores: Tensor | None = None) -> CenterSet:
    """One leverage-score sampling round: L_{centers}(U, lam) -> J' (Eq. 5).

    ``scores`` short-circuits the Eq. 3 evaluation when the caller already
    scored exactly these candidates against these centers at this lam.
    """
    if scores is None:
        scores = approx_rls(kernel, x[u_idx], u_mask, x, centers, lam, backend=backend)
    s = torch.where(u_mask, scores, torch.zeros_like(scores))
    p = s / torch.clamp(torch.sum(s), min=1e-30)
    r_h = int(torch.sum(u_mask))
    mbuf = _bucket(m_out)
    pos = categorical(gen, p, mbuf)
    j_mask = torch.arange(mbuf, device=x.device) < m_out
    w = torch.where(j_mask, (r_h * m_out / n) * p[pos], torch.ones((), device=x.device))
    return CenterSet(idx=u_idx[pos], weight=w.float(), mask=j_mask,
                     count=torch.tensor(m_out, dtype=torch.int64))


def two_pass(key: int | torch.Generator, x: Tensor, kernel: Kernel, lam: float, *,
             m1: int | None = None, m2: int, backend: BackendLike = None) -> CenterSet:
    """Two-pass sampling [6]: uniform J1 (size ~1/lam), then L_{J1}([n], lam)."""
    n = x.shape[0]
    backend = resolve_backend(backend, device=x.device)
    m1 = m1 or min(n, int(math.ceil(kernel.kappa_sq / lam)))
    gen = as_generator(key)
    j1 = uniform_centers(gen, n, m1, x.device)
    nbuf = _bucket(n)
    u_idx = torch.arange(nbuf, device=x.device) % n
    u_mask = torch.arange(nbuf, device=x.device) < n
    return _resample(gen, x, u_idx, u_mask, j1, kernel, lam, m2, n, backend)


def recursive_rls(key: int | torch.Generator, x: Tensor, kernel: Kernel, lam: float, *,
                  q2: float = 2.0, depth: int | None = None, m_cap: int | None = None,
                  backend: BackendLike = None) -> CenterSet:
    """RECURSIVE-RLS [9]: nested uniform U_1 c U_2 c ... c U_H = [n],
    |U_h| = n / 2^(H-h);  J_1 = U_1;  L_{J_h}(U_{h+1}, lam) -> J_{h+1}."""
    n = x.shape[0]
    dev = x.device
    backend = resolve_backend(backend, device=dev)
    depth = depth or max(1, int(math.log2(max(2, n * lam))))
    gen = as_generator(key)
    perm = torch.randperm(n, generator=gen).to(dev)
    sizes = [max(8, n // 2**(depth - h)) for h in range(depth)] + [n]
    j = uniform_center_set(perm[: sizes[0]], n, _bucket(sizes[0]))
    for r in sizes[1:]:
        rbuf = _bucket(r)
        u_idx = perm[torch.arange(rbuf, device=dev) % n]
        u_mask = torch.arange(rbuf, device=dev) < r
        # m_out ~ q2 * the d_eff estimate of the same scores the round draws with
        s = approx_rls(kernel, x[u_idx], u_mask, x, j, lam, backend=backend)
        d_est = float(n / r * torch.sum(torch.where(u_mask, s, torch.zeros_like(s))))
        m_out = max(8, int(math.ceil(q2 * d_est)))
        if m_cap is not None:
            m_out = min(m_out, m_cap)
        j = _resample(gen, x, u_idx, u_mask, j, kernel, lam, m_out, n, backend, scores=s)
    return j


def squeak(key: int | torch.Generator, x: Tensor, kernel: Kernel, lam: float, *,
           n_chunks: int | None = None, qbar: float = 2.0, m_cap: int | None = None,
           backend: BackendLike = None) -> CenterSet:
    """SQUEAK [8]: stream [n] in H chunks; merge-and-rescore
    L_{J_h u U_{h+1}}(J_h u U_{h+1}, lam) with Bernoulli thinning."""
    n = x.shape[0]
    dev = x.device
    backend = resolve_backend(backend, device=dev)
    n_chunks = n_chunks or max(2, int(math.sqrt(max(4, n * lam))))
    gen = as_generator(key)
    perm = torch.randperm(n, generator=gen).to(dev)
    chunk = n // n_chunks
    j_idx = perm[:chunk]
    j_w = torch.full((chunk,), chunk / n, device=dev)
    for h in range(1, n_chunks):
        u_new = perm[h * chunk: (h + 1) * chunk]
        cand = torch.cat([j_idx, u_new])
        cand_w = torch.cat([j_w, torch.full((u_new.shape[0],), cand.shape[0] / n, device=dev)])
        cbuf = _bucket(cand.shape[0])
        cs = _padded_set(cand, cand_w, cbuf)
        s = approx_rls(kernel, x[cs.idx], cs.mask, x, cs, lam, backend=backend)
        p = torch.clamp(qbar * s, max=1.0)
        keep = (uniform(gen, (cbuf,), dev) < p) & cs.mask
        if m_cap is not None and int(torch.sum(keep)) > m_cap:
            top = torch.argsort(torch.where(keep, -p, torch.full_like(p, torch.inf)),
                                stable=True)[:m_cap]
            keep = torch.zeros_like(keep).index_fill_(0, top, True) & keep
        order = torch.argsort((~keep).to(torch.uint8), stable=True)[: int(torch.sum(keep))]
        j_idx = cs.idx[order]
        j_w = p[order]  # importance weight: kept w.p. p -> A_jj = p_j
    return _padded_set(j_idx, j_w, _bucket(j_idx.shape[0]))
