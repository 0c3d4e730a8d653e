"""Plain PyTorch reference of the KRR path: the BLESS ladder (Alg. 1), the
Def. 2 preconditioner, FALKON's conjugate gradient and the predictions.

It follows the paper and the port's documented conventions (the
quarter-pow2 buffers, the harmonic merge of duplicate centers, the level-0
jitter of the Cholesky, the integer CDF of the categorical draw, the rank
cut of the preconditioner, the per-column freeze of CG), computed in an
``Arith``: fp64 to judge, or fp32 with TF32 operands on every contraction
for the control. It imports nothing of the program.

FALKON's operator K_nM^T K_nM comes two ways: from the (M, M) sums
H = K_nM^T K_nM and c = K_nM^T y, built once in row blocks (by fold for a
k-fold sweep), for the fp64 judge; or streamed over the rows at every CG
application, as the program computes it, for the control (forming H squares
the condition number, which TF32 does not survive).
"""
from __future__ import annotations

import dataclasses
import math

import torch

Tensor = torch.Tensor

SCORE_FLOOR = 1e-12
WEIGHT_FLOOR = 1e-30
CDF_UNITS = float(2 ** 40)
CG_FREEZE_REL = 1e-14
RANK_TOL = 1e-5
#: the first rung of the Cholesky jitter ladder, a share of the mean diagonal
JITTER0 = 1e-6
#: bytes of one Gram block
BLOCK_BYTES = 1 << 30


def round_tf32(t: Tensor) -> Tensor:
    """fp32 values rounded to TF32's 10 mantissa bits (half away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Arith:
    """The arithmetic of a reference run: "fp64", "fp32" or "tf32" (fp32
    with every contraction's operands rounded to TF32)."""

    name: str = "fp64"

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "fp64" else torch.float32

    def cast(self, t: Tensor) -> Tensor:
        return t.to(self.dtype)

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        a, b = self.cast(a), self.cast(b)
        if self.name == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


FP64 = Arith("fp64")


def gauss(x: Tensor, z: Tensor, inv: float, ar: Arith) -> Tensor:
    """exp(-|x - z|^2 inv), (n, m)."""
    x, z = ar.cast(x), ar.cast(z)
    d2 = torch.sum(x * x, dim=1)[:, None] + torch.sum(z * z, dim=1)[None, :] - 2.0 * ar.mm(x, z.T)
    return torch.exp(-torch.clamp(d2, min=0.0) * inv)


def rows_per_block(m: int, ar: Arith) -> int:
    return max(1024, BLOCK_BYTES // (max(1, m) * (8 if ar.dtype == torch.float64 else 4)))


def cholesky(a: Tensor) -> Tensor:
    """The Cholesky factor of a + JITTER0 * mean(diag) * I, with the jitter
    raised tenfold while the factorization fails."""
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    eps = torch.clamp(JITTER0 * torch.mean(torch.diagonal(a)), min=1e-30)
    for level in range(8):
        chol, info = torch.linalg.cholesky_ex(a + eps * (10.0 ** level) * eye)
        if int(info) == 0:
            return chol
    raise ArithmeticError("the Cholesky factorization failed at every jitter")


# ---------------------------------------------------------------------------
# BLESS, Alg. 1
# ---------------------------------------------------------------------------


def lam_ladder(lam: float, lam0: float, q: float) -> list[float]:
    h = max(1, math.ceil(math.log(lam0 / lam) / math.log(q)))
    lams = [lam0 / q ** i for i in range(1, h)]
    lams.append(lam)
    return lams


def bucket(x: int) -> int:
    """Quarter-pow2 buffer size: pow2 up to 32, then the smallest of 5/8,
    3/4, 7/8 or 1 of the next pow2 that holds x."""
    x = max(1, int(x))
    p = 1 << max(0, x - 1).bit_length()
    if p <= 32:
        return p
    for c in (5 * p // 8, 3 * p // 4, 7 * p // 8):
        if c >= x:
            return c
    return p


def categorical(w: Tensor, u: Tensor) -> Tensor:
    """Inverse-CDF draws at the uniforms ``u`` from weights ``w``, the CDF
    summed in integer units of 2^-40 of the total."""
    w = torch.clamp(w.double(), min=0.0)
    p = w / torch.clamp(torch.sum(w), min=WEIGHT_FLOOR)
    cdf = torch.cumsum(torch.floor(p * CDF_UNITS).to(torch.int64), dim=0)
    pos = torch.searchsorted(cdf, torch.floor(u.to(w.device) * cdf[-1]).to(torch.int64),
                             right=True)
    return torch.clamp(pos, max=w.shape[0] - 1)


@dataclasses.dataclass
class Level:
    """One rung: the padded center multiset and the rung's sizes."""

    lam: float
    idx: Tensor  # (mbuf,) int64, on the host
    weight: Tensor  # (mbuf,)
    count: int
    d_h: float
    m_h: int
    r_h: int


def merged_centers(level: Level, lamn: float, ar: Arith) -> tuple[Tensor, Tensor]:
    """(distinct indices, regularized diagonal): duplicates j of one point
    merge into one column with 1 / sum_j 1 / (lam n A_jj)."""
    idx = level.idx[:level.count]
    uniq, inv = torch.unique(idx, return_inverse=True)
    rec = torch.zeros(uniq.shape[0], dtype=torch.float64).index_add_(
        0, inv, 1.0 / (lamn * level.weight[:level.count].double()))
    return uniq, ar.cast(1.0 / torch.clamp(rec, min=1e-30))


class Scorer:
    """Eq. 3 scores against merged centers (None: no centers yet), the
    Cholesky factor of K_JJ + diag(reg) made once; clipped to
    [SCORE_FLOOR, 1] (the gaussian's K_ii is 1)."""

    def __init__(self, x: Tensor, centers: tuple[Tensor, Tensor] | None, lamn: float,
                 inv: float, ar: Arith):
        self.x, self.lamn, self.inv, self.ar = x, lamn, inv, ar
        self.z = self.chol = None
        if centers is not None:
            uniq, reg = centers
            self.z = x[uniq.to(x.device)]
            self.chol = cholesky(gauss(self.z, self.z, inv, ar) + torch.diag(reg.to(x.device)))

    def __call__(self, cand: Tensor) -> Tensor:
        """Scores of the rows ``cand`` (host indices) of x, on the host."""
        if self.z is None:
            s = torch.full((cand.shape[0],), 1.0 / self.lamn, dtype=self.ar.dtype)
            return torch.clamp(s, SCORE_FLOOR, 1.0)
        out = []
        block = rows_per_block(self.z.shape[0], self.ar)
        for i in range(0, cand.shape[0], block):
            g = gauss(self.x[cand[i:i + block].to(self.x.device)], self.z, self.inv, self.ar)
            v = torch.linalg.solve_triangular(self.chol, g.T, upper=False)
            out.append((1.0 - torch.sum(v * v, dim=0)) / self.lamn)
        return torch.clamp(torch.cat(out), SCORE_FLOOR, 1.0).cpu()


def m_of(d_h: float, q2: float, m_cap: int | None) -> int:
    m = max(8, int(math.ceil(q2 * d_h)))
    return m if m_cap is None else min(m, m_cap)


class Mismatch(Exception):
    """The judged output does not have the algorithm's structure."""


def ladder(x: Tensor, sigma: float, bless: dict, gen: torch.Generator, ar: Arith,
           follow: list[Level] | None = None, detail: list | None = None
           ) -> tuple[list[Level], dict]:
    """Alg. 1 on the rows x with the draws of ``gen``.

    Alone it makes its own ladder. With ``follow`` (another run's levels)
    it replays the same draws, scores each level against the followed
    run's previous level, and returns, besides, the largest over the levels
    of the normwise relative gap of the followed run's center weights
    (``weight_gap``, ||A - A_ref|| / ||A_ref||) and of the largest and the
    mean CDF shift its draws need (``draw_shift``, ``draw_shift_mean``;
    ``draw_shifts``); ``Mismatch`` if the
    followed ladder does not have the algorithm's structure. ``detail``, a
    list, gets one dict of readings per followed level.
    """
    n = x.shape[0]
    inv = 1.0 / (2.0 * sigma ** 2)
    q1, q2, m_cap = bless["q1"], bless["q2"], bless.get("m_cap")
    lams = lam_ladder(bless["lam"], 1.0, bless["q"])  # lam0 = kappa^2 / min(t, 1) = 1
    if follow is not None and len(follow) != len(lams):
        raise Mismatch(f"{len(follow)} levels, the ladder has {len(lams)}")
    gaps = {"weight_gap": 0.0, "draw_shift": 0.0, "draw_shift_mean": 0.0}
    levels: list[Level] = []
    prev: Level | None = None
    for h, lam_h in enumerate(lams):
        r_h = max(8, int(math.ceil(q1 * min(1.0 / lam_h, n))))
        rbuf = bucket(r_h)
        draws = torch.randint(0, n, (rbuf,), generator=gen)
        if n <= rbuf:  # every row scored once, with its multiplicity
            cand = torch.arange(n)
            c = torch.bincount(draws[:r_h], minlength=n).double()
            valid = torch.ones(n, dtype=torch.bool)
        else:
            cand = draws
            valid = torch.arange(rbuf) < r_h
            c = valid.double()
        lamn = lam_h * n
        score = Scorer(x, merged_centers(prev, lamn, ar) if prev is not None and prev.count
                       else None, lamn, inv, ar)
        s = score(cand)
        s = torch.where(valid, s, torch.zeros_like(s))
        w = c.to(s.dtype) * s
        tot = torch.clamp(torch.sum(w), min=1e-30)
        d_h = float(n / r_h * tot)
        if follow is None:
            m_h = m_of(d_h, q2, m_cap)
        else:
            f = follow[h]
            m_h = f.m_h
            if (f.lam != lam_h or f.r_h != r_h or m_h != m_of(f.d_h, q2, m_cap)
                    or f.count != m_h or f.idx.shape[0] != bucket(m_h)):
                raise Mismatch(f"level {h}: lam {f.lam}, r {f.r_h}, m {f.m_h}, count {f.count}, "
                               f"buffer {f.idx.shape[0]} against lam {lam_h}, r {r_h}, "
                               f"m {m_of(f.d_h, q2, m_cap)} from its d {f.d_h}")
        mbuf = bucket(m_h)
        u = torch.rand((mbuf,), generator=gen).double()
        pos = categorical(w, u)
        scale = r_h * m_h / n
        own = Level(lam=lam_h, idx=cand[pos], count=m_h, d_h=d_h, m_h=m_h, r_h=r_h,
                    weight=torch.where(torch.arange(mbuf) < m_h, scale * s[pos] / tot,
                                       torch.ones((), dtype=s.dtype)).float())
        if follow is None:
            prev = own
        else:
            picked = f.idx[:m_h]
            w_ref = scale * score(picked).double() / tot
            dw = f.weight[:m_h].double() - w_ref
            shifts = draw_shifts(picked, own.idx[:m_h], cand, pos, w, u)
            gaps["weight_gap"] = max(gaps["weight_gap"],
                                     float(torch.linalg.norm(dw) / torch.linalg.norm(w_ref)))
            gaps["draw_shift"] = max(gaps["draw_shift"], float(torch.max(shifts)))
            gaps["draw_shift_mean"] = max(gaps["draw_shift_mean"], float(torch.mean(shifts)))
            if detail is not None:
                rel = torch.abs(dw) / w_ref
                detail.append({
                    "level": h, "lam": f.lam, "r": f.r_h, "m": m_h, "d_prog": f.d_h, "d_ref": d_h,
                    "d_rel": (f.d_h - d_h) / d_h,
                    "mismatch": float(torch.mean((picked != own.idx[:m_h]).double())),
                    "shift_max": float(torch.max(shifts)), "shift_mean": float(torch.mean(shifts)),
                    "w_max": float(torch.max(rel)), "w_med": float(torch.median(rel)),
                    "w_norm": float(torch.linalg.norm(dw) / torch.linalg.norm(w_ref))})
            prev = f
        levels.append(own)
    return levels, gaps


def draw_shifts(picked: Tensor, own: Tensor, cand: Tensor, pos: Tensor, w: Tensor,
                u: Tensor) -> Tensor:
    """Per draw, the shift of this run's CDF (a share of its total) that the
    followed run's draw needs: 0 where both picked the same row; else the
    distance from the draw's uniform to the nearest edge of the cell of the
    followed run's row (the cell nearest this run's pick when the row is a
    candidate more than once); 1 for a row that is no candidate."""
    cdf = torch.cumsum(torch.clamp(w.double(), min=0.0), dim=0)
    total = float(cdf[-1])
    out = torch.zeros(picked.shape[0], dtype=torch.float64)
    for i in torch.nonzero(picked != own).flatten().tolist():
        js = torch.nonzero(cand == picked[i]).flatten()
        if js.numel() == 0:
            out[i] = 1.0
            continue
        j = int(js[torch.argmin(torch.abs(js - pos[i]))])
        ut = float(u[i]) * total
        lo = float(cdf[j - 1]) if j > 0 else 0.0
        out[i] = max(lo - ut, ut - float(cdf[j]), 0.0) / total
    return out


# ---------------------------------------------------------------------------
# FALKON: Def. 2 preconditioner, CG
# ---------------------------------------------------------------------------


def gram_sums(x: Tensor, y: Tensor, z: Tensor, sigma: float, ar: Arith,
              groups: Tensor | None = None, n_groups: int = 1) -> tuple[Tensor, Tensor, Tensor]:
    """Per group of rows g: P_g = K_gM^T K_gM (G, M, M), c_g = K_gM^T y_g (G, M)
    and the group's sum of y^2 (G,). ``groups`` (n,) assigns the rows."""
    inv = 1.0 / (2.0 * sigma ** 2)
    m = z.shape[0]
    if groups is None:
        xs, ys, bounds = x, y, [0, x.shape[0]]
    else:
        order = torch.argsort(groups.to(x.device), stable=True)
        xs, ys = x[order], y[order]
        sizes = torch.bincount(groups.long().cpu(), minlength=n_groups).tolist()
        bounds = [0]
        for s in sizes:
            bounds.append(bounds[-1] + s)
    p = torch.zeros((n_groups, m, m), dtype=ar.dtype, device=x.device)
    c = torch.zeros((n_groups, m), dtype=ar.dtype, device=x.device)
    yy = torch.zeros((n_groups,), dtype=torch.float64, device=x.device)
    block = rows_per_block(m, ar)
    for g in range(n_groups):
        for i in range(bounds[g], bounds[g + 1], block):
            j = min(i + block, bounds[g + 1])
            k = gauss(xs[i:j], z, inv, ar)
            yb = ar.cast(ys[i:j])
            p[g] += ar.mm(k.T, k)
            c[g] += ar.mm(k.T, yb[:, None])[:, 0]
            yy[g] += torch.sum(ys[i:j].double() ** 2)
    return p, c, yy


@dataclasses.dataclass(frozen=True)
class Precond:
    """Def. 2 by the eigendecomposition of A^{-1/2} K_MM A^{-1/2}."""

    q_iso: Tensor
    tr: Tensor  # T R diagonal, 1 on dropped directions
    inv_sqrt_a: Tensor
    n: int
    ar: Arith

    def apply(self, v: Tensor) -> Tensor:
        u = self.ar.mm(self.q_iso, v / self.tr[:, None])
        return self.inv_sqrt_a[:, None] * u / math.sqrt(self.n)

    def apply_t(self, v: Tensor) -> Tensor:
        u = self.ar.mm(self.q_iso.T, self.inv_sqrt_a[:, None] * v / math.sqrt(self.n))
        return u / self.tr[:, None]


def precond(kmm: Tensor, a: Tensor, lam: float, n: int, ar: Arith) -> Precond:
    m = kmm.shape[0]
    isa = 1.0 / torch.sqrt(ar.cast(a))
    eig, vec = torch.linalg.eigh(kmm * (isa[:, None] * isa[None, :]))
    keep = eig > torch.clamp(eig[-1], min=1e-30) * RANK_TOL
    one = torch.ones_like(eig)
    t = torch.sqrt(torch.where(keep, eig, one))
    r = torch.sqrt(torch.where(keep, eig / m + lam, one))
    return Precond(vec * keep[None, :].to(vec.dtype), t * r, isa, n, ar)


def cg(matvec, b: Tensor, iters: int) -> Tensor:
    """CG for a fixed count, per-column step sizes, converged columns frozen."""
    rs0 = torch.sum(b * b, dim=0)
    beta, r, p, rs = torch.zeros_like(b), b, b, rs0
    for _ in range(iters):
        ap = matvec(p)
        active = rs > CG_FREEZE_REL * rs0
        alpha = torch.where(active, rs / torch.clamp(torch.sum(p * ap, dim=0), min=1e-30),
                            torch.zeros_like(rs))
        beta = beta + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r, dim=0)
        mu = torch.where(active, rs_new / torch.clamp(rs, min=1e-30), torch.zeros_like(rs))
        p = torch.where(active, r + mu * p, p)
        rs = torch.where(active, rs_new, rs)
    return beta


def sums_operator(p: Tensor, c: Tensor, n: int, ar: Arith, *, holdout: bool = False,
                  sizes: Tensor | None = None):
    """(quad, rhs, n_eff) of FALKON from ``gram_sums``'s sums. Without
    ``holdout`` one column per group of rows (normally one group: all rows).
    With ``holdout`` column f trains on the rows outside group f (an exact
    k-fold column: H_f = the other groups' P, n_f their rows)."""
    if holdout:
        h = torch.sum(p, dim=0)
        rhs = (torch.sum(c, dim=0)[None, :] - c).T
        n_eff = (n - sizes.to(p.device)).to(p.dtype)

        def quad(u: Tensor) -> Tensor:
            own = torch.stack([ar.mm(p[f], u[:, f:f + 1])[:, 0] for f in range(u.shape[1])], dim=1)
            return ar.mm(h, u) - own
    else:
        rhs = c.T
        n_eff = torch.full((1,), float(n), dtype=p.dtype, device=p.device)

        def quad(u: Tensor) -> Tensor:
            return ar.mm(p[0], u)

    return quad, rhs, n_eff


def streamed_operator(x: Tensor, y: Tensor, z: Tensor, sigma: float, ar: Arith,
                      mask: Tensor | None = None):
    """(quad, rhs, n_eff) of FALKON with K_nM^T (K_nM u) streamed over row
    blocks at every application, as the program computes it; ``mask`` (n, k)
    gives column j its rows (``y`` then the (n,) targets of every column)."""
    inv = 1.0 / (2.0 * sigma ** 2)
    block = rows_per_block(z.shape[0], ar)
    n = x.shape[0]
    yk = ar.cast(y)[:, None] if mask is None else ar.cast(y)[:, None] * ar.cast(mask)
    n_eff = (torch.full((1,), float(n), dtype=ar.dtype, device=x.device) if mask is None
             else torch.sum(ar.cast(mask), dim=0))

    def quad(u: Tensor) -> Tensor:
        out = torch.zeros_like(u)
        for i in range(0, n, block):
            g = gauss(x[i:i + block], z, inv, ar)
            t = ar.mm(g, u)
            if mask is not None:
                t = t * ar.cast(mask[i:i + block])
            out += ar.mm(g.T, t)
        return out

    rhs = torch.zeros((z.shape[0], yk.shape[1]), dtype=ar.dtype, device=x.device)
    for i in range(0, n, block):
        rhs += ar.mm(gauss(x[i:i + block], z, inv, ar).T, yk[i:i + block])
    return quad, rhs, n_eff


def falkon(operator, kmm: Tensor, a: Tensor, lam: float, n: int, iters: int,
           ar: Arith) -> Tensor:
    """alpha (M, k): CG on B^T (K_nM^T K_nM + lam n_eff K_MM) B beta = B^T rhs,
    alpha = B beta; ``operator`` = (quad, rhs, n_eff), the preconditioner
    keeping the global n."""
    quad, rhs, n_eff = operator
    pre = precond(kmm, a, lam, n, ar)

    def matvec(v: Tensor) -> Tensor:
        u = pre.apply(v)
        return pre.apply_t(quad(u) + lam * n_eff[None, :] * ar.mm(kmm, u))

    return pre.apply(cg(matvec, pre.apply_t(rhs), iters))


def predict(x: Tensor, z: Tensor, alpha: Tensor, sigma: float, ar: Arith) -> Tensor:
    """K(x, z) alpha, (n, k), in row blocks."""
    inv = 1.0 / (2.0 * sigma ** 2)
    block = rows_per_block(z.shape[0], ar)
    return torch.cat([ar.mm(gauss(x[i:i + block], z, inv, ar), alpha)
                      for i in range(0, x.shape[0], block)])


def kmm_of(z: Tensor, sigma: float, ar: Arith) -> Tensor:
    return gauss(z, z, 1.0 / (2.0 * sigma ** 2), ar)
