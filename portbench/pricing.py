"""The chip's peaks and the work of each step of the KRR path, counted from
the algorithm's own sizes.

Counts: each input byte read once and each output byte written once (fp32);
a Gram value costs 2 d operations for x . z (a contraction) and 5 for the
distance and the gaussian epilogue (add, fma, clamp, mul, exp: elementwise);
each multiply-add of a contraction against k columns costs 2. These are the
operation and byte counts of ``chip_smoke.bound()``, frozen here, with the
operations split into contractions and elementwise work.

Pricing: contractions at the dense TF32 tensor-core rate (no fp32-accurate
implementation runs a contraction faster), elementwise work at the fp32 rate
outside the tensor cores, bytes at the HBM rate. The least time of a piece
of work is the largest of the three: the tensor cores, the fp32 pipes and
the memory can all be busy at once, so their sum is not a bound.
"""
from __future__ import annotations

import dataclasses

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


@dataclasses.dataclass(frozen=True)
class Work:
    """Operations and bytes of one piece of work."""

    contraction: float = 0.0
    elementwise: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.contraction + other.contraction,
                    self.elementwise + other.elementwise, self.bytes + other.bytes)

    def times(self, k: float) -> "Work":
        return Work(self.contraction * k, self.elementwise * k, self.bytes * k)

    def least_s(self) -> float:
        """The least seconds the chip needs for this work."""
        return max(self.contraction / PEAK_TF32_FLOPS, self.elementwise / PEAK_FP32_FLOPS,
                   self.bytes / PEAK_BYTES_PER_S)


NONE = Work()


def _gram_ops(n: int, m: int, d: int) -> Work:
    return Work(2.0 * n * m * d, 5.0 * n * m, 0.0)


def gram(n: int, m: int, d: int) -> Work:
    """K(X, Z), (n, m), written out (K1)."""
    return _gram_ops(n, m, d) + Work(0, 0, F32 * (n * d + m * d + n * m))


def knm_quadratic(n: int, m: int, d: int, k: int, *, masked: bool = False) -> Work:
    """One CG application K_nM^T (K_nM v), v (m, k); with a row mask (n, k)
    per column (K7: the mask read and n k multiplies)."""
    w = _gram_ops(n, m, d) + Work(4.0 * n * m * k, 0, F32 * (n * d + m * d + 2 * m * k))
    if masked:
        w = w + Work(0, float(n * k), F32 * n * k)
    return w


def knm_t(n: int, m: int, d: int, k: int) -> Work:
    """K_nM^T y, y (n, k) (K3)."""
    return _gram_ops(n, m, d) + Work(2.0 * n * m * k, 0, F32 * (n * d + m * d + n * k + m * k))


def knm_matvec(n: int, m: int, d: int, k: int) -> Work:
    """K(X, Z) v, v (m, k) (K4, predict)."""
    return _gram_ops(n, m, d) + Work(2.0 * n * m * k, 0, F32 * (n * d + m * d + m * k + n * k))


def cholesky(m: int) -> Work:
    """Cholesky of an (m, m) matrix: m^3 / 3 operations."""
    return Work(m ** 3 / 3.0, 0, F32 * m * m)


def eigh(m: int) -> Work:
    """Symmetric eigendecomposition of (m, m): the Householder reduction to
    tridiagonal form that every dense method pays first, 4 m^3 / 3
    operations (Golub and Van Loan, Matrix Computations, 4th ed., Sec. 8.3.1;
    the eigenvectors add more, which is left out)."""
    return Work(4.0 * m ** 3 / 3.0, 0, F32 * 2 * m * m)


def rls_scores(r: int, m: int, d: int) -> Work:
    """Eq. 3 scores of r candidates against m distinct centers: K_JJ, its
    Cholesky, the candidates' Gram rows, one triangular solve per row
    (m^2 operations: less than G W with an explicit inverse, 2 m^2) and the
    squared norms (2 m)."""
    if m == 0:
        return NONE
    return (gram(m, m, d) + cholesky(m) + _gram_ops(r, m, d)
            + Work(float(r) * m * m, 2.0 * r * m, F32 * (r * d + m * d + r)))


def cg_extra(m: int, k: int) -> Work:
    """One CG iteration's work in the centers' space: B v, B^T v and K_MM u,
    each an (m, m) product against k columns."""
    return Work(6.0 * m * m * k, 0, 0)


def ladder(levels: list[tuple[int, int]], d: int) -> Work:
    """A BLESS ladder: (candidates scored, distinct centers scored against)
    per level."""
    total = NONE
    for r, m in levels:
        total = total + rls_scores(r, m, d)
    return total


def falkon(n: int, m: int, d: int, k: int, iters: int, *, masked: bool = False) -> Work:
    """One FALKON solve: K_MM, the Def. 2 preconditioner's eigh, the
    right-hand side and ``iters`` CG iterations."""
    per_iter = knm_quadratic(n, m, d, k, masked=masked) + cg_extra(m, k)
    return gram(m, m, d) + eigh(m) + knm_t(n, m, d, k) + per_iter.times(iters)
