"""FALKON with the generalized (weighted) preconditioner — paper Sec. 3 / App. B.

The PyTorch counterpart of ``repro.core.falkon``. Solves Nystrom-KRR

    alpha = (K_nM^T K_nM + lam n K_MM)^+ K_nM^T y        (Eq. 13)

by conjugate gradient on the preconditioned system (Def. 3)

    W beta = b,   W = B^T (K_nM^T K_nM + lam n K_MM) B,  b = B^T K_nM^T y,

with the Def. 2 / Eq. (15) preconditioner B, B B^T =
(n/M K_MM A^{-1} K_MM + lam n K_MM)^{-1}.

The K_nM contractions come from the ``Backend`` seam
(``repro_torch.core.backend``): the pure-torch row streamer, the CUDA
kernels, or either on each rank's rows (``ShardedBackend``). The CG loop
runs on the host, one quadratic-op launch per iteration, with no host sync
inside the loop unless a ``callback`` asks for the iterate. ``y`` may be
(n,) or (n, k): the k right-hand sides ride one block-CG with per-column
step sizes and a per-column freeze.

Fused whole-fit path: on a graph-safe backend (``TorchBackend``) with no
``callback``, ``falkon_fit`` runs the CG loop and the alpha recovery on a
CUDA device as one captured ``torch.cuda.CUDAGraph`` per shape bucket, the
counterpart of the reference's one-``jit`` solve. Rows are padded to a
multiple of the backend's block and masked by ``arange(n_pad) < n``, k >= 2
is padded to a power-of-two column bucket (the pad columns freeze from
iteration 0), so every (n, k) of a bucket shares one plan; every later fit
in the bucket copies its inputs into the plan's static buffers and replays.
n, lam and the bandwidth live in 0-d buffers, so a new value never needs a
new capture. Unlike the reference, whose jit holds the eigh too, K_MM and
the Def. 2 factors are computed before the graph (``torch.linalg.eigh``
checks its result on the host) and copied into the plan. Torch has no CPU
graphs: off the card the fused fit is the host loop, unpadded, and builds
no plan.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..testing import faults
from . import health
from .gram import BackendLike, Kernel, family_cross, resolve_backend
from .leverage import CenterSet  # noqa: F401 — re-exported for callers

Tensor = torch.Tensor


def _bcol(s: Tensor, v: Tensor) -> Tensor:
    """Broadcast a per-row scale (M,) against v of shape (M,) or (M, k)."""
    return s[:, None] if v.ndim == 2 else s


class Preconditioner(NamedTuple):
    """Factors of Def. 2, Example 1.3 (eigendecomposition branch).

    ``q_iso`` is the (M, q) partial isometry with the dropped directions
    zeroed at a fixed shape; ``apply`` / ``apply_t`` take a vector or a panel.
    """

    q_iso: Tensor  # (M, M), dropped columns zeroed
    t_diag: Tensor  # (M,) T = diag(sqrt(eig)), 1 on dropped directions
    r_diag: Tensor  # (M,) R = diag(sqrt(eig/M + lam)), 1 on dropped directions
    inv_sqrt_a: Tensor  # (M,) diag(A)^{-1/2}
    n: int

    def apply(self, v: Tensor) -> Tensor:
        """B v = (1/sqrt n) A^{-1/2} Q T^{-1} R^{-1} v."""
        u = self.q_iso @ (v / _bcol(self.t_diag * self.r_diag, v))
        return _bcol(self.inv_sqrt_a, u) * u / (self.n ** 0.5)

    def apply_t(self, v: Tensor) -> Tensor:
        """B^T v."""
        u = self.q_iso.T @ (_bcol(self.inv_sqrt_a, v) * v / (self.n ** 0.5))
        return u / _bcol(self.t_diag * self.r_diag, u)


def make_preconditioner(kernel: Kernel, z: Tensor, a_diag: Tensor, lam: float, n: int,
                        *, rank_tol: float = 1e-5, kmm: Tensor | None = None) -> Preconditioner:
    """Def. 2 factors for centers z (M, d) with weights diag(A) = a_diag.

    eigh of A^{-1/2} K_MM A^{-1/2}; eigenvalues below rank_tol * max are
    dropped (q = numerical rank), kept at a fixed shape by neutralizing the
    dropped directions (T, R entries -> 1, Q column -> 0). ``kmm`` is K_MM
    when the caller already has it (``falkon_fit`` builds it with the
    backend); else it is computed with ``kernel.cross``. The factors are
    fp32, as in the reference, unless K_MM is fp64 (an fp64 solve, used as
    a referee for the fp32 paths).
    """
    m = z.shape[0]
    kmm = kernel.cross(z, z) if kmm is None else kmm
    dtype = torch.promote_types(kmm.dtype, torch.float32)
    kmm = kmm.to(dtype)
    inv_sqrt_a = (1.0 / torch.sqrt(a_diag.to(dtype))).to(kmm.device)
    kt = kmm * (inv_sqrt_a[:, None] * inv_sqrt_a[None, :])
    eig, vec = torch.linalg.eigh(kt)
    floor = torch.clamp(eig[-1], min=1e-30) * rank_tol
    keep = eig > floor
    one = torch.ones_like(eig)
    t_diag = torch.sqrt(torch.where(keep, eig, one))
    r_diag = torch.sqrt(torch.where(keep, eig / m + lam, one))
    q_iso = vec * keep[None, :].to(vec.dtype)
    return Preconditioner(q_iso, t_diag, r_diag, inv_sqrt_a, n)


# ---------------------------------------------------------------------------
# K_nM operators (the pure-torch streamer behind TorchBackend)
# ---------------------------------------------------------------------------


def _cross(kernel: Kernel, z: Tensor, inv: Tensor | None) -> Callable[[Tensor], Tensor]:
    """x_block -> K(x_block, z): at ``kernel.sigma``, or at the bandwidth
    ``inv`` (``kernel.family.inv_scale(sigma)``) held in a 0-d tensor."""
    if inv is None:
        return lambda xb: kernel.cross(xb, z)
    return lambda xb: family_cross(kernel.family, xb, z, inv)


def local_knm_quadratic(kernel: Kernel, x: Tensor, z: Tensor, *, block: int = 8192,
                        mask: Tensor | None = None,
                        inv: Tensor | None = None) -> Callable[[Tensor], Tensor]:
    """v -> K_nM^T (K_nM v), streaming x in row blocks.

    ``v`` may be (M,) or an (M, k) panel: each Gram block is built once and
    contracted against every column. ``mask`` — optional per-row weights,
    (n,) for every column or (n, k) per column — multiplies the (block, k)
    intermediate between the two contractions: column j computes
    ``K_nM^T diag(mask[:, j]) K_nM v_j``. ``inv`` — the bandwidth as a 0-d
    tensor in place of ``kernel.sigma`` (the fused fit's graph reads it from
    a buffer).
    """
    if mask is not None:
        mask = mask.to(x.dtype)
    cross = _cross(kernel, z, inv)

    def op(v: Tensor) -> Tensor:
        out = v.new_zeros((z.shape[0],) + tuple(v.shape[1:]))
        for i in range(0, x.shape[0], block):
            g = cross(x[i:i + block])
            t = g @ v
            if mask is not None:
                mb = mask[i:i + block]
                t = t * (mb if t.ndim == mb.ndim else mb[:, None])
            out += g.T @ t
        return out

    return op


def local_knm_t(kernel: Kernel, x: Tensor, z: Tensor, y: Tensor, *, block: int = 8192,
                mask: Tensor | None = None, inv: Tensor | None = None) -> Tensor:
    """K_nM^T y, streamed; ``y`` (n,) -> (M,) or (n, k) -> (M, k). ``mask``
    (shaped like ``y``) folds into the targets: K_nM^T (mask * y). ``inv``
    as in ``local_knm_quadratic``."""
    if mask is not None:
        y = y * mask.to(y.dtype)
    cross = _cross(kernel, z, inv)
    out = y.new_zeros((z.shape[0],) + tuple(y.shape[1:]))
    for i in range(0, x.shape[0], block):
        out += cross(x[i:i + block]).T @ y[i:i + block]
    return out


# ---------------------------------------------------------------------------
# Conjugate gradient
# ---------------------------------------------------------------------------

#: Per-column freeze threshold: a column whose squared residual fell below
#: this fraction of its initial value (or started at zero) is at fp32 noise
#: and stops updating while the others iterate.
_CG_FREEZE_REL = 1e-14


def cg(matvec: Callable[[Tensor], Tensor], b: Tensor, iters: int,
       callback: Callable[[int, Tensor], None] | None = None,
       trajectory: bool = False) -> Tensor | tuple[Tensor, Tensor]:
    """CG on SPD ``matvec`` for a fixed iteration count (the paper's t).

    ``b`` may be one right-hand side (q,) or a (q, k) panel: one ``matvec``
    per iteration serves every column, while the step sizes run per column
    and converged columns freeze (``_CG_FREEZE_REL``). With ``trajectory``
    returns ``(beta, residuals)``, the (iters+1,) or (iters+1, k) squared
    residual history (row 0 = initial). ``callback(i, beta)`` is called
    after every iteration.
    """
    rs0 = torch.sum(b * b, dim=0)
    beta, r, p, rs = torch.zeros_like(b), b, b, rs0
    resid = [rs0]
    for i in range(iters):
        ap = matvec(p)
        active = rs > _CG_FREEZE_REL * rs0
        alpha = torch.where(active, rs / torch.clamp(torch.sum(p * ap, dim=0), min=1e-30),
                            torch.zeros_like(rs))
        beta = beta + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r, dim=0)
        mu = torch.where(active, rs_new / torch.clamp(rs, min=1e-30), torch.zeros_like(rs))
        p = torch.where(active, r + mu * p, p)
        rs = torch.where(active, rs_new, rs)
        resid.append(rs)
        if callback is not None:
            callback(i, beta)
    if trajectory:
        return beta, torch.stack(resid)
    return beta


def _falkon_solve(quad: Callable[[Tensor], Tensor], kty: Tensor, kmm: Tensor,
                  prec: Preconditioner, lam: float | Tensor, n_eff: float | Tensor, iters: int,
                  callback: Callable[[int, Tensor], None] | None = None) -> tuple[Tensor, Tensor]:
    """(alpha, residual trajectory): CG on the Def. 3 system W beta = B^T
    K_nM^T y, W = B^T (K_nM^T K_nM + lam n_eff K_MM) B, and alpha = B beta.
    The body of both the host loop and the fused plan."""
    def matvec(v: Tensor) -> Tensor:
        u = prec.apply(v)
        return prec.apply_t(quad(u) + lam * n_eff * (kmm @ u))

    beta, resid = cg(matvec, prec.apply_t(kty), iters, callback=callback, trajectory=True)
    return prec.apply(beta), resid


# ---------------------------------------------------------------------------
# Fused whole-fit path (see the module docstring)
# ---------------------------------------------------------------------------

#: plans built, one per shape bucket (on a CUDA device each is one graph
#: capture), as the reference counts traces of its fused solve: a second
#: fit in a bucket must not raise it.
_FUSED_FIT_TRACES = 0
#: the plans, by bucket: (n_pad, k bucket, M, d, iters, backend, kernel
#: family, masked, device, dtype), least recently used first.
_FUSED_PLANS: dict[tuple, "_FusedPlan"] = {}
#: plans kept; a new bucket past it releases the least recently used plan.
#: Each plan holds on its device the padded inputs (n_pad x d, n_pad x kb
#: and, masked, a second n_pad x kb), K_MM and the eigenvector factor (two
#: M x M), four (M,) vectors, and its graph's private memory pool (the
#: body's intermediates: a (block, M) Gram slab and its products, the CG
#: state).
MAX_FUSED_PLANS = 4


def release_fused_plans() -> int:
    """Drop every cached fused plan (its buffers and graph pool go with the
    last reference); returns how many were dropped."""
    count = len(_FUSED_PLANS)
    _FUSED_PLANS.clear()
    return count


def _fit_block(backend) -> int:
    """Row-bucket granularity: the graph-safe backend's stream block
    (``TorchBackend.block``, 8 192)."""
    return backend.block


def _k_bucket(k: int) -> int:
    """Column bucket: the next power of two >= k (zero columns freeze)."""
    return 1 << max(0, k - 1).bit_length()


class _FusedPlan:
    """One shape bucket's fused solve: static input buffers and, on a CUDA
    device, the captured graph (its own memory pool) and output buffers.
    ``kernel`` gives the family; the bandwidth comes from the ``inv``
    buffer, never from its sigma."""

    def __init__(self, kernel: Kernel, *, n_pad: int, kb: int | None, m: int, d: int,
                 iters: int, block: int, masked: bool, device: torch.device,
                 dtype: torch.dtype):
        global _FUSED_FIT_TRACES
        _FUSED_FIT_TRACES += 1

        def buf(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        self.kernel, self.iters, self.block = kernel, iters, block
        self.x = buf(n_pad, d)
        self.y = buf(n_pad) if kb is None else buf(n_pad, kb)
        self.col_mask = torch.zeros_like(self.y) if masked else None
        self.centers, self.kmm = buf(m, d), buf(m, m)
        # n and lam in fp64: a product with an fp32 tensor rounds once, as
        # the host path's Python floats do
        self.prec = Preconditioner(buf(m, m), buf(m), buf(m), buf(m), buf(dt=torch.float64))
        self.lam, self.inv = buf(dt=torch.float64), buf()
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: tuple[Tensor, Tensor] | None = None

    def load(self, x: Tensor, y: Tensor, col_mask: Tensor | None, centers: Tensor,
             kmm: Tensor, prec: Preconditioner, lam: float, inv: float) -> None:
        """Copy one fit's inputs into the buffers (pad rows and columns zeroed)."""
        n = x.shape[0]
        self.x[:n].copy_(x)
        self.x[n:].zero_()
        for dst, src in ((self.y, y), (self.col_mask, col_mask)):
            if dst is not None:
                dst.zero_()
                (dst[:n] if src.ndim == 1 else dst[:n, :src.shape[1]]).copy_(src)
        self.centers.copy_(centers)
        self.kmm.copy_(kmm)
        for dst, src in zip(self.prec[:4], prec[:4]):
            dst.copy_(src)
        self.prec.n.fill_(n)
        self.lam.fill_(lam)
        self.inv.fill_(inv)

    def eager(self, iters: int | None = None) -> tuple[Tensor, Tensor]:
        """The body run op by op on the buffers (what a graph replays), with
        no host sync: rows at or past ``prec.n`` (a 0-d buffer) are pad and
        masked out of the quadratic op; a column mask (zero on pad rows)
        gives column j n_j = sum(m_j) in its lam n_j K_MM term, the
        preconditioner keeping the global n (exact: CG is invariant under
        that rescaling)."""
        valid = torch.arange(self.x.shape[0], device=self.x.device) < self.prec.n
        cm = self.col_mask
        quad = local_knm_quadratic(self.kernel, self.x, self.centers, block=self.block,
                                   mask=valid if cm is None else cm, inv=self.inv)
        kty = local_knm_t(self.kernel, self.x, self.centers, self.y, block=self.block, mask=cm,
                          inv=self.inv)
        n_eff = self.prec.n if cm is None else torch.sum(cm, dim=0)
        return _falkon_solve(quad, kty, self.kmm, self.prec, self.lam, n_eff,
                             self.iters if iters is None else iters)

    def run(self) -> tuple[Tensor, Tensor]:
        """alpha and the residual trajectory for the loaded inputs: on a CUDA
        device the graph's replay (captured on the first run; the outputs
        are the plan's buffers: clone them), elsewhere ``eager``."""
        if self.x.device.type != "cuda":
            return self.eager()
        with torch.cuda.device(self.x.device):
            if self.graph is None:
                # warm up on a side stream so lazy initialisation (cuBLAS
                # handles, workspaces) happens outside the capture
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self.eager(iters=1)
                torch.cuda.current_stream().wait_stream(side)
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    self.out = self.eager()
            self.graph.replay()
        return self.out


def _fused_fit(backend, kernel: Kernel, x: Tensor, y: Tensor, centers: Tensor,
               a_diag: Tensor, lam: float, row_mask: Tensor | None,
               iters: int) -> tuple[Tensor, Tensor]:
    """(alpha, residual trajectory) through the bucket's plan. ``falkon_fit``
    sends CUDA data only; on the CPU the plan runs its body eagerly (the
    tests hold the padded body to the host loop there)."""
    n, (m, d) = x.shape[0], centers.shape
    block = _fit_block(backend)
    n_pad = -(-n // block) * block
    kb = None if y.ndim == 1 else _k_bucket(y.shape[1])
    key = (n_pad, kb, m, d, iters, backend, kernel.name, row_mask is not None,
           x.device, x.dtype)
    plan = _FUSED_PLANS.pop(key, None)
    if plan is None:
        plan = _FusedPlan(kernel, n_pad=n_pad, kb=kb, m=m, d=d, iters=iters, block=block,
                          masked=row_mask is not None, device=x.device, dtype=x.dtype)
    _FUSED_PLANS[key] = plan  # the most recently used last
    while len(_FUSED_PLANS) > MAX_FUSED_PLANS:
        del _FUSED_PLANS[next(iter(_FUSED_PLANS))]
    kmm = backend.gram_block(kernel, centers, centers)
    prec = make_preconditioner(kernel, centers, a_diag, lam, n, kmm=kmm)
    plan.load(x, y, row_mask, centers, kmm, prec, lam, kernel.family.inv_scale(kernel.sigma))
    alpha, resid = plan.run()
    if kb is not None:
        alpha, resid = alpha[:, :y.shape[1]], resid[:, :y.shape[1]]
    return alpha.clone(), resid.clone()


# ---------------------------------------------------------------------------
# FALKON estimator
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FalkonModel:
    """A fitted FALKON / Nystrom-KRR predictor: x -> K(x, centers) alpha."""

    centers: Tensor  # (M, d)
    alpha: Tensor  # (M,) or (M, k)
    kernel: Kernel
    #: contraction backend for predict; set by the solvers, overridable per
    #: call. None -> ``default_backend`` for the data's device.
    backend: BackendLike = None
    #: CG residual trajectory report; None for the direct solvers.
    diagnostics: "health.SolveDiagnostics | None" = None
    #: fit-time regularization / row count / center weights, for
    #: ``predictive_variance``; None on hand-assembled models.
    lam: float | None = None
    n_train: int | None = None
    a_diag: Tensor | None = None

    def predictive_variance(self, x: Tensor, *, backend: BackendLike = None) -> Tensor:
        """GP-style Nystrom posterior variance ``k(x,x) - k_xM (K_MM + lam n
        A)^{-1} k_Mx`` per row of ``x``, = lam n times the ridge leverage
        score of x against the centers (the seam's ``rls_scores``; on
        ``CudaBackend`` the fused K5 up to 1024 centers, K1 + K6 above).
        Clipped at 0."""
        if self.lam is None or self.n_train is None:
            raise ValueError(
                "predictive_variance needs fit metadata (lam, n_train); this "
                "model was built without it — refit via falkon_fit / "
                "nystrom_krr / exact_krr")
        be = resolve_backend(backend if backend is not None else self.backend,
                             device=x.device, n=x.shape[0])
        m = self.centers.shape[0]
        dev = self.centers.device
        a = (torch.ones((m,), dtype=torch.float32, device=dev) if self.a_diag is None
             else self.a_diag.float().to(dev))
        lam_n = float(self.lam * self.n_train)
        scores = be.rls_scores(self.kernel, x, self.centers,
                               torch.ones((m,), dtype=torch.bool, device=dev), lam_n * a, lam_n)
        return torch.clamp(lam_n * scores, min=0.0)

    def predict(self, x: Tensor, *, backend: BackendLike = None) -> Tensor:
        """K(x, centers) alpha through the seam: (n,) or (n, k).

        The serving dispatch boundary: it hosts the ``dispatch.latency``,
        ``backend.error`` and ``gram.nan_tile`` injection points (one dict
        check when nothing is armed; ``repro_torch.testing.faults``)."""
        be = resolve_backend(backend if backend is not None else self.backend,
                             device=x.device, n=x.shape[0])
        if faults.active():
            faults.sleep_if(rows=x.shape[0], centers=self.centers.shape[0])
            faults.raise_if()
        out = be.knm_matvec(self.kernel, x, self.centers, self.alpha)
        if faults.active():
            out = faults.corrupt("gram.nan_tile", out)
        return out


def falkon_fit(
    kernel: Kernel,
    x: Tensor,
    y: Tensor,
    centers: Tensor,
    lam: float,
    *,
    a_diag: Tensor | None = None,
    iters: int = 20,
    backend: BackendLike = None,
    callback: Callable[[int, FalkonModel], None] | None = None,
    fused: bool | None = None,
    check_finite: bool = False,
    row_mask: Tensor | None = None,
) -> FalkonModel:
    """Fit FALKON (uniform A = I) or FALKON with center weights A = a_diag.

    ``backend`` selects the K_nM operators: an instance, a registry name
    ("torch" | "cuda" | "sharded" | ...), or None for ``default_backend``
    of the data's device. ``fused`` picks the whole-fit path (module
    docstring; on the card one CUDA graph per shape bucket, off it the host
    loop): None takes it when the backend is graph-safe and there is no
    ``callback``, True forces it (``ValueError`` on a backend that is not
    graph-safe, or with a callback), False forces the host loop. ``y`` may
    be (n,) or (n, k) (one block-CG for all columns).
    Every fit records its CG residual trajectory as ``model.diagnostics``;
    ``check_finite=True`` raises ``health.NonFiniteError`` instead of
    returning a NaN alpha. ``row_mask`` (shaped like ``y``, on the card
    through K7) fits column j on its masked rows only: it solves
    (K_nM^T diag(m_j) K_nM + lam n_j K_MM) alpha_j = K_nM^T (m_j y_j) with
    n_j = sum(m_j), exact in fp32 for binary masks up to 2^24 rows. The
    preconditioner keeps the global n, so the solution is a refit's on those
    rows, but the iterates before convergence are not.
    """
    n = x.shape[0]
    m = centers.shape[0]
    backend = resolve_backend(backend, device=x.device, n=n)
    if y.ndim != 1 and callback is not None:
        raise ValueError("per-iteration callback is single-output only; "
                         "fit columns separately to trace them")
    if row_mask is not None:
        row_mask = row_mask.to(device=x.device, dtype=x.dtype)
        if row_mask.shape != y.shape:
            raise ValueError(f"row_mask shape {tuple(row_mask.shape)} must match "
                             f"y shape {tuple(y.shape)}")
    a_diag = (torch.ones((m,), dtype=x.dtype, device=x.device) if a_diag is None
              else a_diag.to(x.device))
    graph_safe = getattr(backend, "graph_safe", False)
    if fused is None:
        fused = graph_safe and callback is None
    if fused:
        if not graph_safe:
            raise ValueError(f"fused=True needs a graph-safe backend, got {backend.name!r}")
        if callback is not None:
            raise ValueError("the fused fit has no host CG loop; pass fused=False to use callback")
    if fused and x.is_cuda:
        alpha, resid = _fused_fit(backend, kernel, x, y, centers, a_diag, lam, row_mask, iters)
    else:  # the host loop (off the card also the fused fit: torch has no CPU graphs)
        kmm = backend.gram_block(kernel, centers, centers)
        prec = make_preconditioner(kernel, centers, a_diag, lam, n, kmm=kmm)
        quad, kty = backend.knm_operators(kernel, x, centers, y, mask=row_mask)
        n_eff = n if row_mask is None else torch.sum(row_mask, dim=0)
        cb = None
        if callback is not None:
            def cb(i, beta):  # host-side metric hook
                callback(i, FalkonModel(centers=centers, alpha=prec.apply(beta),
                                        kernel=kernel, backend=backend))
        alpha, resid = _falkon_solve(quad, kty, kmm, prec, lam, n_eff, iters, callback=cb)
    if check_finite:
        health.check_finite(alpha, "falkon_fit alpha")
    return FalkonModel(centers=centers, alpha=alpha, kernel=kernel, backend=backend,
                       diagnostics=health.SolveDiagnostics(resid),
                       lam=float(lam), n_train=n, a_diag=a_diag)


def falkon_bless_fit(key: int | torch.Generator, kernel: Kernel, x: Tensor, y: Tensor,
                     lam_bless: float, lam_falkon: float, *, iters: int = 20,
                     q2: float = 3.0, m_cap: int | None = None, backend: BackendLike = None,
                     callback=None, device: str = "cuda") -> FalkonModel:
    """FALKON-BLESS end to end (the paper's lam_bless >> lam_falkon trick,
    Sec. 4). A thin shim over the ``repro_torch.api`` front door, equivalent
    to ``FalkonRegressor(sampler=BlessSampler(lam=lam_bless, ...))``, so the
    sampler + solver composition has one implementation. ``device`` is the
    estimators' ``FitConfig.device`` (the card unless the caller asks for
    the CPU). The import is at call time: api sits above core.
    """
    from ..api.estimators import FalkonRegressor, FitConfig
    from ..api.samplers import BlessSampler

    est = FalkonRegressor(
        kernel=kernel,
        sampler=BlessSampler(lam=lam_bless, q2=q2, m_cap=m_cap),
        config=FitConfig(lam=lam_falkon, iters=iters, backend=backend, device=device),
    )
    return est.fit(x, y, key=key, callback=callback).model_
