"""Public wrappers of K2-K4 and K7, the fused FALKON K_nM contractions.

``falkon_matvec`` (K_nM^T K_nM V, the CG quadratic op), ``knm_t`` (K_nM^T Y,
the CG right-hand sides) and ``knm_matvec`` (K_nM A, predict) take a single
vector or an (., k) panel and any n, M, d, k: nothing is padded, the kernels
mask the ragged edges themselves. ``falkon_matvec(mask=...)`` goes to
``falkon_matvec_masked`` (K7, the row-masked quadratic op of exact k-fold
CV). A CUDA tensor goes to the kernels of
``falkon_matvec.cu`` (through the extension ``build.py`` loads) or the call
raises; a CPU tensor goes to the plain version in ``ref.py``. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.

K2 and K7 take one of two routes, chosen by ``matvec_plan(n, M, d, k)``, a
pure function of the shape (never of a failure):

* ``"cluster"``: one kernel builds each Gram value once per call. The M
  centers are split over a thread-block cluster of 1, 2, 4 or 8 blocks (the
  fewest whose per-block slice -- a multiple of 256 centers, its z rows,
  norms, V rows and accumulator and a 16-row Gram tile -- fits in 227 KB of
  shared memory); the blocks exchange their shares of T = K_nM V through
  distributed shared memory. Taken for d <= 64 and M up to the cap that
  budget sets (12 288 at d = 18 and k = 1).
* ``"two-stage"`` (larger M or d): K4 writes T (n, k) to device memory by
  ``knm_matvec_plan`` and K3 forms K_nM^T T by ``knm_t_plan``, building every
  Gram value twice.

Both add their row chunks' partial sums in a fixed order (bit-repeatable
for a given shape), and both count under ``falkon_matvec.launches`` (K2) or
``falkon_matvec_masked.launches`` (K7).

K3 (and the two-stage route's second stage) takes the route of
``knm_t_plan(n, M, d, k)``, again a pure function of the shape:

* ``"register"`` (d <= 32): each block owns 512 centers, two per thread, with
  their z rows in the thread's registers, and walks one row chunk in 64-row
  tiles staged by ``cp.async``; each thread builds its Gram values in
  registers and contracts them there against Y, ``kc`` columns per block.
  The row chunks give about ``TARGET_BLOCKS`` blocks, none longer than
  ``KT_MAX_CHUNK_ROWS`` rows, and are added in groups of 32.
* ``"tiled"`` (d above 32): the kernel on the shared 64 x 64 ``gram_tile``,
  its chunks from ``row_chunks``.

K4 (and the two-stage route's first stage) takes the route of
``knm_matvec_plan(n, M, d, k)``:

* ``"register"`` (d <= 32): K3's register kernel on the transposed problem,
  k(X, Z) A = k(Z, X)^T A. Each block owns 512 rows, two per thread, with
  their x in the thread's registers, and walks its centers in 64-center
  tiles; where the row slices alone give too few blocks, the centers are
  split into chunks (about ``TARGET_BLOCKS`` blocks in all, none longer than
  ``KT_MAX_CHUNK_ROWS`` centers), added in groups of 32.
* ``"tiled"`` (d above 32): the kernel on the shared ``gram_tile``, one block
  per 64-row tile walking all M centers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...families import get_family
from .. import build
from ..common import is_cpu, require_cuda, round_up
from ..gram.ops import cuda_family_id
from .ref import falkon_matvec_masked_ref, falkon_matvec_ref, knm_matvec_ref, knm_t_ref

TILE = 64  # the kernels' Gram tile edge (gram_tile.cuh)
#: blocks the row-chunked reductions aim to launch (a few waves of 132 SMs).
TARGET_BLOCKS = 2048


def row_chunks(n: int, m: int) -> tuple[int, int]:
    """(n_chunks, chunk_rows) of K3's tiled route (d above 32).

    Each (center tile, row chunk) block sums its rows in order; the chunks
    are then added in index order. The split depends on (n, M) alone, so a
    given problem always sums in the same order (bit-repeatable).
    """
    m_tiles = max(1, -(-m // TILE))
    n_tiles = max(1, -(-n // TILE))
    want = min(max(1, -(-TARGET_BLOCKS // m_tiles)), n_tiles, 65535)
    chunk_rows = -(-n_tiles // want) * TILE
    return max(1, -(-n // chunk_rows)), chunk_rows


#: the cluster route's shapes (falkon_matvec.cu): rows per tile, centers per
#: slice step (a build pass), warps per block, largest d, output-column
#: chunks, cluster sizes, the shared memory a block may use, and the most row
#: chunks a call sums.
FUSED_ROWS = 16
FUSED_SLICE_STEP = 256
FUSED_WARPS = 16
FUSED_DMAX = 64
FUSED_KC = (1, 2, 4, 5, 8)
FUSED_CLUSTERS = (1, 2, 4, 8)
SMEM_BYTES = 232_448
FUSED_MAX_CHUNKS = 1024


#: K3's register route (falkon_matvec.cu): centers per block, rows per staged
#: tile, largest d, and the longest row chunk (a thread's chain of 8-row sums).
KT_SLICE = 512
KT_ROWS = 64
KT_DMAX = 32
KT_MAX_CHUNK_ROWS = 16_384


class KnmTPlan(NamedTuple):
    """How K3 runs at one shape: ``route`` "register" (``slice_cols``
    centers per block, tiles of ``rows`` rows, ``kc`` output columns per
    block) or "tiled"; the rows are summed in ``n_chunks`` chunks of
    ``chunk_rows``."""

    route: str
    slice_cols: int
    rows: int
    kc: int
    n_chunks: int
    chunk_rows: int


def knm_t_smem_floats(d: int, kc: int) -> int:
    """Floats of shared memory one block of K3's register route takes
    (``knm_t_layout`` in falkon_matvec.cu): for two tiles, each row's
    features (at a stride of 68 rows), its norm and its kc Y values."""
    return 2 * d * (KT_ROWS + 4) + 2 * KT_ROWS + 2 * kc * KT_ROWS


def _kc(k: int) -> int:
    """The output columns per block or work item for a k-column panel."""
    return next(c for c in FUSED_KC if c >= min(max(k, 1), FUSED_KC[-1]))


def knm_t_plan(n: int, m: int, d: int, k: int) -> KnmTPlan:
    """The route of K3 for x (n, d), M centers and k columns: the register
    route for d <= 32, else the tiled route. Row chunks of whole 64-row
    tiles, as many as bring the grid to about TARGET_BLOCKS blocks (a few
    waves of 132 SMs), and at least as many as keep each chunk within
    KT_MAX_CHUNK_ROWS rows. A function of the shape alone."""
    if d > KT_DMAX:
        n_chunks, chunk_rows = row_chunks(n, m)
        return KnmTPlan("tiled", TILE, TILE, 0, n_chunks, chunk_rows)
    kc = _kc(k)
    per_chunk = max(1, -(-m // KT_SLICE)) * -(-max(k, 1) // kc)  # blocks per row chunk
    tiles = max(1, -(-n // KT_ROWS))
    want = max(-(-TARGET_BLOCKS // per_chunk), -(-tiles // (KT_MAX_CHUNK_ROWS // KT_ROWS)))
    want = min(want, tiles, 65535)
    chunk_rows = -(-tiles // want) * KT_ROWS
    return KnmTPlan("register", KT_SLICE, KT_ROWS, kc, max(1, -(-n // chunk_rows)), chunk_rows)


class KnmMatvecPlan(NamedTuple):
    """How K4 runs at one shape: ``route`` "register" (``slice_rows`` rows
    per block, centers in tiles of ``cols``, ``kc`` output columns per block)
    or "tiled"; the centers are summed in ``n_chunks`` chunks of
    ``chunk_cols``."""

    route: str
    slice_rows: int
    cols: int
    kc: int
    n_chunks: int
    chunk_cols: int


def knm_matvec_plan(n: int, m: int, d: int, k: int) -> KnmMatvecPlan:
    """The route of K4 for x (n, d), M centers and k columns: the register
    route for d <= 32, else the tiled route (one chunk of all M). Center
    chunks of whole 64-center tiles: as many as bring the grid nearest to
    TARGET_BLOCKS blocks (one where the row slices alone come near it), and at
    least as many as keep each chunk within KT_MAX_CHUNK_ROWS centers. A
    function of the shape alone."""
    tiles = max(1, -(-m // KT_ROWS))
    if d > KT_DMAX:
        return KnmMatvecPlan("tiled", TILE, TILE, 0, 1, tiles * KT_ROWS)
    kc = _kc(k)
    per_chunk = max(1, -(-n // KT_SLICE)) * -(-max(k, 1) // kc)  # blocks per center chunk
    want = max((TARGET_BLOCKS + per_chunk // 2) // per_chunk,
               -(-tiles // (KT_MAX_CHUNK_ROWS // KT_ROWS)), 1)
    want = min(want, tiles, 65535)
    chunk_cols = -(-tiles // want) * KT_ROWS
    return KnmMatvecPlan("register", KT_SLICE, KT_ROWS, kc, max(1, -(-m // chunk_cols)),
                         chunk_cols)


class MatvecPlan(NamedTuple):
    """How K2 / K7 run at one shape: ``route`` "cluster" (``cluster`` blocks
    of ``slice_cols`` centers each, ``kc`` output columns per work item) or
    "two-stage" (``kc``, ``n_chunks`` and ``chunk_rows`` those of
    ``knm_t_plan``, whose kernels run the second stage); the rows are summed
    in ``n_chunks`` chunks of ``chunk_rows``."""

    route: str
    cluster: int
    slice_cols: int
    kc: int
    n_chunks: int
    chunk_rows: int


def fused_smem_floats(slice_cols: int, d: int, kc: int) -> int:
    """Floats of shared memory one block of the cluster route takes
    (``fused_layout`` in falkon_matvec.cu): per center of the slice its Gram
    column, z row, norm, V row and accumulator; per tile row, for two tiles,
    its x row feature-major and its norm; the per-warp shares of T, every
    block's T partial (double-buffered) and T."""
    return (slice_cols * (FUSED_ROWS + d + 1 + 2 * kc) + 2 * (d + 1) * FUSED_ROWS
            + (FUSED_WARPS + 2 * FUSED_CLUSTERS[-1] + 1) * FUSED_ROWS * kc)


def matvec_plan(n: int, m: int, d: int, k: int) -> MatvecPlan:
    """The route of K2 / K7 for x (n, d), M centers and k columns: the
    cluster route with the fewest blocks per cluster whose slice fits in a
    block's shared memory and leaves no block without centers, else the
    two-stage route. A function of the shape alone."""
    kc = _kc(k)
    if d <= FUSED_DMAX:
        for cluster in FUSED_CLUSTERS:
            sw = round_up(-(-m // cluster), FUSED_SLICE_STEP)
            if (cluster - 1) * sw < m and 4 * fused_smem_floats(sw, d, kc) <= SMEM_BYTES:
                tiles = max(1, -(-n // FUSED_ROWS))
                per = -(-tiles // FUSED_MAX_CHUNKS)
                return MatvecPlan("cluster", cluster, sw, kc, -(-tiles // per),
                                  per * FUSED_ROWS)
    stage2 = knm_t_plan(n, m, d, k)
    return MatvecPlan("two-stage", 0, 0, stage2.kc, stage2.n_chunks, stage2.chunk_rows)


def _inv_scale(kind: str, sigma: float) -> float:
    return float(get_family(kind).inv_scale(sigma))


def _as_panel(v: torch.Tensor, rows: int, what: str) -> tuple[torch.Tensor, bool]:
    if v.ndim not in (1, 2) or v.shape[0] != rows:
        raise ValueError(f"{what} must be ({rows},) or ({rows}, k), got {tuple(v.shape)}")
    squeeze = v.ndim == 1
    return require_cuda(v[:, None] if squeeze else v, what), squeeze


def _check_xz(x: torch.Tensor, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1] or x.shape[1] < 1:
        raise ValueError(f"need x (n, d), z (M, d) with d >= 1; got {tuple(x.shape)}, "
                         f"{tuple(z.shape)}")
    return require_cuda(x, "x"), require_cuda(z, "z")


def falkon_matvec(x: torch.Tensor, z: torch.Tensor, v: torch.Tensor, sigma: float = 1.0, *,
                  kind: str = "gaussian", bf16: bool = False,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """K_nM^T (K_nM v) -> (M,) or (M, k) fp32 (K2).

    ``mask`` -- optional per-column row weights, (n,) or, with a panel ``v``,
    (n, k): column j then computes K_nM^T diag(mask[:, j]) K_nM v_j through
    ``falkon_matvec_masked`` (K7). ``mask=None`` is K2 unchanged.
    """
    if mask is not None:
        return falkon_matvec_masked(x, z, v, mask, sigma, kind=kind, bf16=bf16)
    s = _inv_scale(kind, sigma)
    if is_cpu(x, z, v):
        return falkon_matvec_ref(x, z, v, s, kind=kind, bf16=bf16)
    x, z = _check_xz(x, z)
    vp, squeeze = _as_panel(v, z.shape[0], "v")
    out = _matvec(x, z, vp, None, cuda_family_id(kind), s, bf16)
    falkon_matvec.launches += 1
    return out[:, 0] if squeeze else out


def _matvec(x, z, vp, mp, fam_id: int, s: float, bf16: bool) -> torch.Tensor:
    """K2 (``mp`` None) or K7 on CUDA tensors, by the route of ``matvec_plan``."""
    n, d = x.shape
    m, k = vp.shape
    plan = matvec_plan(n, m, d, k)
    partial = torch.empty((plan.n_chunks, m, k), dtype=torch.float32, device=x.device)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    ext = build.extension()
    xnorm = torch.empty((n,), dtype=torch.float32, device=x.device)
    if plan.route == "cluster":
        ext.falkon_matvec_fused(x, z, vp, mp, xnorm, partial, out, plan.cluster, plan.slice_cols,
                                plan.kc, plan.chunk_rows, fam_id, s, bf16)
        return out
    t = torch.empty((n, k), dtype=torch.float32, device=x.device)
    stage1 = knm_matvec_plan(n, m, d, k)
    znorm, partial1 = _knm_matvec_scratch(stage1, n, m, k, x.device)
    ext.falkon_matvec(x, z, vp, mp, t, znorm, partial1, xnorm, partial, out, stage1.kc,
                      stage1.n_chunks, stage1.chunk_cols, plan.kc, plan.chunk_rows, fam_id, s,
                      bf16)
    return out


def _knm_matvec_scratch(plan: KnmMatvecPlan, n: int, m: int, k: int, device):
    """K4's scratch for ``plan``: z's row norms (m,) and, where the centers
    are split, the chunks' partial sums (n_chunks, n, k)."""
    partial = torch.empty((plan.n_chunks if plan.n_chunks > 1 else 0, n, k),
                          dtype=torch.float32, device=device)
    return torch.empty((m,), dtype=torch.float32, device=device), partial


def _as_mask(mask: torch.Tensor, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The mask as the reference normalises it: an (n,) mask with a panel
    ``v`` is broadcast to (n, k); then fp32 and contiguous."""
    if mask.ndim == 1 and v.ndim == 2:
        mask = mask[:, None].expand(mask.shape[0], v.shape[1])
    want = (x.shape[0],) + tuple(v.shape[1:])
    if tuple(mask.shape) != want:
        raise ValueError(f"mask must be {want} for v of shape {tuple(v.shape)} (or ({x.shape[0]},) "
                         f"with a panel), got {tuple(mask.shape)}")
    return mask.to(torch.float32).contiguous()


def falkon_matvec_masked(x: torch.Tensor, z: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                         sigma: float = 1.0, *, kind: str = "gaussian",
                         bf16: bool = False) -> torch.Tensor:
    """Column j of K_nM^T diag(mask[:, j]) K_nM v_j -> (M,) or (M, k) fp32 (K7).

    ``mask`` is (n,) with a vector ``v``, or (n, k) or (n,) with a panel.
    """
    s = _inv_scale(kind, sigma)
    mask = _as_mask(mask, x, v)
    if is_cpu(x, z, v, mask):
        return falkon_matvec_masked_ref(x, z, v, mask, s, kind=kind, bf16=bf16)
    x, z = _check_xz(x, z)
    vp, squeeze = _as_panel(v, z.shape[0], "v")
    mp = require_cuda(mask[:, None] if squeeze else mask, "mask")
    out = _matvec(x, z, vp, mp, cuda_family_id(kind), s, bf16)
    falkon_matvec_masked.launches += 1
    return out[:, 0] if squeeze else out


def knm_t(x: torch.Tensor, z: torch.Tensor, y: torch.Tensor, sigma: float = 1.0, *,
          kind: str = "gaussian", bf16: bool = False) -> torch.Tensor:
    """K_nM^T y -> (M,) or (M, k) fp32 (K3)."""
    s = _inv_scale(kind, sigma)
    if is_cpu(x, z, y):
        return knm_t_ref(x, z, y, s, kind=kind, bf16=bf16)
    fam_id = cuda_family_id(kind)
    x, z = _check_xz(x, z)
    yp, squeeze = _as_panel(y, x.shape[0], "y")
    n, d = x.shape
    m, k = z.shape[0], yp.shape[1]
    plan = knm_t_plan(n, m, d, k)
    xnorm = torch.empty((n,), dtype=torch.float32, device=x.device)
    partial = torch.empty((plan.n_chunks, m, k), dtype=torch.float32, device=x.device)
    out = torch.empty((m, k), dtype=torch.float32, device=x.device)
    build.extension().knm_t(x, z, yp, xnorm, partial, out, plan.kc, plan.chunk_rows, fam_id, s,
                            bf16)
    knm_t.launches += 1
    return out[:, 0] if squeeze else out


def knm_matvec(x: torch.Tensor, z: torch.Tensor, alpha: torch.Tensor, sigma: float = 1.0, *,
               kind: str = "gaussian", bf16: bool = False) -> torch.Tensor:
    """K_nM alpha -> (n,) or (n, k) fp32 (K4)."""
    s = _inv_scale(kind, sigma)
    if is_cpu(x, z, alpha):
        return knm_matvec_ref(x, z, alpha, s, kind=kind, bf16=bf16)
    fam_id = cuda_family_id(kind)
    x, z = _check_xz(x, z)
    ap, squeeze = _as_panel(alpha, z.shape[0], "alpha")
    n, d = x.shape
    m, k = ap.shape
    plan = knm_matvec_plan(n, m, d, k)
    znorm, partial = _knm_matvec_scratch(plan, n, m, k, x.device)
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    build.extension().knm_matvec(x, z, ap, znorm, partial, out, plan.kc, plan.n_chunks,
                                 plan.chunk_cols, fam_id, s, bf16)
    knm_matvec.launches += 1
    return out[:, 0] if squeeze else out


falkon_matvec.launches = 0
falkon_matvec_masked.launches = 0
knm_t.launches = 0
knm_matvec.launches = 0


def falkon_matvec_reference(x, z, v, sigma: float = 1.0, *, kind: str = "gaussian",
                            bf16: bool = False) -> torch.Tensor:
    """The plain K2 at the wrapper's signature (any device)."""
    return falkon_matvec_ref(x, z, v, _inv_scale(kind, sigma), kind=kind, bf16=bf16)


def falkon_matvec_masked_reference(x, z, v, mask, sigma: float = 1.0, *,
                                   kind: str = "gaussian", bf16: bool = False) -> torch.Tensor:
    """The plain K7 at the wrapper's signature (any device)."""
    return falkon_matvec_masked_ref(x, z, v, _as_mask(mask, x, v), _inv_scale(kind, sigma),
                                    kind=kind, bf16=bf16)


def knm_t_reference(x, z, y, sigma: float = 1.0, *, kind: str = "gaussian",
                    bf16: bool = False) -> torch.Tensor:
    """The plain K3 at the wrapper's signature (any device)."""
    return knm_t_ref(x, z, y, _inv_scale(kind, sigma), kind=kind, bf16=bf16)


def knm_matvec_reference(x, z, alpha, sigma: float = 1.0, *, kind: str = "gaussian",
                         bf16: bool = False) -> torch.Tensor:
    """The plain K4 at the wrapper's signature (any device)."""
    return knm_matvec_ref(x, z, alpha, _inv_scale(kind, sigma), kind=kind, bf16=bf16)
