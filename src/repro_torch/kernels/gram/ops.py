"""Public wrapper of K1: k(X, Z) through the CUDA kernel or its plain version.

A CUDA tensor goes to the kernel (``gram.cu``) or the call raises; a CPU
tensor goes to the plain version (``ref.py``). ``gram.launches`` counts the
kernel launches.

The kernel takes the route of ``gram_plan(n, m, d)``, a pure function of the
shape (never of a failure):

* ``"wide"`` (d <= 64, m % 4 == 0): each block keeps a 128-row stripe of X in
  shared memory and walks a run of 128-column Z tiles staged by ``cp.async``
  (double-buffered); each thread writes its 4 consecutive columns of a row as
  one 16-byte streaming store. The run length brings the grid to about
  ``TARGET_BLOCKS`` blocks.
* ``"scalar"`` (d <= 64, m % 4 != 0, where rows are not 16-byte aligned): the
  same kernel with 4-byte stores.
* ``"tiled"`` (d above 64): 64 x 64 output tiles on the shared ``gram_tile``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...families import get_family
from .. import build
from ..common import is_cpu, require_cuda
from .ref import gram_ref

#: the wide route's shapes (gram.cu): rows per block stripe, columns per Z
#: tile, the largest d; the blocks its grid aims at (about a dozen waves of
#: the two blocks an SM holds, on 132 SMs).
ROWS = 128
COLS = 128
DMAX = 64
TARGET_BLOCKS = 3072


class GramPlan(NamedTuple):
    """How K1 runs at one shape: ``route`` "wide", "scalar" or "tiled";
    blocks of ``rows`` rows, each walking ``run`` tiles of ``cols`` columns
    (the tiled route: one 64 x 64 tile per block)."""

    route: str
    rows: int
    cols: int
    run: int


def gram_plan(n: int, m: int, d: int) -> GramPlan:
    """The route of K1 for x (n, d) and z (m, d): the wide route for d <= 64
    (scalar stores where m % 4 != 0), else the tiled route. The run of
    column tiles per block brings the grid nearest to TARGET_BLOCKS blocks,
    with at most 65535 runs across the columns. A function of the shape
    alone."""
    if d > DMAX:
        return GramPlan("tiled", 64, 64, 1)
    stripes, tiles = max(1, -(-n // ROWS)), max(1, -(-m // COLS))
    run = (stripes * tiles + TARGET_BLOCKS // 2) // TARGET_BLOCKS
    run = min(max(run, 1, -(-tiles // 65535)), tiles)
    return GramPlan("wide" if m % 4 == 0 else "scalar", ROWS, COLS, run)


def cuda_family_id(kind: str) -> int:
    """The family's id in the CUDA epilogue switch; raises for a family
    registered without one."""
    fam = get_family(kind)
    if fam.cuda_id is None:
        raise NotImplementedError(f"kernel family {kind!r} has no CUDA epilogue "
                                  "(KernelFamily.cuda_id is None)")
    return fam.cuda_id


def gram(x: torch.Tensor, z: torch.Tensor, sigma: float = 1.0, *, kind: str = "gaussian",
         bf16: bool = False) -> torch.Tensor:
    """k(X, Z) -> (n, m) fp32 for x (n, d) and z (m, d) of any shape.

    ``bf16`` rounds the operands of the x . z term to bf16 (fp32
    accumulation; norms and epilogue fp32).
    """
    inv_scale = float(get_family(kind).inv_scale(sigma))
    if x.shape[1] != z.shape[1]:
        raise ValueError(f"feature dims differ: x {tuple(x.shape)}, z {tuple(z.shape)}")
    if is_cpu(x, z):
        return gram_ref(x, z, inv_scale, kind=kind, bf16=bf16)
    fam_id = cuda_family_id(kind)
    x = require_cuda(x, "x")
    z = require_cuda(z, "z")
    n, d = x.shape
    m = z.shape[0]
    if d < 1:
        raise ValueError("the CUDA kernels need at least one feature")
    plan = gram_plan(n, m, d)
    xnorm = torch.empty((n,), dtype=torch.float32, device=x.device)
    znorm = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    build.extension().gram(x, z, xnorm, znorm, out, 0 if plan.route == "tiled" else plan.run,
                           plan.route == "wide", fam_id, inv_scale, bf16)
    gram.launches += 1
    return out


gram.launches = 0


def gram_reference(x: torch.Tensor, z: torch.Tensor, sigma: float = 1.0, *,
                   kind: str = "gaussian", bf16: bool = False) -> torch.Tensor:
    """The plain version at the wrapper's signature (any device)."""
    return gram_ref(x, z, float(get_family(kind).inv_scale(sigma)), kind=kind, bf16=bf16)
