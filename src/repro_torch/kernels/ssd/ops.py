"""Public wrapper of K9, the Mamba-2 SSD chunk scan.

``ssd(x, dt, a, b, c, *, chunk)`` keeps the reference wrapper's signature:
x (B, S, H, P) fp32 or bf16, dt (B, S, H) (after the softplus), a (H,)
(negative), one B/C group as b/c (B, S, N); returns (y (B, S, H, P) in x's
dtype, final state (B, H, P, N) fp32). Any S: the kernel treats rows past S
as the reference wrapper's padding (dt = 0, an identity step) and does not
store them. A CUDA tensor goes to the kernel of ``ssd.cu`` (through the
extension ``build.py`` loads) or the call raises; a CPU tensor goes to the
plain version in ``ref.py``. ``ssd.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from .. import build
from ..common import is_cpu, require_cuda
from .ref import ssd_ref

DTYPES = (torch.float32, torch.bfloat16)
#: shared memory one block may use on the card (bytes).
MAX_SMEM = 232_448


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Shared memory of one K9 block: dt x (Q, P), B and C (Q, N + 1), the
    (Q, Q + 1) intra-chunk matrix, the (P, N + 1) state and three (Q,)
    vectors, in fp32 (``ssd_smem_floats`` in ssd.cu)."""
    return 4 * (chunk * p + 2 * chunk * (n + 1) + chunk * (chunk + 1) + p * (n + 1) + 3 * chunk)


def _check(x, dt, a, b, c) -> None:
    bsz, s, h, _ = x.shape if x.ndim == 4 else (None,) * 4
    if (x.ndim != 4 or tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or b.ndim != 3 or tuple(b.shape[:2]) != (bsz, s) or b.shape != c.shape):
        raise ValueError("need x (B, S, H, P), dt (B, S, H), a (H,) and b, c (B, S, N); got "
                         f"{[tuple(t.shape) for t in (x, dt, a, b, c)]}")


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        *, chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of x with decays exp(dt a), inputs B and readouts C."""
    _check(x, dt, a, b, c)
    if is_cpu(x, dt, a, b, c):
        return ssd_ref(x, dt, a, b, c, chunk=chunk)
    bsz, s, h, p = x.shape
    n = b.shape[2]
    if smem_bytes(p, n, chunk) > MAX_SMEM:
        raise ValueError(f"K9 at P = {p}, N = {n}, chunk {chunk} needs "
                         f"{smem_bytes(p, n, chunk)} bytes of shared memory, more than "
                         f"{MAX_SMEM}; use a smaller chunk")
    x = require_cuda(x, "x", DTYPES)
    dt, a, b, c = (require_cuda(t.float(), name) for t, name in
                   ((dt, "dt"), (a, "a"), (b, "b"), (c, "c")))
    y = torch.empty_like(x)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if x.numel() == 0 or n == 0:
        return y, state
    build.extension().ssd(x, dt, a, b, c, y, state, chunk)
    ssd.launches += 1
    return y, state


ssd.launches = 0


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, *, chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain K9 at the wrapper's signature (any device)."""
    _check(x, dt, a, b, c)
    return ssd_ref(x, dt, a, b, c, chunk=chunk)
