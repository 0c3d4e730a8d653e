"""Public wrapper of K9, the Mamba-2 SSD chunk scan.

``ssd(x, dt, a, b, c, *, chunk)`` keeps the reference wrapper's signature:
x (B, S, H, P) fp32 or bf16, dt (B, S, H) (after the softplus), a (H,)
(negative), one B/C group as b/c (B, S, N); returns (y (B, S, H, P) in x's
dtype, final state (B, H, P, N) fp32). Any S: the kernel treats rows past S
as the reference wrapper's padding (dt = 0, an identity step) and does not
store them. A CUDA tensor goes to the kernels of ``ssd.cu`` (through the
extension ``build.py`` loads) or the call raises; a CPU tensor goes to the
plain version in ``ref.py``. ``ssd.launches`` counts the wrapper's kernel
calls (each runs three launches: the chunk states, the state passing, the
chunk scan).

Gradients. The reference has no backward kernel: it trains through its jnp
``ssd_chunked()``, whose gradient XLA derives. On the card the wrapper is a
``torch.autograd.Function``: its forward is always the kernel's output, and
its backward recomputes the plain version under autograd on the saved
inputs and returns that function's gradient (``ssd.backward_recomputes``
counts these; ``ref.ssd_ref.cuda_calls`` counts every plain call on a CUDA
tensor). A backward kernel is later work (ROADMAP B).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import build
from ..common import is_cpu, needs_grad, require_cuda
from .ref import ssd_ref

DTYPES = (torch.float32, torch.bfloat16)
#: shared memory one block may use on the card (bytes).
MAX_SMEM = 232_448
#: heads per chunk-scan block (one C B^T for all), the most (head, p)
#: columns and heads per chunk-state block, and the x rows per slab it
#: streams (ssd.cu).
SCAN_HEADS = 8
STATE_COLS = 512
STATE_MAX_HEADS = 64
STATE_ROWS = 16


def _state_heads_max(p: int) -> int:
    return max(1, min(STATE_MAX_HEADS, STATE_COLS // p))


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Shared memory of the larger of K9's two chunk kernels per block, in
    fp32 (bf16 x needs less) and at their most heads per block, with
    q4 = round_up(chunk, 4) and p4 = round_up(P, 4) (``ssd_smem_floats`` in
    ssd.cu). The chunk scan's: C B^T and L * C B^T (q4, q4) each, dt x
    (q4, p4), C^T (N, q4), B^T (N, q4) whose space then holds each head's dt
    and cumulative dt a (2 x 8 heads of q4), the state (N, p4 + 4), and the
    next head's x (q4, P) and state (P, N) as they land. The chunk state's:
    B (q4, N rounded up to 8), the heads' row weights (q4, heads), two (q4,)
    vectors per warp and two 16-row slabs of the heads' x."""
    def r4(v: int) -> int:
        return -(-v // 4) * 4
    q4, p4 = r4(chunk), r4(p)
    scan = (2 * q4 * q4 + q4 * p4 + n * q4 + max(n, 2 * SCAN_HEADS) * q4 + n * (p4 + 4)
            + r4(q4 * p) + r4(p * n))
    heads = _state_heads_max(p)
    state = (q4 * (-(-n // 8) * 8) + r4(q4 * heads) + 2 * 8 * q4
             + r4(2 * STATE_ROWS * heads * p))
    return 4 * max(scan, state)


class SsdPlan(NamedTuple):
    """How K9 runs at one shape and chunk: ``n_chunks`` chunks (the last may
    be ragged), chunk-state blocks of ``state_heads`` heads, chunk-scan
    blocks of ``scan_heads`` heads, and the larger block's shared memory in
    bytes."""

    n_chunks: int
    state_heads: int
    scan_heads: int
    smem: int


def ssd_plan(s: int, h: int, p: int, n: int, chunk: int) -> SsdPlan:
    """K9's grid for S rows, H heads of dim P, state dim N and ``chunk``: a
    function of the shape alone. Each launch runs (head groups, chunks,
    batch) blocks; the state passing one thread per (H, P, N) element."""
    return SsdPlan(max(1, -(-s // chunk)), min(_state_heads_max(p), max(h, 1)),
                   min(SCAN_HEADS, max(h, 1)), smem_bytes(p, n, chunk))


def _check(x, dt, a, b, c) -> None:
    bsz, s, h, _ = x.shape if x.ndim == 4 else (None,) * 4
    if (x.ndim != 4 or tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or b.ndim != 3 or tuple(b.shape[:2]) != (bsz, s) or b.shape != c.shape):
        raise ValueError("need x (B, S, H, P), dt (B, S, H), a (H,) and b, c (B, S, N); got "
                         f"{[tuple(t.shape) for t in (x, dt, a, b, c)]}")


def _launch(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One K9 call (three launches, counted once) on CUDA tensors."""
    bsz, s, h, p = x.shape
    n = b.shape[2]
    plan = ssd_plan(s, h, p, n, chunk)
    if plan.smem > MAX_SMEM:
        raise ValueError(f"K9 at P = {p}, N = {n}, chunk {chunk} needs {plan.smem} bytes of "
                         f"shared memory, more than {MAX_SMEM}; use a smaller chunk")
    x = require_cuda(x, "x", DTYPES)
    dt, a, b, c = (require_cuda(t.float(), name) for t, name in
                   ((dt, "dt"), (a, "a"), (b, "b"), (c, "c")))
    y = torch.empty_like(x)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if x.numel() == 0 or n == 0:
        return y, state
    states = torch.empty((bsz, plan.n_chunks, h, p, n), dtype=torch.float32, device=x.device)
    decay = torch.empty((bsz, plan.n_chunks, h), dtype=torch.float32, device=x.device)
    build.extension().ssd(x, dt, a, b, c, y, state, states, decay, chunk, plan.state_heads,
                          plan.scan_heads)
    ssd.launches += 1
    return y, state


class _Ssd(torch.autograd.Function):
    """K9 forward; the plain version's gradient, recomputed, backward."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        return _launch(x, dt, a, b, c, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        saved = ctx.saved_tensors
        ssd.backward_recomputes += 1
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad[:5])]
            outs = ssd_ref(*leaves, chunk=ctx.chunk)
            pairs = [(o, g) for o, g in zip(outs, (grad_y, grad_state)) if g is not None]
            wrt = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                           allow_unused=True))
        return (*(next(got) if t.requires_grad else None for t in leaves), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        *, chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of x with decays exp(dt a), inputs B and readouts C.
    Differentiable on both devices (see the module docstring)."""
    _check(x, dt, a, b, c)
    if is_cpu(x, dt, a, b, c):
        return ssd_ref(x, dt, a, b, c, chunk=chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if needs_grad(x, dt, a, b, c):
        return _Ssd.apply(x, dt, a, b, c, chunk)
    return _launch(x, dt, a, b, c, chunk)


ssd.launches = 0
ssd.backward_recomputes = 0


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, *, chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain K9 at the wrapper's signature (any device)."""
    _check(x, dt, a, b, c)
    return ssd_ref(x, dt, a, b, c, chunk=chunk)
