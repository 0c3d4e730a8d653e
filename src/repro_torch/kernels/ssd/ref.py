"""Plain PyTorch version of K9: the chunked SSD (state-space duality) scan.

``ssd_chunked`` is the reference model's algorithm (``repro.models.mamba2``):
per chunk of Q rows the intra-chunk term (C B^T * L)(dt x) with L =
exp(segsum(dt a)), the chunk's end state, a sequential scan of the chunk
states, and the inter-chunk output C state_in scaled by the decay from the
chunk's start. All fp32; y in x's dtype. ``ssd_ref`` is the kernel's
signature, with one B/C group given as (B, S, N): it pads S to a chunk
multiple with dt = 0 (an identity step) and zero x, B and C, as the
reference's wrapper does, so y[:S] and the final state are exact.
``ssd_ref.cuda_calls`` counts its calls on CUDA tensors: K9's backward and
the checks that hold the kernel to it make them, never a forward pass.
"""
from __future__ import annotations

import torch


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k=j+1..i} x[..., k] for j <= i, -inf above."""
    t = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, diff.new_full((), float("-inf")))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, *, chunk: int = 256,
                init_state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H), a (H,), b/c (B, S, 1, N); S % min(chunk, S) == 0.
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"S = {s} is not a multiple of the chunk {q}")
    nc = s // q
    xf = x.float()
    dtf = dt.float()
    da = dtf * a.float()  # (B, S, H) log-decay increments (< 0)

    xc = xf.reshape(bsz, nc, q, h, p)
    dac = da.reshape(bsz, nc, q, h)
    dtc = dtf.reshape(bsz, nc, q, h)
    bc = b.float().reshape(bsz, nc, q, n)  # one group, broadcast over the heads
    cc = c.float().reshape(bsz, nc, q, n)

    # 1) intra-chunk: y_diag = (C B^T * L)(dt x)
    l_dec = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))  # (B, nc, H, Q, Q)
    cb = torch.einsum("bzqn,bzkn->bzqk", cc, bc)  # (B, nc, Q, Q)
    m = cb[:, :, None] * l_dec * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bzhqk,bzkhp->bzqhp", m, xc)
    del l_dec, m

    # 2) each chunk's end state: decay-to-end weighted sum of B (dt x)
    cum = torch.cumsum(dac, dim=2)  # (B, nc, Q, H)
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bzkn,bzkh,bzkhp->bzhpn", bc, dec_end * dtc, xc)

    # 3) the inter-chunk recurrence over the chunk states, in order
    chunk_decay = torch.exp(torch.sum(dac, dim=2))  # (B, nc, H)
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for z in range(nc):
        prev.append(carry)  # the state entering chunk z
        carry = states[:, z] + chunk_decay[:, z, :, None, None] * carry
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)

    # 4) inter-chunk output: C_t, decay from the chunk's start, state_in
    y_off = torch.einsum("bzqn,bzqh,bzhpn->bzqhp", cc, torch.exp(cum), prev_states)
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), carry


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, *, chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H), a (H,), b/c (B, S, N), any S ->
    (y (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32)."""
    if x.is_cuda:
        ssd_ref.cuda_calls += 1
    s = x.shape[1]
    pad = -s % chunk if s > chunk else 0
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))], dim=1)
        dt, b, c = (torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], dim=1)
                    for t in (dt, b, c))  # dt = 0: an identity step
    y, state = ssd_chunked(x, dt, a, b[:, :, None, :], c[:, :, None, :], chunk=chunk)
    return y[:, :s], state


ssd_ref.cuda_calls = 0
