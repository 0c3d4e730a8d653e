"""Mamba-2 / SSD (state-space duality, arXiv:2405.21060) block.

The port of the reference's ``repro.models.mamba2``. The full-sequence block
runs the SSD scan through K9's wrapper (``kernels/ssd``): the kernel on a
CUDA tensor, ``ssd_chunked`` (the plain version, re-exported here under the
reference's name) on a CPU tensor. Decode is one recurrent step in plain
PyTorch on either device, as in the reference.

Under a mesh the block runs its rank's share of the heads (``model``):
``in_proj`` column-parallel by heads, the B / C projections computed in
full on every rank, the gated RMSNorm's mean of squares summed over
``model``, ``out_proj`` row-parallel; K9 sees plain local tensors. Decode keeps the
cache as ``cache_specs``' blocks (the conv window's channels and the
state's heads over ``model``) and gathers the new token's projection over
``model`` instead of ``in_proj`` (``Mamba._decode_sharded``).

Shapes follow the paper: x (B, S, H, P), dt (B, S, H), A (H,) negative, one
B/C group (B, S, N), state (B, H, P, N) fp32.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.ssd import ops as ssd_ops
from ..kernels.ssd.ref import ssd_chunked
from ..sharding import collectives as tp
from .layers import ninit, param, rms_norm

__all__ = ["Mamba", "softplus", "ssd_chunked", "ssd_decode_step"]

#: SSD chunk of the full-sequence block on both devices. The reference's block
#: uses 256 (``mamba2.py:118``); the chunk changes only rounding. K9 runs
#: faster at 64 than at 128 on the card (its (Q, Q) products grow with the
#: chunk; PERF.md section 6), so the port keeps 64.
CHUNK = 64


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) without a cut-off (jax.nn.softplus's form; torch's
    ``softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
                    a: torch.Tensor, b_t: torch.Tensor,
                    c_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. state (B, H, P, N); x_t (B, H, P); dt_t (B, H);
    b_t/c_t (B, N). Returns (y_t (B, H, P) in x_t's dtype, new state fp32)."""
    dtf = dt_t.float()
    decay = torch.exp(dtf * a.float())  # (B, H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dtf, x_t.float(), b_t.float())
    new = decay[..., None, None] * state.float() + upd
    y = torch.einsum("bhpn,bn->bhp", new, c_t.float())
    return y.to(x_t.dtype), new


class Mamba(nn.Module):
    """in_proj -> causal depthwise conv -> SSD -> gated RMSNorm -> out_proj."""

    def __init__(self, cfg, *, generator: torch.Generator, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.in_proj = param(ninit((d, 2 * di + 2 * ns + nh), **kw))
        self.conv_w = param(ninit((cfg.ssm_conv, di + 2 * ns), scale=0.5, **kw))
        self.a_log = param(torch.zeros((nh,), dtype=torch.float32, device=device))  # A = -1
        self.dt_bias = param(torch.zeros((nh,), dtype=torch.float32, device=device))
        self.d_skip = param(torch.ones((nh,), dtype=torch.float32, device=device))
        self.norm = param(torch.zeros((di,), dtype=dtype, device=device))
        self.out_proj = param(ninit((di, d), **kw))

    def _split(self, zxbcdt: torch.Tensor, di: int | None = None):
        di, ns = di or self.cfg.d_inner, self.cfg.ssm_state
        return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * ns], zxbcdt[..., 2 * di + 2 * ns:]

    def _gate_out(self, y: torch.Tensor, z: torch.Tensor, p: dict) -> torch.Tensor:
        g = y * torch.nn.functional.silu(z)
        if tp.model_axis().size > 1:
            y = tp.rms_norm_model(g, p["norm"], self.cfg.norm_eps, self.cfg.d_inner)
        else:
            y = rms_norm(g, p["norm"], self.cfg.norm_eps)
        return y @ p["out_proj"]

    def _local(self) -> dict:
        """The leaves this rank computes with and its head count: the stored
        ones outside a sharded run. On a mesh, its share of the heads
        (``model``): ``in_proj``'s z, x and dt columns of those heads and
        the shared B, C columns (the [z | x B C | dt] layout cuts across
        ``model``'s blocks, so the matrix is gathered over ``model`` too),
        the conv's x channels of those heads and B, C, the per-head vectors
        and the norm gain sliced from their replicated leaves; ``out_proj``
        row-parallel."""
        cfg = self.cfg
        di, ns, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
        if tp.active() is None:
            return dict(in_proj=self.in_proj, conv_w=self.conv_w, a_log=self.a_log,
                        dt_bias=self.dt_bias, d_skip=self.d_skip, norm=self.norm,
                        out_proj=self.out_proj, nh=nh)
        h_lo, h_hi = tp.model_part(nh, "Mamba-2 heads")
        c_lo, c_hi = h_lo * hp, h_hi * hp
        w = tp.weight(self, "in_proj", gather_model=True)
        cw = tp.weight(self, "conv_w", gather_model=True)
        if tp.model_axis().size > 1:
            dt0 = 2 * di + 2 * ns
            w = torch.cat([w[:, c_lo:c_hi], w[:, di + c_lo:di + c_hi], w[:, 2 * di:dt0],
                           w[:, dt0 + h_lo:dt0 + h_hi]], dim=1)
            cw = torch.cat([cw[:, c_lo:c_hi], cw[:, di:]], dim=1)
        return dict(in_proj=w, conv_w=cw,
                    a_log=tp.copy_to_model(self.a_log)[h_lo:h_hi],
                    dt_bias=tp.copy_to_model(self.dt_bias)[h_lo:h_hi],
                    d_skip=tp.copy_to_model(self.d_skip)[h_lo:h_hi],
                    norm=tp.copy_to_model(self.norm)[c_lo:c_hi],
                    out_proj=tp.weight(self, "out_proj"), nh=h_hi - h_lo)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """Full sequence. u (B, S, d_model) -> (B, S, d_model)."""
        cfg = self.cfg
        bsz, s, _ = u.shape
        ns, hp, k = cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_conv
        p = self._local()
        nh = p["nh"]
        di = nh * hp
        z, xbc, dt = self._split(tp.copy_to_model(u) @ p["in_proj"], di)
        xbc_pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
        conv = xbc_pad[:, 0:s] * p["conv_w"][0]  # the reference's order of terms
        for i in range(1, k):
            conv = conv + xbc_pad[:, i:i + s] * p["conv_w"][i]
        conv = torch.nn.functional.silu(conv)
        x, b, c = conv[..., :di], conv[..., di:di + ns], conv[..., di + ns:]
        dt = softplus(dt.float() + p["dt_bias"])  # (B, S, nh)
        a = -torch.exp(p["a_log"])
        x = x.reshape(bsz, s, nh, hp)
        y, _ = ssd_ops.ssd(x.contiguous(), dt, a, b, c, chunk=CHUNK)
        y = y + x * p["d_skip"][None, None, :, None].to(y.dtype)
        return tp.reduce_from_model(self._gate_out(y.reshape(bsz, s, di), z, p))

    def decode(self, u_t: torch.Tensor, cache: dict) -> torch.Tensor:
        """One token. u_t (B, 1, d); ``cache`` {"conv": (B, k - 1, conv_dim),
        "state": (B, H, P, N) fp32} is updated in place. Returns (B, 1, d)."""
        if tp.active() is not None:
            return self._decode_sharded(u_t, cache)
        cfg = self.cfg
        bsz = u_t.shape[0]
        di, ns, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
        z, xbc, dt = self._split(u_t[:, 0] @ self.in_proj)  # (B, *)
        window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # (B, k, conv_dim)
        conv = torch.einsum("bkc,kc->bc", window.float(), self.conv_w.float()).to(u_t.dtype)
        conv = torch.nn.functional.silu(conv)
        x, b, c = conv[..., :di], conv[..., di:di + ns], conv[..., di + ns:]
        dtv = softplus(dt.float() + self.dt_bias)  # (B, nh)
        a = -torch.exp(self.a_log)
        y, new_state = ssd_decode_step(cache["state"], x.reshape(bsz, nh, hp), dtv, a, b, c)
        y = y + x.reshape(bsz, nh, hp) * self.d_skip[None, :, None].to(y.dtype)
        cache["conv"] = window[:, 1:]
        cache["state"] = new_state.to(cache["state"].dtype)
        return self._gate_out(y.reshape(bsz, di), z, self._local())[:, None, :]

    def _decode_sharded(self, u_t: torch.Tensor, cache: dict) -> torch.Tensor:
        """``decode`` on a mesh, the cache in ``cache_specs``' blocks: the
        conv window's channels and the state's heads over ``model``. The
        rank's ``in_proj`` columns give its block of the new token's
        [z | x B C | dt], gathered over ``model`` (an activation, where the
        forward gathers the matrix); the window's history is gathered too,
        since its channel blocks do not line up with the x / B / C split.
        The rank runs its heads (its x channels and the whole B, C), writes
        back its own block of the window and its heads' state, and its
        ``out_proj`` rows give a partial summed over ``model``."""
        cfg = self.cfg
        bsz = u_t.shape[0]
        di, ns, nh, hp, k = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim,
                             cfg.ssm_conv)
        width, conv_dim = 2 * di + 2 * ns + nh, di + 2 * ns
        h_lo, h_hi = tp.model_part(nh, "Mamba-2 heads")
        c_lo, c_hi = h_lo * hp, h_hi * hp
        block = cache["conv"].shape[-1]
        proj, hist = tp.model_blocks(u_t[:, 0] @ tp.weight(self, "in_proj"),
                                     cache["conv"].reshape(bsz, -1))
        z, xbc, dt = self._split(proj.reshape(bsz, -1)[:, :width])  # every channel, (B, *)
        hist = hist.reshape(bsz, -1, k - 1, block).transpose(1, 2).reshape(bsz, k - 1, -1)
        window = torch.cat([hist[..., :conv_dim], xbc[:, None, :]], dim=1)  # (B, k, conv_dim)
        def mine(t):  # the channels of this rank's heads: its x, and B and C
            return torch.cat([t[..., c_lo:c_hi], t[..., di:]], dim=-1)

        cw = mine(tp.weight(self, "conv_w", gather_model=True))
        conv = torch.einsum("bkc,kc->bc", mine(window).float(), cw.float()).to(u_t.dtype)
        conv = torch.nn.functional.silu(conv)
        nl, dl = h_hi - h_lo, c_hi - c_lo
        x, b, c = conv[..., :dl], conv[..., dl:dl + ns], conv[..., dl + ns:]
        dtv = softplus(dt[:, h_lo:h_hi].float() + self.dt_bias[h_lo:h_hi])  # (B, nl)
        a = -torch.exp(self.a_log[h_lo:h_hi])
        y, new_state = ssd_decode_step(cache["state"][:, :nl], x.reshape(bsz, nl, hp), dtv, a, b, c)
        y = y + x.reshape(bsz, nl, hp) * self.d_skip[h_lo:h_hi][None, :, None].to(y.dtype)
        lo = tp.model_axis().rank * block
        own = window[:, 1:, lo:lo + block]
        cache["conv"] = torch.nn.functional.pad(own, (0, block - own.shape[-1]))
        cache["state"][:, :nl] = new_state.to(cache["state"].dtype)
        out = self._gate_out(y.reshape(bsz, dl), z[:, c_lo:c_hi],
                             {"norm": self.norm[c_lo:c_hi],
                              "out_proj": tp.weight(self, "out_proj")})
        return tp.reduce_from_model(out)[:, None, :]
