"""Explicit collectives of the LM's sharded execution.

The reference runs its train step under ``jax.jit`` on a mesh and XLA's
partitioner inserts the collectives its ``shard()`` constraints and
parameter specs imply. PyTorch has no such partitioner, so the port spells
them out (this module has no reference counterpart). On a ``DeviceMesh``
of axes (``data``, ``model``) (and ``pod``, pure data parallelism):

- every leaf is stored as its rank's block under ``param_specs``: FSDP
  over ``data``, tensor parallelism over ``model``;
- ``weight`` gathers a leaf over ``data`` where it is used (an all-gather
  in the forward, a reduce-scatter of its gradient in the backward, inside
  the layer's remat region, so a recomputed layer gathers again); with
  ``gather_model`` over ``model`` too, where the model's blocks do not line
  up with the heads a rank computes (gemma-2b's one kv head, Mamba-2's
  [z | x B C | dt] ``in_proj`` and its conv);
- ``copy_to_model`` (identity forward, all-reduce over ``model`` of the
  gradient) enters a column-parallel region and ``reduce_from_model``
  (all-reduce forward, identity backward) leaves a row-parallel product;
  a replicated leaf that each rank uses a part of (Mamba-2's per-head
  vectors, qk-norm gains) enters through ``copy_to_model`` too;
- ``rms_norm_model`` is the RMSNorm of a hidden state split over ``model``
  (Mamba-2's gated norm): its mean of squares summed over ``model``;
- ``vocab_nll`` is the cross-entropy of a vocabulary split over ``model``:
  the max, the sum of exponentials and the label's logit reduced over it;
- decode under ``rules.serve_ctx``'s layout: ``model_blocks`` gathers
  column-split activations (the new token's q, k and v; Mamba-2's
  projection and conv window; the logits' vocabulary) over ``model`` in
  one collective, ``merge_attention`` merges each rank's
  attention over its block of the cache's sequence by log-sum-exp in the
  blocks' order, ``argmax_over_model`` takes the greedy token of a
  vocabulary split over ``model`` (ties to the lower index),
  ``gather_batch`` gathers the sampled tokens over the batch axes and
  ``gather_kv_seq`` a cache's sequence over its axes (BLESS compression);
- ``finish_grads`` sums each gradient over the batch axes it is not
  already reduced over (replicated leaves over ``data``, every leaf over
  ``pod``), and ``global_norm`` counts each element of the sharded
  gradients once.

Every collective goes through the ``torch.distributed`` namespace at call
time (so ``launch.roofline.CollectiveMeter`` counts it). Sums run in fp32.
The gather and the reduce-scatter are one ``all_to_all_single`` each on
every backend (the block sent to every rank; each rank's pieces summed
here in rank order, on the tensor's device): gloo's own all-gather and
reduce-scatter ran 2.7-8x slower than its all-to-all on the H100's host
(PERF.md section 6), and a sum in rank order is the same whatever the
transport's topology. Only the staging depends on the backend: NCCL takes
the card's tensors; a gloo group takes host tensors only, so CUDA tensors
are staged through pinned host buffers, kept by the plan and reused
(the rule of ``training.pipeline`` and ``core.distributed``), while the
compute stays on the card. Every reduction is in a fixed order for a fixed mesh: no
float atomics.

``active()`` is None outside a mesh and on a mesh of one rank, where the
model runs its plain code; under a ``MeshShape`` of more ranks it raises
(a ``MeshShape`` has no ranks to run on).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..kernels.common import pad_dim
from .rules import MeshCtx, MeshShape, _spec_axes, get_mesh_ctx, logical_to_spec, mesh_axes


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its group, size and coordinate,
    and the plan's pinned host buffers for staged collectives ((dtype,
    "send" | "recv") -> a flat buffer grown to the largest call and kept:
    every collective here ends with its copies done, so the next one may
    reuse it)."""

    name: str
    group: Any
    size: int
    rank: int
    host: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)


_NONE = Axis("", None, 1, 0)


class Plan:
    """The active ``DeviceMesh`` as the sharded model uses it."""

    def __init__(self, ctx: MeshCtx):
        mesh = ctx.mesh
        self.ctx = ctx
        host: dict = {}
        self.axes = {n: Axis(n, mesh.get_group(n), s, mesh.get_local_rank(n), host)
                     for n, s in mesh_axes(mesh).items()}
        model = [self.axes[a] for a in ctx.rules["model"] if a in self.axes]
        self.model = model[0] if model else _NONE
        self.batch = [self.axes[a] for a in ctx.rules["batch"] if a in self.axes]
        self.kv = [self.axes[a] for a in ctx.axes(ctx.kv_seq) or ()]
        if any(ax is self.model for ax in self.kv[:-1]):
            raise NotImplementedError(f"the decode cache's sequence over {ctx.axes(ctx.kv_seq)}: "
                                      "model must be its last (fastest) axis")

    @property
    def batch_ways(self) -> int:
        """Ranks the batch rows are split over."""
        n = 1
        for ax in self.batch:
            n *= ax.size
        return n

    @property
    def batch_index(self) -> int:
        """This rank's piece of the batch rows (the first axis the slowest)."""
        i = 0
        for ax in self.batch:
            i = i * ax.size + ax.rank
        return i

    @property
    def kv_ways(self) -> int:
        """Ranks the decode cache's sequence is split over."""
        n = 1
        for ax in self.kv:
            n *= ax.size
        return n

    @property
    def kv_index(self) -> int:
        """This rank's block of the decode cache's sequence (the first axis
        the slowest)."""
        i = 0
        for ax in self.kv:
            i = i * ax.size + ax.rank
        return i

    def spec(self, logical: tuple) -> tuple:
        return tuple(logical_to_spec(*logical, ctx=self.ctx))


def active() -> Optional[Plan]:
    """The plan of the active mesh: None outside a mesh or on one rank."""
    ctx = get_mesh_ctx()
    if ctx is None or ctx.mesh is None:
        return None
    if isinstance(ctx.mesh, MeshShape):
        if ctx.mesh.size > 1:
            raise NotImplementedError(
                f"a MeshShape of {ctx.mesh.size} ranks sizes a deployment and has no ranks to "
                "run one; run under a DeviceMesh")
        return None
    if ctx.mesh.size() == 1:
        return None
    plan = ctx.__dict__.get("_plan")
    if plan is None:
        plan = ctx.__dict__["_plan"] = Plan(ctx)
    return plan


# -- transport --------------------------------------------------------------------------------


def _staged(t: torch.Tensor, ax: Axis) -> bool:
    """``t`` lies on the card and ``ax``'s group is gloo, which takes host
    tensors only."""
    return t.device.type == "cuda" and dist.get_backend(ax.group) == "gloo"


def _host(ax: Axis, t: torch.Tensor, which: str) -> torch.Tensor:
    """A pinned host buffer of ``t``'s shape and dtype from ``ax.host`` (so
    the card's copies to and from it run at the bus's rate), reused across
    calls."""
    buf = ax.host.get((t.dtype, which))
    if buf is None or buf.numel() < t.numel():
        ax.host.pop((t.dtype, which), None)
        buf = ax.host[(t.dtype, which)] = torch.empty(t.numel(), dtype=t.dtype,
                                                      pin_memory=True)
    return buf[:t.numel()].view(t.shape)


def _buffers(send: torch.Tensor, ax: Axis) -> tuple[torch.Tensor, torch.Tensor]:
    """(the wire's send buffer holding ``send``, an empty receive buffer of
    its size): pinned host buffers for a staged ``send``, else ``send``
    itself and a new tensor beside it."""
    if _staged(send, ax):
        return _host(ax, send, "send").copy_(send), _host(ax, send, "recv")
    return send, torch.empty_like(send)


def _all_to_all(send: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``dist.all_to_all_single`` of ``send`` (its first dimension in
    ``ax.size`` pieces, piece r to rank r) over ``ax``: on the tensor's
    device, every rank's piece for this rank in rank order. The gathers and
    reduce-scatters of this module are this one collective on every
    backend: over gloo the card's tensors are staged through pinned host
    memory."""
    wire, recv = _buffers(send.contiguous(), ax)
    dist.all_to_all_single(recv, wire, group=ax.group)
    return recv.to(send.device)


def _all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The blocks of ``ax``'s ranks concatenated along ``dim``: this rank's
    block sent to every rank."""
    blk = x.detach().movedim(dim, 0)
    send = blk.new_empty((ax.size,) + tuple(blk.shape))
    send.copy_(blk.expand_as(send))
    out = _all_to_all(send, ax)
    return out.reshape((-1,) + tuple(blk.shape[1:])).movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the fp32 sum over ``ax``: every
    rank's piece of this block, summed in rank order."""
    full = x.detach().movedim(dim, 0).float()
    parts = _all_to_all(full.reshape((ax.size, -1) + tuple(full.shape[1:])), ax)
    out = parts[0].clone()
    for r in range(1, ax.size):
        out += parts[r]
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, ax: Axis, op=None) -> torch.Tensor:
    """The fp32 reduction (a sum by default) of ``x`` over ``ax``."""
    t = x.detach().float().contiguous()
    wire = _host(ax, t, "send").copy_(t) if _staged(t, ax) else t.clone()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM if op is None else op, group=ax.group)
    return wire.to(x.device)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` (cut to ``full``); backward: reduce-scatter."""

    @staticmethod
    def forward(ctx, x, ax, dim, full):
        ctx.ax, ctx.dim, ctx.local, ctx.dtype = ax, dim, x.shape[dim], x.dtype
        return _all_gather(x, ax, dim).narrow(dim, 0, full)

    @staticmethod
    def backward(ctx, g):
        g = pad_dim(g, ctx.dim, ctx.ax.size * ctx.local)
        return _reduce_scatter(g, ctx.ax, ctx.dim).to(ctx.dtype), None, None, None


class _CopyTo(torch.autograd.Function):
    """Identity; backward: all-reduce over the axis."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax).to(g.dtype), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce over the axis; backward: identity."""

    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


# -- what the model calls ---------------------------------------------------------------------


def weight(module: torch.nn.Module, name: str, *, gather_model: bool = False) -> torch.Tensor:
    """The leaf ``name`` of ``module`` as this rank computes with it: the
    stored tensor outside a sharded run; on a mesh, gathered over every
    batch-side axis its spec splits it over (``data``), the ``model`` block
    kept unless ``gather_model``. ``module.shard_layout[name]`` holds the
    leaf's full shape and logical axes (``models.LM`` sets it)."""
    p = getattr(module, name)
    plan = active()
    if plan is None:
        return p
    shape, logical = module.shard_layout[name]
    spec = plan.spec(logical)
    later = []
    for dim, entry in enumerate(spec):
        axes = _spec_axes(entry)
        if len(axes) > 1:
            raise NotImplementedError(f"{name}: dimension {dim} split over {axes}")
        for a in axes:
            ax = plan.axes[a]
            if ax.size == 1:
                continue
            if ax is plan.model:
                if gather_model:
                    later.append((dim, ax))
                continue
            p = _Gather.apply(p, ax, dim, shape[dim])
    for dim, ax in later:
        p = _Gather.apply(p, ax, dim, shape[dim])
    return p


def model_part(n: int, what: str) -> tuple[int, int]:
    """[lo, hi) of the ``n`` units (Mamba-2 heads) this rank computes: the
    ``model`` rank's contiguous share; ``(0, n)`` outside a sharded run.
    Raises NotImplementedError when ``n`` does not divide over ``model``
    (the reference's partitioner splits them unevenly; every configuration
    of the repo divides over each axis that divides 16). Attention's padded
    q heads go by ``models.model.head_share``."""
    plan = active()
    m = plan.model if plan is not None else _NONE
    if n % m.size:
        raise NotImplementedError(
            f"{n} {what} over a model axis of {m.size}: the port splits them only evenly")
    per = n // m.size
    return m.rank * per, (m.rank + 1) * per


def model_axis() -> Axis:
    """The ``model`` axis of the active mesh (size 1 outside one)."""
    plan = active()
    return plan.model if plan is not None else _NONE


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering a region split over ``model``: the identity, whose
    gradient is summed over ``model`` (each rank's is a part)."""
    ax = model_axis()
    return x if ax.size == 1 else _CopyTo.apply(x, ax)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of each rank's partial product (a row-parallel
    output); the gradient passes unchanged."""
    ax = model_axis()
    return x if ax.size == 1 else _ReduceFrom.apply(x, ax)


class _RmsNormModel(torch.autograd.Function):
    """``layers._RmsNorm`` over a last dimension split across ``model``."""

    @staticmethod
    def forward(ctx, x, gamma, eps, ax, d_total):
        xf = x.float()
        inv = torch.rsqrt(_all_reduce(torch.sum(xf * xf, -1, keepdim=True), ax) / d_total + eps)
        ctx.save_for_backward(x, gamma, inv)
        ctx.ax, ctx.d_total = ax, d_total
        return (xf * inv * (1.0 + gamma.float())).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, inv = ctx.saved_tensors
        xhat = x.float() * inv
        dxhat = dy.float() * (1.0 + gamma.float())
        mean = _all_reduce(torch.sum(dxhat * xhat, -1, keepdim=True), ctx.ax) / ctx.d_total
        dx = inv * (dxhat - xhat * mean)
        dgamma = torch.sum(dy.float() * xhat, dim=tuple(range(x.ndim - 1)))
        return dx.to(x.dtype), dgamma.to(gamma.dtype), None, None, None


def rms_norm_model(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                   d_total: int) -> torch.Tensor:
    """RMSNorm with a (1 + gamma) gain of a hidden state whose last
    dimension (``d_total`` wide in all) is split over ``model``: ``x`` and
    ``gamma`` are this rank's channels."""
    return _RmsNormModel.apply(x, gamma, eps, model_axis(), d_total)


class _VocabNll(torch.autograd.Function):
    """-sum of the log-likelihoods of fp32 logits whose vocabulary is split
    over ``model`` (this rank's columns start at ``lo``)."""

    @staticmethod
    def forward(ctx, logits, labels, lo, ax):
        cols = logits.shape[-1]
        mx = _all_reduce(torch.amax(logits, -1, keepdim=True), ax, dist.ReduceOp.MAX)
        e = torch.exp(logits - mx)
        total = _all_reduce(torch.sum(e, -1, keepdim=True), ax)
        loc = labels - lo
        inside = (loc >= 0) & (loc < cols)
        idx = loc.clamp(0, cols - 1)[..., None]
        picked = torch.where(inside, torch.gather(logits, -1, idx)[..., 0],
                             logits.new_zeros(()))
        ll = _all_reduce(picked, ax) - (mx + torch.log(total))[..., 0]
        ctx.save_for_backward(e, total, idx, inside)
        return -torch.sum(ll)

    @staticmethod
    def backward(ctx, g):
        e, total, idx, inside = ctx.saved_tensors
        p = e / total
        d = torch.scatter(p, -1, idx, torch.gather(p, -1, idx) - inside[..., None].float())
        return d * g, None, None, None


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor, lo: int) -> torch.Tensor:
    """-sum of log softmax(logits)[label] for fp32 ``logits`` (..., cols)
    holding this rank's vocabulary columns [lo, lo + cols): the same on
    every ``model`` rank."""
    return _VocabNll.apply(logits, labels, lo, model_axis())


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, lo: int) -> torch.Tensor:
    """Rows ``tokens`` of an embedding whose vocabulary rows are split over
    ``model`` (``table`` holds rows [lo, lo + len)): each rank looks up the
    tokens it holds, zeros elsewhere, summed over ``model``."""
    loc = tokens - lo
    inside = ((loc >= 0) & (loc < table.shape[0]))[..., None]
    rows = table[loc.clamp(0, table.shape[0] - 1)]
    return reduce_from_model(torch.where(inside, rows, rows.new_zeros(())))


# -- decode -----------------------------------------------------------------------------------


def model_blocks(*xs: torch.Tensor) -> list[torch.Tensor]:
    """Every ``model`` rank's block of each (rows, w_i) ``x`` (an activation
    this rank computed from its block of a column-split weight), in one
    collective for all of them: (rows, ranks, w_i) each, in rank order."""
    ax = model_axis()
    if ax.size == 1:
        return [x[:, None] for x in xs]
    widths = [x.shape[-1] for x in xs]
    both = _all_gather(torch.cat(xs, dim=-1), ax, 1)
    return list(torch.split(both.reshape(both.shape[0], ax.size, -1), widths, dim=-1))


def merge_attention(acc: torch.Tensor, mx: torch.Tensor, den: torch.Tensor, heads: slice,
                    dtype: torch.dtype) -> torch.Tensor:
    """Decode attention of the whole cache from each rank's partial over
    its block of the sequence (``models.attention.decode_attention_partial``:
    ``acc`` (B, Hq, D) the unnormalised sum, ``mx`` and ``den`` (B, Hq) the
    running max and sum of exponentials, every head): this rank's ``heads``
    (B, h, D) in ``dtype``. The partials of those heads come from every
    rank of the cache's sequence axes (an all-to-all over ``model`` when
    the sequence is split there, each rank sending every other its heads,
    then a gather over the others) and are merged in the order of the
    sequence's blocks: out = sum_r e^(m_r - M) acc_r / sum_r e^(m_r - M) l_r."""
    plan = active()
    part = torch.cat([acc, mx[..., None], den[..., None]], dim=-1).float()  # (B, Hq, D + 2)
    b, hq, w = part.shape
    kv = plan.kv if plan is not None else []
    if kv and kv[-1] is plan.model and plan.model.size > 1:
        m = plan.model
        send = part.reshape(b, m.size, hq // m.size, w).transpose(0, 1)
        parts = _all_to_all(send, m)  # (model ranks, B, h, D + 2): their blocks, my heads
        kv = kv[:-1]
    else:
        parts = part[None, :, heads]
    for ax in reversed(kv):  # the faster axes gathered first: the slowest ends outermost
        if ax.size > 1:
            parts = _all_gather(parts, ax, 0)
    acc, mx, den = parts[..., :-2], parts[..., -2], parts[..., -1]
    top = torch.amax(mx, dim=0)
    scale = torch.exp(mx - top)  # a block with no valid row: e^(-1e30 - M) = 0
    out = torch.sum(scale[..., None] * acc, dim=0) / torch.sum(scale * den, dim=0)[..., None]
    return out.to(dtype)


def argmax_over_model(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The index of the largest of each row's ``model``-rank maxima
    (``values``, each rank's largest over its vocabulary block, ``index``
    its global column): gathered over ``model``, the first rank's on a tie,
    which is the lower index, as ``torch.argmax`` takes."""
    ax = model_axis()
    if ax.size == 1:
        return index
    pairs = _all_gather(torch.stack([values.double(), index.double()])[None], ax, 0)
    best = torch.argmax(pairs[:, 0], dim=0)  # (rows,): the first rank holding the max
    return torch.gather(pairs[:, 1], 0, best[None])[0].long()


def gather_kv_seq(x: torch.Tensor) -> torch.Tensor:
    """A decode cache's blocks (B, S, ...) of every rank of its sequence
    axes (``rules.serve_ctx``'s ``model``, or ``data`` x ``model``)
    concatenated along S in the sequence's order (``x`` holds this rank's
    block), contiguous: the whole sequence on every rank."""
    plan = active()
    if plan is None:
        return x
    for ax in reversed(plan.kv):  # the faster axes gathered first
        if ax.size > 1:
            x = _all_gather(x, ax, 1)
    return x.contiguous()


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The rows of every rank of the batch axes, in batch order (``x``
    holds this rank's): the full batch on every rank."""
    plan = active()
    if plan is None:
        return x
    for ax in reversed(plan.batch):
        if ax.size > 1:
            x = _all_gather(x, ax, 0)
    return x


# -- the train step ---------------------------------------------------------------------------


def sum_over_batch(x: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of ``x`` over the batch axes (a loss share -> the loss)."""
    plan = active()
    if plan is None:
        return x
    for ax in plan.batch:
        if ax.size > 1:
            x = _all_reduce(x, ax)
    return x


def finish_grads(grads: dict[str, torch.Tensor],
                 logical: dict[str, tuple]) -> dict[str, torch.Tensor]:
    """Sum each gradient over the batch axes its leaf is not split over
    (the reduce-scatter of a gather already summed it over those it is):
    replicated leaves over ``data``, every leaf over ``pod``. One fp32
    all-reduce per axis of the leaves that need it, flattened in name
    order."""
    plan = active()
    if plan is None:
        return grads
    out = dict(grads)
    for ax in plan.batch:
        if ax.size == 1:
            continue
        names = [k for k in grads if ax.name not in
                 {a for e in plan.spec(logical[k]) for a in _spec_axes(e)}]
        if not names:
            continue
        flat = _all_reduce(torch.cat([out[k].reshape(-1).float() for k in names]), ax)
        for k, part in zip(names, torch.split(flat, [out[k].numel() for k in names])):
            out[k] = part.reshape(out[k].shape).to(out[k].dtype)
    return out


def global_norm(grads: dict[str, torch.Tensor], logical: dict[str, tuple]) -> torch.Tensor:
    """sqrt of the squared sum of the full gradients, each element counted
    once: the local fp32 squared sums grouped by the mesh axes the leaf is
    split over, each group summed over its axes (one all-reduce per axis,
    the other groups' entries masked), the groups added in a fixed order."""
    plan = active()
    if plan is None:
        from ..optim import global_norm as plain

        return plain(grads)
    split = {}
    for k in grads:
        axes = {a for e in plan.spec(logical[k]) for a in _spec_axes(e)}
        split[k] = tuple(a for a, ax in plan.axes.items() if a in axes and ax.size > 1)
    keys = sorted(set(split.values()))
    sums = []
    for key in keys:
        parts = [torch.sum(torch.square(grads[k].float())) for k in grads if split[k] == key]
        sums.append(torch.sum(torch.stack(parts)))
    vec = torch.stack(sums)
    for name, ax in plan.axes.items():
        mask = torch.tensor([name in key for key in keys], device=vec.device)
        if ax.size > 1 and bool(mask.any()):
            vec = torch.where(mask, _all_reduce(torch.where(mask, vec, 0.0), ax), vec)
    return torch.sqrt(torch.sum(vec))
