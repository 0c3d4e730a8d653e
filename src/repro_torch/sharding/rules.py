"""Logical-axis -> mesh-axis sharding rules.

The port of ``repro.sharding.rules``. Model code names each tensor dimension
by a *logical* axis ("batch", "fsdp", "model", ...); a ``MeshCtx`` maps
those onto whatever mesh is active:

  single pod   (data=16, model=16):        batch->data,  model dims->model
  multi pod    (pod=2, data=16, model=16): batch->(pod,data), model->model

A ``MeshCtx.mesh`` is either a ``torch.distributed`` ``DeviceMesh`` (ranks
that exist) or a ``MeshShape`` (axis names and sizes, no process group): a
256- or 512-rank mesh cannot be built on one host, and the dry run
(``launch.dryrun``) needs one to size every rank's shard.

``logical_to_spec`` gives the port's ``PartitionSpec``: per dimension a
mesh axis, a tuple of mesh axes or None (replicated), spelled as the
reference's ``tuple(jax.sharding.PartitionSpec(...))`` is (a single axis as
its name), so the two compare equal. ``placements`` turns one into the
DTensor ``Shard`` / ``Replicate`` list of a mesh, ``local_shape`` into one
rank's shard shape (DTensor's ceiling split).

``shard(x, *logical)`` is the reference's sharding constraint. Outside a
mesh, or on a mesh of one rank, it returns ``x``. On a ``DeviceMesh`` of
more ranks the LM runs sharded by explicit collectives
(``sharding.collectives``): every tensor the model holds there already is
its rank's block of the layout the constraint names, so ``shard`` returns
``x``. A ``MeshShape`` has no ranks: it sizes a deployment and does not run
one, so ``shard`` under one of more than one rank raises.

``serve_ctx`` is the reference's serve layout of a mesh: no FSDP, the
decode cache's sequence split over ``model`` (or, for one sequence, over
every rank), named by ``MeshCtx.kv_seq``.

``block`` cuts one rank's block of a full tensor under a spec (the ceiling
split, zero-padded to ``local_shape``, so that every rank holds
``local_shape``'s bytes); ``distribute_state`` does so for every leaf of a
tree (a one-rank ``TrainState``, a params dict) and ``gather_state``
assembles the full tree again on one rank, bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Iterator, Optional, Union

import torch
import torch.distributed as dist

# logical axis -> tuple of mesh axes (filtered by mesh at use time)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),  # weight dim sharded FSDP-style (train only)
    "model": ("model",),
    "seq_shard": ("data",),  # long-context decode: KV sequence dim
    "seq_shard_wide": ("data", "model"),  # batch=1 long-context: all chips
    "none": (),
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without ranks behind it."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.sizes)} sizes")

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


Mesh = Union[MeshShape, "torch.distributed.device_mesh.DeviceMesh"]


def mesh_axes(mesh: Mesh) -> dict[str, int]:
    """Axis name -> size of a ``MeshShape`` or a named ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh: Mesh) -> int:
    return math.prod(mesh_axes(mesh).values())


class PartitionSpec(tuple):
    """Per tensor dimension: None (replicated), a mesh axis, or a tuple of
    mesh axes. A one-axis tuple is stored as the axis, as JAX spells it."""

    def __new__(cls, *dims):
        return super().__new__(cls, (d[0] if isinstance(d, tuple) and len(d) == 1 else d
                                     for d in dims))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass
class MeshCtx:
    mesh: Optional[Mesh] = None
    rules: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    fsdp: bool = True  # False at serve time: weights replicated over data
    kv_seq: str = "none"  # the logical axis of the decode cache's sequence

    def axes(self, logical: Optional[str]) -> Optional[tuple[str, ...]]:
        if logical is None or self.mesh is None:
            return None
        if logical == "fsdp" and not self.fsdp:
            return None
        names = mesh_axes(self.mesh)
        ax = tuple(a for a in self.rules[logical] if a in names)
        return ax or None


_TLS = threading.local()


def set_mesh_ctx(ctx: Optional[MeshCtx]) -> None:
    _TLS.ctx = ctx


def get_mesh_ctx() -> Optional[MeshCtx]:
    return getattr(_TLS, "ctx", None)


def under_mesh_ctx(fn):
    """``fn`` run under the mesh ctx active now, whichever thread calls it:
    a layer recomputed in the backward (remat) runs on the autograd
    engine's device thread, which does not see this thread's ctx."""
    ctx = get_mesh_ctx()

    def run(*args, **kwargs):
        prev = get_mesh_ctx()
        set_mesh_ctx(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            set_mesh_ctx(prev)

    return run


def serve_ctx(mesh: Optional[Mesh], batch: int, *,
              rules: Optional[dict[str, tuple[str, ...]]] = None) -> MeshCtx:
    """The reference's serve layout (``launch.specs``) of a decode batch of
    ``batch`` sequences on ``mesh``: parameters replicated over ``data``
    (no FSDP) and split over ``model``; the decode cache's sequence over
    ``model`` ("seq_model", decode_32k's layout) with the batch over
    (``pod``, ``data``), or, for one sequence, over ``data`` and ``model``
    ("seq_shard_wide", long_500k's) with the batch unsplit. ``rules``: the
    rules to start from (``DEFAULT_RULES``)."""
    rules = dict(DEFAULT_RULES if rules is None else rules)
    rules["seq_model"] = ("model",)
    if batch == 1:
        rules["batch"] = ()  # batch = 1: nothing to shard
    return MeshCtx(mesh=mesh, rules=rules, fsdp=False,
                   kv_seq="seq_shard_wide" if batch == 1 else "seq_model")


@contextlib.contextmanager
def activate_mesh(mesh: Mesh) -> Iterator[MeshCtx]:
    """Make ``mesh`` the active mesh (a fresh ``MeshCtx`` of it) for the
    ``with`` block; the previous ctx comes back after it."""
    prev = get_mesh_ctx()
    ctx = MeshCtx(mesh=mesh)
    set_mesh_ctx(ctx)
    try:
        yield ctx
    finally:
        set_mesh_ctx(prev)


def logical_to_spec(*logical: Optional[str], ctx: Optional[MeshCtx] = None) -> PartitionSpec:
    """PartitionSpec from per-dimension logical names (None = replicated)."""
    ctx = ctx or get_mesh_ctx()
    if ctx is None or ctx.mesh is None:
        return PartitionSpec()
    return PartitionSpec(*(ctx.axes(l) for l in logical))


def _spec_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: PartitionSpec, mesh: Mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh axis
    ``Shard(i)`` when tensor dimension i is split over it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh_axes(mesh):
        dims = [i for i, e in enumerate(spec) if name in _spec_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_shape(shape, spec: PartitionSpec, mesh: Mesh) -> tuple[int, ...]:
    """One rank's shard of a tensor of ``shape`` under ``spec`` on ``mesh``:
    each dimension divided, rounded up, by the sizes of the mesh axes it is
    split over (DTensor's split; the first ranks hold the larger pieces)."""
    sizes = mesh_axes(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more dimensions than shape {tuple(shape)}")
    out = list(shape)
    for i, entry in enumerate(spec):
        ways = math.prod(sizes[a] for a in _spec_axes(entry))
        out[i] = -(-out[i] // ways)
    return tuple(out)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint by logical axes: ``x`` itself
    outside a mesh, on a mesh of one rank and on a ``DeviceMesh`` (where
    ``x`` is already its rank's block: the sharded model's collectives put
    it there). Raises NotImplementedError under a ``MeshShape`` of more
    ranks: it has no ranks to run on, and nothing runs replicated under a
    mesh's name."""
    ctx = get_mesh_ctx()
    if ctx is None or ctx.mesh is None:
        return x
    if x.ndim != len(logical):
        raise ValueError(f"{x.ndim}-d tensor given {len(logical)} logical axes {logical}")
    if isinstance(ctx.mesh, MeshShape) and mesh_size(ctx.mesh) > 1:
        raise NotImplementedError(
            f"shard{logical} under a MeshShape of {mesh_size(ctx.mesh)} ranks: a MeshShape "
            "sizes a deployment and has no ranks to run one; run on a DeviceMesh")
    return x


# -- one rank's block of a full tensor, and back ------------------------------------------


def mesh_coords(mesh: Mesh, rank: Optional[int] = None) -> dict[str, int]:
    """Axis name -> coordinate of global ``rank`` (this process's rank by
    default) on a ``DeviceMesh``; all zeros on a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return dict.fromkeys(mesh.axis_names, 0)
    rank = dist.get_rank() if rank is None else rank
    where = (mesh.mesh == rank).nonzero()
    if where.shape[0] != 1:
        raise ValueError(f"rank {rank} is not on the mesh {mesh}")
    return dict(zip(mesh.mesh_dim_names, (int(c) for c in where[0])))


def _ways(entry, sizes: dict[str, int], coords: dict[str, int]) -> tuple[int, int]:
    """(pieces, this rank's piece) of a dimension split over ``entry``'s
    axes, the first axis the slowest."""
    ways, index = 1, 0
    for a in _spec_axes(entry):
        ways, index = ways * sizes[a], index * sizes[a] + coords[a]
    return ways, index


def block(full, spec: PartitionSpec, mesh: Mesh, coords: Optional[dict[str, int]] = None):
    """The block of ``full`` (a tensor or a numpy array, a memory map too)
    that the rank at ``coords`` holds under ``spec`` (this process's rank on
    a ``DeviceMesh`` by default): per split dimension the ceiling piece
    ``local_shape`` gives, the last pieces zero-padded to it."""
    sizes = mesh_axes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    shape = local_shape(full.shape, spec, mesh)
    index, pad = [], []
    for i, entry in enumerate(spec):
        ways, k = _ways(entry, sizes, coords)
        lo = min(k * shape[i], full.shape[i])
        hi = min(lo + shape[i], full.shape[i])
        index.append(slice(lo, hi))
        pad.append(shape[i] - (hi - lo))
    part = full[tuple(index)] if index else full
    if not isinstance(part, torch.Tensor):
        import numpy as np

        part = torch.from_numpy(np.array(part, copy=True))
    if any(pad):
        out = part.new_zeros(shape)
        out[tuple(slice(0, n) for n in part.shape)] = part
        return out
    return part


def _tree_specs(tree: Any, specs: Any) -> list[tuple[Any, PartitionSpec]]:
    """(leaf, spec) pairs of ``tree`` against ``specs``, a tree of the same
    structure with a spec for every tensor leaf (a missing one raises: no
    leaf is replicated by default)."""
    from ..checkpoint.ckpt import _leaves

    spec_of = dict(_leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec)))
    out = []
    for p, leaf in _leaves(tree):
        if p not in spec_of and isinstance(leaf, torch.Tensor):
            raise KeyError(f"no PartitionSpec for the leaf {'/'.join(p)}")
        out.append((leaf, spec_of.get(p, PartitionSpec())))
    return out


def distribute_state(state: Any, specs: Any, mesh: Mesh) -> Any:
    """``state`` (the same full tree on every rank: a ``TrainState``, a
    params dict) cut to this rank's blocks under ``specs`` (a tree of the
    same structure), each a fresh contiguous tensor on its leaf's device
    with ``local_shape``'s shape (zero-padded where a dimension does not
    divide). Non-tensor leaves and replicated tensors are copied."""
    from ..checkpoint.ckpt import _rebuild

    coords = mesh_coords(mesh)
    out = []
    for leaf, spec in _tree_specs(state, specs):
        if isinstance(leaf, torch.Tensor):
            with torch.no_grad():
                t = block(leaf.detach(), spec, mesh, coords).clone(memory_format=torch.contiguous_format)
            out.append(t.requires_grad_(leaf.requires_grad))
        else:
            out.append(leaf)
    return _rebuild(state, iter(out))


def gather_state(state: Any, specs: Any, mesh: Mesh, like: Any, *,
                 dst: int = 0) -> Optional[Any]:
    """The full tree of a distributed ``state`` (each rank's blocks under
    ``specs``) on global rank ``dst``, as CPU tensors cut to the shapes of
    ``like``'s leaves (a tree of the same structure: the one-rank state, or
    its stand-in on the meta device), padding dropped: the inverse of
    ``distribute_state``, bit for bit. Other ranks get None. Every rank
    must call it (one ``gather`` over the world per split leaf: the card's
    tensors under NCCL, host tensors under gloo); replicated leaves come
    from ``dst``'s own copy."""
    from ..checkpoint.ckpt import _leaves, _rebuild

    pairs = _tree_specs(state, specs)
    shapes = [tuple(t.shape) if isinstance(t, torch.Tensor) else None for _, t in _leaves(like)]
    if len(shapes) != len(pairs):
        raise ValueError(f"like has {len(shapes)} leaves, the state {len(pairs)}")
    if isinstance(mesh, MeshShape):
        if mesh.size > 1:
            raise ValueError("gather_state needs the ranks of a DeviceMesh")
        me, world = 0, 1
    else:
        me, world = dist.get_rank(), dist.get_world_size()
    coords = [mesh_coords(mesh, r) for r in range(world)] if world > 1 else [mesh_coords(mesh)]
    sizes = mesh_axes(mesh)
    out = []
    for (leaf, spec), shape in zip(pairs, shapes):
        if not isinstance(leaf, torch.Tensor):
            out.append(leaf)
            continue
        if world == 1 or not any(_spec_axes(e) for e in spec):
            host = leaf.detach().cpu()
            out.append(host[tuple(slice(0, n) for n in shape)].clone() if me == dst else None)
            continue
        nccl = leaf.device.type == "cuda" and dist.get_backend() == "nccl"
        wire = leaf.detach().contiguous() if nccl else leaf.detach().cpu().contiguous()
        parts = [torch.empty_like(wire) for _ in range(world)] if me == dst else None
        dist.gather(wire, parts, dst=dst)
        if me != dst:
            out.append(None)
            continue
        host = wire.cpu()
        parts = [p.cpu() for p in parts]
        whole = host.new_empty(shape)
        for r, part in enumerate(parts):
            index, src = [], []
            for i, n in enumerate(shape):
                k = _ways(spec[i], sizes, coords[r])[1] if i < len(spec) else 0
                lo = min(k * host.shape[i], n)
                hi = min(lo + host.shape[i], n)
                index.append(slice(lo, hi))
                src.append(slice(0, hi - lo))
            whole[tuple(index)] = part[tuple(src)]
        out.append(whole)
    if me != dst:
        return None
    return _rebuild(state, iter(out))
