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
mesh, or on a mesh of one rank, it returns ``x``. Executing the LM sharded
across ranks (FSDP and tensor parallelism over a ``DeviceMesh``) is not
ported (ROADMAP A), so on a mesh of more than one rank it raises rather
than run replicated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Iterator, Optional, Union

import torch

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
    outside a mesh or on a mesh of one rank. Raises NotImplementedError on a
    mesh of more ranks: the LM does not yet run sharded across ranks
    (ROADMAP A), and it never silently runs replicated."""
    ctx = get_mesh_ctx()
    if ctx is None or ctx.mesh is None:
        return x
    if x.ndim != len(logical):
        raise ValueError(f"{x.ndim}-d tensor given {len(logical)} logical axes {logical}")
    if mesh_size(ctx.mesh) == 1:
        return x
    raise NotImplementedError(
        f"shard{logical} on a mesh of {mesh_size(ctx.mesh)} ranks: executing the LM sharded "
        "across ranks is not ported yet (ROADMAP A)")
