"""Production meshes.

The port of ``repro.launch.mesh``. Single pod: (data=16, model=16) = 256
ranks. Multi pod: (pod=2, data=16, model=16) = 512 ranks; the ``pod`` axis
is pure data parallelism (gradient all-reduce only, where
``runtime.compress`` applies). Pipeline: (pipe=4, data=8, model=16) = 512.

The ``make_*`` builders return a ``torch.distributed`` ``DeviceMesh`` over
the initialized process group and raise a ValueError naming the group's
size when it does not have the mesh's ranks. Each has a ``*_shape`` form,
a ``MeshShape`` with no ranks behind it, for the dry run. The builders are
functions: importing this module touches no device and no process group.

``init_from_env`` starts the group ``torchrun`` describes (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``). The transport is a rule, not a knob
(``backend_for``): NCCL when each rank of the host has a card of its own;
gloo on the CPU and when ranks share a card (NCCL refuses two ranks on one
device), the card's tensors then staged through host memory by the
collectives. ``rank_device`` maps a rank to its card: ``LOCAL_RANK``, or
card 0 when the host's ranks outnumber its cards.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..sharding.rules import MeshShape

PRODUCTION = {False: MeshShape(("data", "model"), (16, 16)),
              True: MeshShape(("pod", "data", "model"), (2, 16, 16))}
PIPELINE = MeshShape(("pipe", "data", "model"), (4, 8, 16))


def world_size() -> int:
    """Ranks of the initialized default group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _local() -> tuple[int, int]:
    """(LOCAL_RANK, LOCAL_WORLD_SIZE) from the environment (0, 1 without it)."""
    return int(os.environ.get("LOCAL_RANK", 0)), int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def backend_for(device_type: str) -> str:
    """``nccl`` when every rank of the host has a card of its own, else
    ``gloo`` (the CPU, or ranks sharing a card)."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if _local()[1] <= torch.cuda.device_count() else "gloo"


def rank_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK``, or ``cuda:0`` when the
    host's ranks outnumber its cards; the CPU for ``device_type`` "cpu"."""
    if device_type != "cuda":
        return torch.device(device_type)
    rank, ranks = _local()
    return torch.device("cuda", rank if ranks <= torch.cuda.device_count() else 0)


def init_from_env(device_type: str) -> bool:
    """Initialize the default group from ``torchrun``'s environment when it
    names more than one rank and none is initialized (the card set first,
    by ``rank_device``); True if a group of more than one rank exists."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return False
    if device_type == "cuda":
        _set_card()
    dist.init_process_group(backend_for(device_type), init_method="env://")
    return True


def _set_card() -> None:
    """Make ``rank_device`` this process's card and initialize CUDA on it, so
    that a ``DeviceMesh`` keeps it (it sets ``LOCAL_RANK``'s card otherwise,
    which does not exist when ranks share a card)."""
    if not torch.cuda.is_initialized():
        torch.cuda.set_device(rank_device("cuda"))
        torch.cuda.init()


def _device_mesh(shape: MeshShape, device_type: str):
    if world_size() != shape.size:
        raise ValueError(f"a {'x'.join(map(str, shape.sizes))} mesh needs {shape.size} ranks; "
                         f"the process group has {world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda":
        _set_card()
    return init_device_mesh(device_type, shape.sizes, mesh_dim_names=shape.axis_names)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    return PRODUCTION[multi_pod]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    return _device_mesh(production_mesh_shape(multi_pod=multi_pod), device_type)


def pipeline_mesh_shape() -> MeshShape:
    """Optional PP mesh: 512 = pipe(4) x data(8) x model(16)."""
    return PIPELINE


def make_pipeline_mesh(*, device_type: str = "cuda"):
    return _device_mesh(pipeline_mesh_shape(), device_type)


def local_mesh_shape(axes: tuple[str, ...] = ("data",)) -> MeshShape:
    """Every rank of the group on the first axis (a world of one without a
    group)."""
    return MeshShape(tuple(axes), (world_size(),) + (1,) * (len(axes) - 1))


def make_local_mesh(axes: tuple[str, ...] = ("data",), *, device_type: str = "cuda"):
    """All ranks of the group on the first axis (CPU tests / the core
    library): a ``DeviceMesh`` when a process group is initialized, else the
    ``MeshShape`` of a world of one."""
    shape = local_mesh_shape(axes)
    if not (dist.is_available() and dist.is_initialized()):
        return shape
    return _device_mesh(shape, device_type)
