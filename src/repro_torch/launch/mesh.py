"""Production meshes.

The port of ``repro.launch.mesh``. Single pod: (data=16, model=16) = 256
ranks. Multi pod: (pod=2, data=16, model=16) = 512 ranks; the ``pod`` axis
is pure data parallelism (gradient all-reduce only, where
``runtime.compress`` applies). Pipeline: (pipe=4, data=8, model=16) = 512.

The ``make_*`` builders return a ``torch.distributed`` ``DeviceMesh`` over
the initialized process group (one rank per card) and raise a ValueError
naming the group's size when it does not have the mesh's ranks. Each has a
``*_shape`` form, a ``MeshShape`` with no ranks behind it, for the dry run.
The builders are functions: importing this module touches no device and no
process group.
"""
from __future__ import annotations

import torch.distributed as dist

from ..sharding.rules import MeshShape

PRODUCTION = {False: MeshShape(("data", "model"), (16, 16)),
              True: MeshShape(("pod", "data", "model"), (2, 16, 16))}
PIPELINE = MeshShape(("pipe", "data", "model"), (4, 8, 16))


def world_size() -> int:
    """Ranks of the initialized default group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _device_mesh(shape: MeshShape, device_type: str):
    if world_size() != shape.size:
        raise ValueError(f"a {'x'.join(map(str, shape.sizes))} mesh needs {shape.size} ranks; "
                         f"the process group has {world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

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
