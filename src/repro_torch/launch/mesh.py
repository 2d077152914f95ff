"""The meshes: the production mesh's shape and a host mesh over the ranks
of the initialised process group.

Counterpart of ``repro/launch/mesh.py``. These are functions, never module
state: importing this module touches no process group.

* ``production_mesh_shape(multi_pod)`` — (data=16, model=16), or (pod=2,
  data=16, model=16) across two pods. data carries FedALIGN clients (+FSDP
  for the largest archs), model is tensor / expert parallel, pod is more
  client parallelism. A shape only: ``sharding/specs.py`` and
  ``launch/dryrun.py`` read its ``.shape`` and ``axis_names``, so the 256 /
  512 devices need no process group.
* ``make_host_mesh(model_parallel=1, ...)`` — a
  ``torch.distributed.device_mesh.DeviceMesh`` over every rank of the
  process group: ("data", "model"), or ("pod", "data", "model") when
  ``pods`` is given.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshShape:
    """A mesh without devices: ``shape`` maps axis name -> size."""
    shape: dict
    axis_names: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def mesh_shape(**axes) -> MeshShape:
    """MeshShape(data=16, model=16) from keyword sizes, in their order."""
    return MeshShape(dict(axes), tuple(axes))


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (data=16, model=16). Two pods: (pod=2, data=16,
    model=16)."""
    if multi_pod:
        return mesh_shape(pod=2, data=16, model=16)
    return mesh_shape(data=16, model=16)


def make_host_mesh(model_parallel: int = 1, *, pods: int | None = None,
                   device_type: str = "cuda"):
    """A DeviceMesh over the process group's ranks, rank-major: ("data",
    "model") of (world / model_parallel, model_parallel), or, with
    ``pods``, ("pod", "data", "model") of (pods, world / (pods *
    model_parallel), model_parallel). The group must be initialised
    (``torch.distributed.init_process_group``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n % (model_parallel * (pods or 1)):
        raise ValueError(f"{n} ranks do not split into {pods} pod(s) x "
                         f"model_parallel={model_parallel}")
    data = n // (model_parallel * (pods or 1))
    if pods is not None:
        return init_device_mesh(device_type, (pods, data, model_parallel),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (data, model_parallel),
                            mesh_dim_names=("data", "model"))
