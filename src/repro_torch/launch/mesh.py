"""Device meshes: the production mesh's shape, a live mesh over the ranks of
this host, and their axis sizes.

The counterpart of ``repro.launch.mesh``. The reference lays a 16 x 16 (or
2 x 16 x 16) TPU mesh out over 256 (512) chips and shards each step over it
with GSPMD (``launch/shardings.py`` holds the port's copy of its rules).
Here ``make_production_mesh`` gives that mesh as a ``MeshShape``: its axis
names and sizes and nothing else, no process and no device, which is all
the dry run needs (the counterpart of the reference's mesh over 512 fake
host devices). ``make_local_mesh`` builds a live
``torch.distributed.device_mesh.DeviceMesh`` of shape
``(world // model_axis, model_axis)`` over the process group the caller has
already initialised, on the device type the caller names: ``"cuda"`` (one
card a rank, or ranks sharing a card over gloo) or ``"cpu"`` (gloo ranks on
the host, as the tests run it). Nothing here picks a backend or a device
type for the caller. ``close_mesh`` ends a rank's part in the process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


@dataclass(frozen=True)
class MeshShape:
    """A mesh that holds only its axis names and sizes (the attribute names
    of ``DeviceMesh``, so that ``mesh_axis_sizes`` reads either)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def mesh_shape(shape: Tuple[int, ...]) -> MeshShape:
    """A ``MeshShape`` under the reference's axis names: ``data``/``model``
    for two axes, ``pod``/``data``/``model`` for three."""
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return MeshShape(tuple(int(s) for s in shape), names)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    return mesh_shape((2, 16, 16) if multi_pod else (16, 16))


def make_local_mesh(model_axis: int = 1, *, backend: str):
    """A live ``(world // model_axis, model_axis)`` mesh named
    ``("data", "model")`` over the default process group, which the caller
    has initialised (``torch.distributed.init_process_group``). ``backend``
    is the mesh's device type, ``"cuda"`` or ``"cpu"``; on ``"cuda"`` each
    rank takes card ``rank % device_count`` first."""
    if backend not in ("cuda", "cpu"):
        raise ValueError(f"backend must be 'cuda' or 'cpu', not {backend!r}")
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh: initialise the process group first "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the world of "
                         f"{world} ranks")
    if backend == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(backend, (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a live mesh."""
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}


def close_mesh() -> None:
    """This rank's end of the default process group: a barrier, then
    ``destroy_process_group``. Without the barrier a rank that is through
    its last collective closes its connections while another rank still
    reads from them, and gloo aborts that rank (``terminate called without
    an active exception``, exit -6) after its work is done."""
    dist.barrier()
    dist.destroy_process_group()
