"""Device meshes over ``torch.distributed`` (the counterpart of the JAX
package's ``launch/mesh.py``).

Every function needs an initialised process group (``torchrun``, or
``torch.distributed.init_process_group`` with its address, world size and
rank): one process per rank, each calling the same function.  None of
them starts a group itself, and none falls back to the CPU: the mesh's
device type is ``cuda`` unless the caller asks for ``cpu``, and rank r
runs on ``cuda:{r % torch.cuda.device_count()}``.

The production meshes are H100 analogues of the JAX package's TPU pod
shapes (16x16 and 2x16x16): 'model' stays inside one NVLink domain, the
8 GPUs of an HGX H100 node, so (32, 8) ``("data", "model")`` is 256 GPUs
(32 nodes) and (2, 32, 8) ``("pod", "data", "model")`` is 512.  The dry
run (``launch/dryrun.py``) builds them over a fake process group of that
world size.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _world_size() -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs an initialised process group: launch with "
            "torchrun, or call torch.distributed.init_process_group first")
    return dist.get_world_size()


MESH_NAMES = {False: "gpu32x8", True: "gpu2x32x8"}


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """The (32, 8) or, with ``multi_pod``, (2, 32, 8) mesh over an already
    initialised group of 256 or 512 ranks (a real one, or the dry run's
    fake one with ``device_type="cpu"``)."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape: tuple, axes: tuple, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over the ranks of the process group,
    its dims named ``axes``."""
    _world_size()
    device_type = device_type or "cuda"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass device_type='cpu' "
                               "to build the mesh on the CPU")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def host_device_mesh(n: Optional[int] = None, axis: str = "w",
                     device_type: Optional[str] = None):
    """1-D mesh over the group's ranks — the sharded engine's default shape
    (``QuegelEngine(mesh=host_device_mesh())``)."""
    return make_mesh((n or _world_size(),), (axis,), device_type)


def elastic_mesh(min_model: int = 4, device_type: Optional[str] = None):
    """The largest (data, model) mesh over the live ranks — jobs resume
    after losing hosts by rebuilding the mesh over the ranks left."""
    n = _world_size()
    model = min(min_model, n)
    while n % model and model > 1:
        model -= 1
    return make_mesh((n // model, model), ("data", "model"), device_type)

