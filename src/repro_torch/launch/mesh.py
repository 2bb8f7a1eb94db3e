"""Device meshes; the port's copy of the JAX package's ``launch/mesh.py``.

Functions, not module-level state: importing this module touches no
process group and no device.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialized world
(``torch.distributed.init_process_group``, which the caller runs with its
own address, world size and rank), with the JAX package's axis names.
``device_type`` defaults to ``"cuda"``: a mesh runs on the card unless
the caller asks for the CPU (``device_type="cpu"``, the ``gloo`` ranks of
the tests).

The ambient mesh is the one of the innermost ``with mesh:`` block, as a
``jax.sharding.Mesh`` context is in the JAX package.  ``ambient_mesh``
reads it; ``distributed.sharding.constrain`` and ``nn.ssm``'s
sequence-parallel route are its only readers.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, _mesh_resources, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod.  The world
    must have exactly that many ranks: real ones, or a ``fake`` process
    group's (the dry run, ``launch.dryrun``), whose ranks all live in this
    process on its one card."""
    shape, names = PRODUCTION[multi_pod]
    device_type = device_type or "cuda"
    if device_type == "cuda" and dist.get_backend() == "fake":
        # a fake world on one card (the dry run): every rank is this
        # process, on its current card; torch 2.11's mesh would otherwise
        # pick a card by rank % cards
        torch.cuda.set_device(torch.cuda.current_device())
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_local_mesh(model_degree: int = 1,
                    device_type: Optional[str] = None) -> DeviceMesh:
    """The whole world as ``(world // model_degree, model_degree)``
    ``("data", "model")``; the world must be a multiple of
    ``model_degree``."""
    world = dist.get_world_size()
    if model_degree < 1 or world % model_degree:
        raise ValueError(f"a world of {world} ranks has no model degree {model_degree}")
    return init_device_mesh(device_type or "cuda", (world // model_degree, model_degree),
                            mesh_dim_names=("data", "model"))


def ambient_mesh() -> Optional[DeviceMesh]:
    """The mesh of the innermost ``with mesh:`` block, or None outside
    one."""
    stack = _mesh_resources.mesh_stack
    return stack[-1] if stack else None

