"""Mesh construction on ``torch.distributed``.

Counterpart of the JAX package's ``launch/mesh.py``: functions, not module
constants, so that importing this module starts no process group. A mesh
is a ``DeviceMesh`` (``init_device_mesh``) with the reference's axis names,
over the default process group:

- under a launcher (``torchrun``, or a caller that ran
  ``init_process_group``), the launcher's group;
- in a single process with no group, a group of one rank over an
  in-memory store: NCCL on the card, gloo when the caller names the CPU.
  ``release_process_group`` ends it.

A shape whose product differs from the world size raises: a mesh is never
shrunk or padded. The production meshes (16×16 and 2×16×16) need a world
of 256 or 512 ranks: a launcher's, or the dry run's fake one
(``launch/dryrun.py``: a "fake" process group of that many ranks in one
process, which issues no communication), on which they are built with
``device="cpu"``.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.parallel.sharding import _mesh_axis_sizes

# whether this module started the default process group
_OWNED = {"group": False}


def _ensure_group(world: int, device: torch.device) -> None:
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    elif world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        raise ValueError(
            f"a mesh of {world} ranks needs a process group of {world} "
            f"ranks, one process a rank (torchrun, or init_process_group "
            f"in each); this process has none")
    _OWNED["group"] = True


def release_process_group() -> None:
    """End the default process group if ``make_mesh_compat`` started it."""
    if _OWNED["group"] and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED["group"] = False


def make_mesh_compat(shape, axes, *, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on ``device``'s type
    (None: the card) over every rank of the default process group."""
    dev = resolve_device(device)
    shape, axes = tuple(shape), tuple(axes)
    world = math.prod(shape)
    _ensure_group(world, dev)
    if dist.get_world_size() != world:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} has {world} ranks, the process "
            f"group {dist.get_world_size()}: a mesh is never shrunk or padded")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The 16×16 ("data", "model") mesh, or with ``multi_pod`` the
    2×16×16 ("pod", "data", "model") one, over the default process group,
    which must have 256 or 512 ranks (a launcher's, or the dry run's fake
    group: ``launch/dryrun.py`` ``fake_world``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs a world of "
            f"{math.prod(shape)} ranks, this one has {world}: a launcher's, "
            f"or the dry run's fake world (launch/dryrun.py fake_world)")
    return make_mesh_compat(shape, axes, device=device)


def make_mesh_from_shape(mesh_shape: dict[str, int], *, device=None):
    """Arbitrary (possibly degraded) mesh, e.g. after elastic rescale."""
    names = tuple(n for n in ("pod", "data", "model") if n in mesh_shape)
    shape = tuple(mesh_shape[n] for n in names)
    return make_mesh_compat(shape, names, device=device)


def mesh_shape_dict(mesh) -> dict[str, int]:
    return _mesh_axis_sizes(mesh)


def chips(mesh) -> int:
    return math.prod(_mesh_axis_sizes(mesh).values())


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
