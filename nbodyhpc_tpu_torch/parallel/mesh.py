"""The slab mesh: a process group and the rank's device.

PyTorch port of :mod:`nbodyhpc_tpu.parallel.mesh`. The JAX package lays a
1D device mesh along the grid's z-slab axis; here the axis is the ranks of
a ``torch.distributed`` process group, one process per device. NCCL
exchanges device tensors; gloo exchanges host tensors, so on gloo every
exchange stages its tensors through host memory while the compute stays on
the rank's device.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import default_device

SLAB_AXIS = "z"


class SlabMesh(NamedTuple):
    """``group`` None for a world of one (no process group), else the group
    the collectives run on; ``rank`` and ``size`` within it; ``device`` the
    rank's compute device; ``backend`` the group's backend name (None
    without a group)."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str | None


def make_slab_mesh(group=None, device=None) -> SlabMesh:
    """The slab mesh over ``group`` (default: the world group when
    ``torch.distributed`` is initialised, else a world of one).

    ``device`` defaults to ``cuda:(LOCAL_RANK or rank) % device_count``;
    without a card that raises, as :func:`nbodyhpc_tpu_torch.default_device`
    does, and a CPU run passes ``device="cpu"``.
    """
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        rank, size, backend = 0, 1, None
    else:
        rank = dist.get_rank(group)
        size = dist.get_world_size(group)
        backend = str(dist.get_backend(group))
    if device is None:
        default_device()  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return SlabMesh(group, rank, size, device, backend)


def _host_staged(mesh: SlabMesh) -> bool:
    """Whether the mesh's collectives take host tensors (gloo)."""
    return mesh.backend == "gloo"
