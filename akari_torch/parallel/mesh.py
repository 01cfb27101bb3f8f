"""The 1-D ray mesh over ``torch.distributed`` (``akari_tpu/parallel/mesh.py``).

The JAX package is one controller: ``shard_map`` runs over a ``"rays"``
mesh of its process's devices and merges with ``psum``. Here each rank is
a process of its own, one device each, joined by a process group; the
merge is a sum all-reduce (NCCL across cards, gloo on the CPU or for
several ranks sharing one card). The scene is replicated: every rank
compiles it and holds it on its device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core.device import target_device


@dataclass(frozen=True)
class RayMesh:
    """One rank's view of the ray mesh: its ``rank`` in ``size`` ranks, the
    ``device`` its scene and pixels live on and the process ``group``
    (None for the 1-rank mesh of a process with no process group)."""

    rank: int
    size: int
    device: torch.device
    group: object = None

    def all_reduce(self, t):
        """A new tensor holding the sum of ``t`` over the ranks (``t`` is
        unchanged). Every rank must call it, in the same order; on a
        1-rank mesh with no group it returns ``t`` itself."""
        if self.group is None:
            return t
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def barrier(self):
        """Return once every rank has called it: an all-reduce read back,
        so NCCL and gloo take the same path."""
        self.all_reduce(torch.zeros(1, device=self.device)).cpu()


def _rank_device(device):
    """``cuda`` names this rank's card, ``cuda:{LOCAL_RANK}``; an indexed
    device or ``cpu`` is taken as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def make_ray_mesh(device="cuda"):
    """The ray mesh of this process on ``device``: over the default process
    group when one is initialised, else a 1-rank mesh whose collectives
    are the identity. An NCCL group takes CUDA devices only."""
    device = target_device(_rank_device(device), "ray mesh")
    if not dist.is_initialized():
        return RayMesh(rank=0, size=1, device=device)
    group = dist.group.WORLD
    if dist.get_backend(group) == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL process group cannot reduce tensors on {device}")
    return RayMesh(rank=dist.get_rank(group), size=dist.get_world_size(group),
                   device=device, group=group)


def initialize_distributed(device="cuda", backend=None, init_method=None,
                           world_size=None, rank=None):
    """``torch.distributed.init_process_group`` for one rank of a ray mesh;
    returns its ``make_ray_mesh(device)``.

    The backend defaults to ``nccl`` for a CUDA device (``cuda`` is
    ``cuda:{LOCAL_RANK}``, one card a rank) and ``gloo`` for the CPU.
    Several ranks sharing one card pass ``backend="gloo"`` and the card's
    indexed device: NCCL refuses two ranks on one GPU. ``init_method``,
    ``world_size`` and ``rank`` default to the environment that
    ``torch.distributed.run`` sets.
    """
    dev = _rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kwargs)
    return make_ray_mesh(dev)
