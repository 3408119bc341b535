"""The ranks of a sharded run, and the contiguous renumbering of a mesh.

Counterpart of the reference's parallel/sharding.py (its re-design of the
MPI domain decomposition, src/UPSY/basic/mpi_parallelisation/): the mesh's
vertex, triangle and edge spaces are split into contiguous equal blocks,
one a rank. Where the reference places arrays on a 1-D jax device mesh,
here each block lives in its own process: `RankGroup` is the process
group a run shards over, this process's rank in it and its device.
`renumber_contiguous` and `pad_to_multiple` are the reference's, in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class RankGroup:
    """One rank of a sharded run: the process group, this process's rank,
    the world size and the device its blocks live on."""

    group: Any          # torch.distributed ProcessGroup
    rank: int
    world: int
    device: torch.device

    @classmethod
    def of_world(cls, n_ranks: int, device, key="tpu_n_devices"):
        """This process's rank in the default process group, which must
        have exactly `n_ranks` ranks; raises, naming `key`, the world
        size found and the one needed, otherwise (there is no fallback to
        one device)."""
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"{key} = {n_ranks} needs a torch.distributed process group "
                f"of world size {n_ranks}, and none is initialised (start "
                f"the ranks with parallel.launch.spawn, or torchrun with "
                f"--backend)")
        world = dist.get_world_size()
        if world != n_ranks:
            raise RuntimeError(
                f"{key} = {n_ranks} needs a torch.distributed process group "
                f"of world size {n_ranks}, found world size {world}")
        return cls(dist.group.WORLD, dist.get_rank(), world,
                   torch.device(device))


def renumber_contiguous(mesh, n_parts: int):
    """Renumber mesh entities so each partition owns a contiguous index
    range with spatial locality (space-filling-curve ordering by Morton
    code; reference mesh_contiguous_domains.f90 renumbers by sweep).

    Returns (perm_V, perm_Tri, perm_E): new order = old index arrays.
    """
    def morton_order(P):
        x = P[:, 0] - P[:, 0].min()
        y = P[:, 1] - P[:, 1].min()
        nx = ((x / max(x.max(), 1e-30)) * 65535).astype(np.uint64)
        ny = ((y / max(y.max(), 1e-30)) * 65535).astype(np.uint64)

        def spread(v):
            v = (v | (v << 8)) & np.uint64(0x00FF00FF)
            v = (v | (v << 4)) & np.uint64(0x0F0F0F0F)
            v = (v | (v << 2)) & np.uint64(0x33333333)
            v = (v | (v << 1)) & np.uint64(0x55555555)
            return v
        code = spread(nx) | (spread(ny) << np.uint64(1))
        return np.argsort(code, kind="stable")

    return (morton_order(mesh.V), morton_order(mesh.TriGC),
            morton_order(mesh.E))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
