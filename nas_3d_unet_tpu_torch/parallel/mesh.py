"""Data parallelism and spatial sharding over `torch.distributed`: one
process (rank) per GPU.

Counterpart of `nas_3d_unet_tpu/parallel/mesh.py`.  The JAX package lays a
GSPMD `('data', 'spatial')` mesh over its devices and lets XLA insert the
collectives; here they are written out.

The layout: `data_parallel` × `spatial_parallel` ranks, rank r at data
index r // spatial_parallel and spatial index r % spatial_parallel (the
reference's `devices.reshape(data, spatial)`).  The ranks of one data
index form a spatial group: they hold the same batch rows, rank j of the
group D-slab j of them (`parallel/spatial.py`: the halo exchanges and
cross-slab sums run over the group's process group).  Every rank holds the
whole model, and the step reduces the gradients before the optimizer, so
every rank applies the same update to the same parameters: a slab's
gradient is its part of the spatial group's sum, so the gradients are
summed over the spatial group and then averaged over the data axis.  That
is one all-reduce over every rank, divided by the data axis's size
(`Mesh.all_reduce_mean_`), which gives every rank the same bits; so only
the spatial groups get process groups of their own.  The second-order
search step reduces its inner gradient inside the recorded graph instead,
as the spatial sum (`Mesh.spatial_sum`) and then the mean over the ranks
(`Mesh.all_reduce_mean`), both differentiable.

    python -m torch.distributed.run --nproc_per_node N \\
        -m nas_3d_unet_tpu_torch train -c config.json \\
        [-o parallel.spatial_parallel=S]

`maybe_initialize_distributed` reads torchrun's environment (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and initialises
the default process group: NCCL for ranks on the card (each on
`cuda:LOCAL_RANK`), gloo for ranks on the CPU.  Without that environment it
does nothing, and `make_mesh` gives a one-rank `Mesh` whose collectives
launch nothing.

Collectives, the halo exchanges among them, run in stream order on the
current stream, in the forward and the backward that need them; nothing
overlaps them with compute on a side stream (no bucketed gradient hooks,
no exchange ahead of its consumer), so no two of a process's K5 launches
ever run on two streams at once (`csrc/stats.cu`'s shared tickets).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from .spatial import Slab, all_reduce_sums, summed


def is_initialized() -> bool:
    """Whether the default process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default process group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    """Rank 0, the one rank that writes files and prints results."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank; nothing without a process group."""
    if world_size() > 1:
        dist.barrier()


def maybe_initialize_distributed(device: torch.device | str | None = None,
                                 backend: Optional[str] = None) -> None:
    """Initialise the default process group from torchrun's environment,
    whenever `RANK` and `WORLD_SIZE` are set (world 1 included); otherwise,
    or when it exists already, do nothing.

    `device`: where the ranks compute.  A CPU device takes gloo; anything
    else is the card: `torch.cuda.set_device(LOCAL_RANK)` runs first, before
    anything else touches the card, and the backend is NCCL.  `backend`
    names one explicitly (gloo also carries CUDA tensors, for two ranks
    sharing one card, where NCCL refuses)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return
    if is_initialized():
        return
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank: pass "
                               "--device cpu to run the ranks on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend or ("gloo" if on_cpu else "nccl"),
                            init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


def destroy() -> None:
    """Tear the default process group down, if there is one."""
    if is_initialized():
        dist.destroy_process_group()


def check_layout(data_parallel: int, spatial_parallel: int,
                 world: Optional[int] = None) -> int:
    """The data axis's size for `parallel.data_parallel`
    (-1: every rank the spatial axis leaves) and
    `parallel.spatial_parallel` over `world` ranks; raises for a layout
    that does not fill the world exactly."""
    world = world_size() if world is None else world
    if spatial_parallel < 1 or world % spatial_parallel:
        raise ValueError(
            f"parallel.spatial_parallel={spatial_parallel} must divide the "
            f"world size {world}: data × spatial must equal the world")
    if data_parallel not in (-1, world // spatial_parallel):
        raise ValueError(
            f"parallel.data_parallel={data_parallel} must be -1 or the world "
            f"size {world} over parallel.spatial_parallel="
            f"{spatial_parallel}: the port runs one rank per device and data "
            "× spatial equal to the world (ROADMAP.md queue 1, item 9a)")
    return world // spatial_parallel


@dataclass(frozen=True)
class Mesh:
    """This process's `rank` of `world`, laid out as data × `spatial`
    (see the module docstring); `spatial_group` is the process group of
    this rank's spatial group where `spatial` > 1.  With `world` 1 no
    collective is launched."""

    rank: int = 0
    world: int = 1
    spatial: int = 1
    spatial_group: Any = None

    @property
    def data_rank(self) -> int:
        """This rank's index on the data axis: whose batch rows it holds."""
        return self.rank // self.spatial

    @property
    def data_world(self) -> int:
        """The data axis's size: how many row sets the global batch has."""
        return self.world // self.spatial

    @property
    def slab(self) -> Optional[Slab]:
        """This rank's D-slab of its rows, None without spatial sharding."""
        if self.spatial == 1:
            return None
        return Slab(self.rank % self.spatial, self.spatial,
                    self.spatial_group)

    @staticmethod
    def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """One buffer of the tensors' values, in order (one dtype)."""
        return torch.cat([t.detach().reshape(-1) for t in tensors])

    @staticmethod
    @torch.no_grad()
    def _scatter(tensors: Sequence[torch.Tensor], flat: torch.Tensor) -> None:
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor],
                         slab_parts: int = 0) -> List[torch.Tensor]:
        """Replace each tensor (all of one dtype) by its mean over the data
        axis, in place: one flat buffer, summed in one all-reduce over
        every rank, divided by the data axis's size.  The first
        `slab_parts` tensors are a slab's part of a sum over its spatial
        group (gradients), so they are summed over the group first; the
        rest are equal on the ranks of a spatial group (losses, metrics)
        and count once.  Every rank receives the same sum.  World 1:
        untouched."""
        tensors = list(tensors)
        if self.world > 1:
            flat = self._flat(tensors)
            if self.spatial > 1:
                n = sum(t.numel() for t in tensors[:slab_parts])
                flat[n:] /= self.spatial
            dist.all_reduce(flat)
            self._scatter(tensors, flat.div_(self.data_world))
        return tensors

    def broadcast_(self, tensors: Sequence[torch.Tensor],
                   src: int = 0) -> List[torch.Tensor]:
        """Overwrite each tensor (all of one dtype) with rank `src`'s, in
        place."""
        tensors = list(tensors)
        if self.world > 1:
            flat = self._flat(tensors)
            dist.broadcast(flat, src)
            self._scatter(tensors, flat)
        return tensors

    def spatial_sum(self, tensors: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Each tensor summed over this rank's spatial group, in one
        all-reduce; where a graph is recorded, differentiable: the adjoint
        is the same sum of the cotangents (`spatial.all_reduce_sums`).
        For a slab's part of a gradient, inside the second-order step's
        graph.  All tensors share one dtype.  Without spatial sharding:
        the tensors themselves."""
        tensors = list(tensors)
        if self.spatial == 1:
            return tensors
        return all_reduce_sums(tensors, self.slab)

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """The mean over every rank, differentiable: the adjoint averages
        the cotangents over the ranks in the same way, so a rank's
        gradient through the mean holds every rank's terms.  Of tensors
        that are equal on the ranks of each spatial group (a gradient
        after `spatial_sum`) it is the mean over the data axis, and its
        adjoint that mean's.  All tensors share one dtype.  World 1: the
        tensors themselves."""
        tensors = list(tensors)
        if self.world == 1:
            return tensors
        flat = summed(torch.cat([t.reshape(-1) for t in tensors]), None)
        flat = flat / self.world
        return [c.view_as(t) for c, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    def gather(self, obj: Any) -> List[Any]:
        """Every rank's `obj`, by rank (picklable objects)."""
        if self.world == 1:
            return [obj]
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def spatial_gather(self, obj: Any) -> List[Any]:
        """Every rank of this rank's spatial group's `obj`, by slab."""
        if self.spatial == 1:
            return [obj]
        out: List[Any] = [None] * self.spatial
        dist.all_gather_object(out, obj, group=self.spatial_group)
        return out


def make_mesh(data_parallel: int = -1, spatial_parallel: int = 1) -> Mesh:
    """The data × spatial layout over every rank of the default process
    group (one rank without one; `check_layout`).  With `spatial_parallel`
    > 1 every rank creates each spatial group's process group, in one
    order (`dist.new_group` is collective), and keeps its own."""
    spatial = spatial_parallel
    data = check_layout(data_parallel, spatial)
    group = None
    if spatial > 1:
        for i in range(data):
            g = dist.new_group(list(range(i * spatial, (i + 1) * spatial)))
            if i == rank() // spatial:
                group = g
    return Mesh(rank=rank(), world=data * spatial, spatial=spatial,
                spatial_group=group)


def local_batch_size(global_batch: int, what: str = "data.batch_size",
                     world: Optional[int] = None) -> int:
    """This rank's slice of the global batch."""
    p = world_size() if world is None else world
    if global_batch % p != 0:
        raise ValueError(
            f"{what}={global_batch} must be divisible by the process count "
            f"{p}: the global batch is assembled from equal per-host slices")
    return global_batch // p
