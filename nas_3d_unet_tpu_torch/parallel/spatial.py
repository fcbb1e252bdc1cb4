"""Spatial sharding: the volume's D axis in contiguous slabs over the ranks
of a spatial group, with the halo exchanges and cross-slab sums written
out.

Counterpart of the JAX package's `spatial` mesh axis
(`nas_3d_unet_tpu/parallel/mesh.py:69-89,143-146`), where GSPMD inserts
the conv halo exchanges and the cross-shard sums.  The port has no GSPMD:
each rank of a spatial group holds one D-slab of the same batch rows, and
the ops that reach across D ask for what they need here.

  `Slab`          this rank's place: its index in the spatial group, the
                  group's size and its process group.
  `sharded_d`     the scoped context the ops read (`current()`): set by the
                  train, eval and search steps around their forward and
                  backward.  Without it every op is the one-process op.
                  A module-level setting, as `torch.backends` flags are,
                  because the backward of a CUDA graph runs on autograd's
                  device thread, which a context variable would not reach.
  `halo_d`        x with `lo` planes of the previous rank before it and `hi`
                  of the next after it; at the global ends `fill` (zero,
                  −inf) or, with `fill=None`, nothing.  Its backward is the
                  adjoint: the halo planes' gradients go back to the rank
                  they came from and are added into its boundary planes.
  `all_reduce_sums`  (B, C) sums of every slab, summed over the group (no
                  graph): the GroupNorm moments and the backward's Σdy,
                  Σdy·x.
  `spatial_sum`   the same sum inside a graph whose backward is the
                  identity: every rank then holds the same replicated value
                  (a loss), and each rank's gradient is its own slab's
                  terms, which the step sums over the group.  The adjoint of
                  `torch.distributed.nn`'s all-reduce would sum the
                  cotangents and scale every gradient by the group's size.

Every exchange is one all-reduce over the spatial group of a byte buffer
in which each rank fills its own slot and the others are zero: the bytes
arrive unchanged (x + 0 in uint8), and gloo, which carries CUDA tensors
for all-reduce but not for point-to-point or all-gather, and NCCL both
run it.  Collectives run on the current stream, in program order, on
every rank of the group, the ranks at the global ends too; a rank whose
halo is empty on both sides (a 1³ conv) exchanges nothing.

The slab rule (`check_slab`): a patch D that is a multiple of size ·
2^depth, so every level's slab starts on an even plane (the stride-2
ops' windows and lax's high-sided SAME pad of the global D then hold at
interior faces), and whose deepest slab has at least 2 planes, the
dilation-2 halo.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Slab:
    """Rank `index` of a spatial group of `size` ranks (`group`, a
    process group), holding D-slab `index` of the group's batch rows."""

    index: int
    size: int
    group: Any = None

    @property
    def first(self) -> bool:
        """Whether this slab starts at the global D = 0."""
        return self.index == 0

    @property
    def last(self) -> bool:
        """Whether this slab ends at the global D end."""
        return self.index == self.size - 1

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slab of t (B, D, ...) along D, contiguous."""
        n = t.shape[1] // self.size
        return t.narrow(1, self.index * n, n).contiguous()


_ACTIVE: Optional[Slab] = None


def current() -> Optional[Slab]:
    """The slab of the sharded-D context in force, None outside one."""
    return _ACTIVE


@contextlib.contextmanager
def sharded_d(slab: Optional[Slab]) -> Iterator[None]:
    """Within the block the ops take their inputs as `slab`'s D-slab (None:
    the one-process ops); the caller's setting comes back on exit."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, slab
    try:
        yield
    finally:
        _ACTIVE = saved


class same_slab:
    """Captures the sharded-D context in force when it is made and
    reinstates it for each block it is entered for (re-entrant): an
    activation checkpoint's recompute runs inside the backward under the
    forward's context with it."""

    def __init__(self):
        self._slab = current()
        self._saved: list = []

    def __enter__(self) -> None:
        ctx = sharded_d(self._slab)
        ctx.__enter__()
        self._saved.append(ctx)

    def __exit__(self, *exc) -> None:
        self._saved.pop().__exit__(*exc)


def check_slab(d: int, size: int, depth: int, what: str = "patch D") -> None:
    """Raise unless a volume of `d` planes splits into `size` slabs that
    start on multiples of 2^depth with at least 2 planes at the deepest
    level."""
    unit = size * 2 ** depth
    if d % unit or d // unit < 2:
        raise ValueError(
            f"{what} {d} under parallel.spatial_parallel={size} at model "
            f"depth {depth}: it must be a multiple of {size}·2^{depth} = "
            f"{unit} with at least 2 planes in the deepest slab (a D of at "
            f"least {2 * unit})")


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _exchange(slab: Slab, to_prev: torch.Tensor, to_next: torch.Tensor):
    """Every rank gives `to_prev` (for rank index − 1) and `to_next` (for
    index + 1), each of the same shape on every rank; returns (the previous
    rank's `to_next`, the next rank's `to_prev`), None past a global end.
    One all-reduce of a byte buffer, a slot a rank."""
    a, b = _bytes(to_prev), _bytes(to_next)
    na = a.numel()
    buf = torch.zeros((slab.size, na + b.numel()), dtype=torch.uint8,
                      device=a.device)
    buf[slab.index, :na] = a
    buf[slab.index, na:] = b
    dist.all_reduce(buf, group=slab.group)
    from_prev = from_next = None
    if not slab.first:
        from_prev = buf[slab.index - 1, na:].clone().view(
            to_next.dtype).view(to_next.shape)
    if not slab.last:
        from_next = buf[slab.index + 1, :na].clone().view(
            to_prev.dtype).view(to_prev.shape)
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slab, lo, hi, fill):
        d = x.shape[1]
        if lo > d or hi > d:
            raise ValueError(f"halo ({lo}, {hi}) wider than the slab's {d} "
                             "planes: see the slab rule (check_slab)")
        # the previous rank's hi halo is my first hi planes, the next
        # rank's lo halo my last lo planes
        from_prev, from_next = _exchange(slab, x[:, :hi], x[:, d - lo:])

        def end(n):
            shape = (x.shape[0], n, *x.shape[2:])
            return None if fill is None or not n else x.new_full(shape, fill)

        head = from_prev if from_prev is not None else end(lo)
        tail = from_next if from_next is not None else end(hi)
        ctx.geom = (slab, lo, hi, d, 0 if head is None else lo)
        return torch.cat([t for t in (head, x, tail) if t is not None], 1)

    @staticmethod
    def backward(ctx, g):
        slab, lo, hi, d, lo_n = ctx.geom
        g_lo, g_hi = g[:, :lo_n], g[:, lo_n + d:]
        # a global end's halo (the fill) sends zeros that nobody reads
        if g_lo.shape[1] != lo:
            g_lo = g.new_zeros((g.shape[0], lo, *g.shape[2:]))
        if g_hi.shape[1] != hi:
            g_hi = g.new_zeros((g.shape[0], hi, *g.shape[2:]))
        from_prev, from_next = _exchange(slab, g_lo, g_hi)
        dx = g[:, lo_n:lo_n + d].clone()
        if from_prev is not None:       # the previous rank's hi halo
            dx[:, :hi] += from_prev
        if from_next is not None:       # the next rank's lo halo
            dx[:, d - lo:] += from_next
        return dx, None, None, None, None


def halo_d(x: torch.Tensor, lo: int, hi: int, fill: Optional[float],
           slab: Slab) -> torch.Tensor:
    """x (B, D, ...) of `slab` with `lo` planes of the previous slab before
    it and `hi` of the next after it; at a global end `fill` planes, or
    none with `fill=None`.  Differentiable in x (the adjoint exchange).
    Collective: every rank of the group calls it with the same `lo`, `hi`
    and shapes; `lo` = `hi` = 0 exchanges nothing."""
    if not lo and not hi:
        return x
    return _Halo.apply(x.contiguous(), slab, lo, hi, fill)


def all_reduce_sums(tensors: Sequence[torch.Tensor],
                    slab: Slab) -> List[torch.Tensor]:
    """Each tensor (all of one dtype) summed over `slab`'s spatial group,
    as new tensors, in one all-reduce; no graph is recorded."""
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=slab.group)
    return [c.view_as(t) for c, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class _SpatialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, slab):
        out = t.clone()
        dist.all_reduce(out, group=slab.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def spatial_sum(t: torch.Tensor, slab: Slab) -> torch.Tensor:
    """t summed over `slab`'s spatial group; the backward passes the
    cotangent through unchanged (see the module docstring)."""
    return _SpatialSum.apply(t, slab)
