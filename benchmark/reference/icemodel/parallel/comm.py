"""Global reductions and the halo exchange of the sharded model step.

Counterpart of the reference's parallel/comm.py (its MPI_ALLREDUCE and
halo exchanges mapped onto torch.distributed): when the PC step runs
sharded over the ranks of a process group (parallel/dist.py
ShardedModel), every global reduction - the Krylov dot products and
Hessenberg columns, the viscosity-iteration L2 norms, the truncation-error
max, the advective CFL min - combines the ranks' partial results with
one `all_reduce`, and every gather through a connectivity table or an
operator first extends the rank's block with its halo (`halo_extend`).

The rank context replaces the reference's trace-time axis name: the
sharded step enters `rank_ctx(group)` around its body, so all reductions
made inside reach the other ranks. With no context every call is the
identity (or a local reduction), so single-device code, and the
component events that every rank runs on the replicated full state, pay
nothing and reduce nothing across ranks.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

_CTX: list = [None]


@contextmanager
def rank_ctx(group):
    """Route the reductions and halo exchanges made inside through
    `group` (a sharding.RankGroup: its process group, rank and world
    size)."""
    _CTX.append(group)
    try:
        yield group
    finally:
        _CTX.pop()


def _all_reduce(x, op):
    g = _CTX[-1]
    if g is None:
        return x
    y = torch.as_tensor(x).clone()
    is_bool = y.dtype == torch.bool
    if is_bool:                 # the collectives carry no bool
        y = y.to(torch.uint8)
    dist.all_reduce(y, op=op, group=g.group)
    return y.bool() if is_bool else y


def gsum(x):
    """Global sum of a local scalar or array (elementwise over ranks)."""
    return _all_reduce(x, dist.ReduceOp.SUM)


def gmax(x):
    return _all_reduce(x, dist.ReduceOp.MAX)


def gmin(x):
    return _all_reduce(x, dist.ReduceOp.MIN)


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def sum_all(x):
    """Global sum over all elements."""
    return gsum(x.sum())


def max_all(x):
    return gmax(x.max())


def min_all(x):
    return gmin(x.min())


def dot(a, b):
    """Global dot product of two tensors or two tuples of tensors."""
    return gsum(sum((x * y).sum() for x, y in zip(_leaves(a), _leaves(b))))


def norm(x):
    """Global L2 norm of a tensor or a tuple of tensors."""
    return torch.sqrt(dot(x, x))


# ---------------------------------------------------------------------------
# Halo exchange (this rank's tables; parallel/dist.py builds them)
# ---------------------------------------------------------------------------

@dataclass
class HaloTables:
    """This rank's halo-exchange tables of one entity space:
    send_idx/send_mask [Hs], the local rows it contributes; recv_map/
    recv_mask [Hh], the slots of its halo in the ranks' concatenated
    [P*Hs] send buffers. The extended local vector is [x_own ; halo] of
    length nL + Hh."""

    send_idx: torch.Tensor
    send_mask: torch.Tensor
    recv_map: torch.Tensor
    recv_mask: torch.Tensor
    # (x, its version, the extended x) of the last exchange
    memo: tuple = field(default=None, repr=False, compare=False)

    @property
    def Hh(self):
        return self.recv_map.shape[0]

    def to(self, device):
        return HaloTables(*(t.to(device) for t in (
            self.send_idx, self.send_mask, self.recv_map, self.recv_mask)))


def _masked(m, x):
    """x where m (broadcast over x's trailing axes), else 0."""
    m = m.reshape(m.shape + (1,) * (x.ndim - 1))
    return x & m if x.dtype == torch.bool else torch.where(m, x, 0)


def halo_extend(x, t: HaloTables):
    """This rank's block x [nL(, d...)] extended with its halo values
    gathered from the other ranks: the rows it sends are packed into one
    buffer, one `all_gather` moves the ranks' buffers (the surface of each
    block, not the block), and the halo is gathered from them
    (the reference's one-collective design, comm.py:81-128; the MPI
    ISEND/IRECV exchange of halo_exchange_mod.f90:384-493)."""
    g = _CTX[-1]
    if g is None:
        raise RuntimeError("halo_extend outside a comm.rank_ctx: the sharded "
                           "step runs inside one")
    # the same tensor, unchanged since (its version counter), extended
    # again: operators applied in turn to one field (M_ddx, M_ddy of u;
    # map, ddx, ddy of N) share one exchange
    memo = t.memo
    if memo is not None and memo[0] is x and memo[1] == x._version:
        return memo[2]
    send = _masked(t.send_mask, x[t.send_idx])
    wire = send.to(torch.uint8) if send.dtype == torch.bool else send
    bufs = [torch.empty_like(wire) for _ in range(g.world)]
    dist.all_gather(bufs, wire.contiguous(), group=g.group)
    buf = torch.cat(bufs)
    if send.dtype == torch.bool:
        buf = buf.bool()
    out = torch.cat([x, _masked(t.recv_mask, buf[t.recv_map])])
    t.memo = (x, x._version, out)
    return out
