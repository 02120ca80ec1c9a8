"""The collectives that layers call in their forward, differentiable: the
mean over a group's ranks (batch statistics synced over ranks, JAX's
``pmean``), the sum over them (a loss whose terms sum over all rows) and
the halo exchange of a crop whose height is sharded over a
group (``mesh: {spatial: N}``, parallel/spatial.py).

``halo_transport`` names how the halo rows travel: NCCL's send / recv, or
gloo's on CPU tensors; gloo runs no send / recv on CUDA tensors (ranks
sharing one card), so there the rows are staged through pinned host
buffers. The parallel package builds on these; nothing here imports it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _MeanOverRanks(torch.autograd.Function):
    """All-reduce SUM / N. Its backward is the same mean of the incoming
    gradients, which is what JAX's ``pmean`` transposes to: each rank's loss
    reaches every rank's statistics through the mean."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone().contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def mean_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the group's ranks, differentiable."""
    return _MeanOverRanks.apply(x, group)


class _SumOverRanks(torch.autograd.Function):
    """All-reduce SUM. Its backward is the same sum of the incoming
    gradients, its adjoint: each rank's share reaches every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone().contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, differentiable."""
    return _SumOverRanks.apply(x, group)


def halo_transport(group, device) -> str:
    """How ``exchange_halo`` moves rows on this group and device."""
    backend = dist.get_backend(group)
    if backend == dist.Backend.GLOO and torch.device(device).type == "cuda":
        return "gloo send/recv through pinned host buffers (ranks sharing a card)"
    return f"{backend} send/recv"


def _neighbours(group, hop: int = 1):
    """(the rank ``hop`` above, the rank ``hop`` below) in global
    numbering; None past the crop's top or bottom."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    up = dist.get_global_rank(group, rank - hop) if rank >= hop else None
    down = dist.get_global_rank(group, rank + hop) if rank + hop < world else None
    return up, down


def _swap(group, to_up: torch.Tensor, to_down: torch.Tensor, hop: int = 1):
    """Send ``to_up`` to the rank ``hop`` above and ``to_down`` to the rank
    ``hop`` below; returns (what the rank above sent down, what the rank
    below sent up), None where there is no such rank."""
    up, down = _neighbours(group, hop)
    device = to_up.device
    staged = device.type == "cuda" and dist.get_backend(group) == dist.Backend.GLOO

    def host(t):
        t = t.contiguous()
        if not staged:
            return t
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf

    ops, got = [], {}
    for peer, send in ((up, to_up), (down, to_down)):
        if peer is None:
            continue
        got[peer] = torch.empty(send.shape, dtype=send.dtype,
                                device="cpu" if staged else device, pin_memory=staged)
        ops.append(dist.P2POp(dist.isend, host(send), peer, group))
        ops.append(dist.P2POp(dist.irecv, got[peer], peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    back = {p: t.to(device) if staged else t for p, t in got.items()}
    return back.get(up), back.get(down)


def _hops(rows: int, own: int):
    """The rows that come from the rank at each distance 1, 2, ... for a
    halo of ``rows`` rows over shards of ``own`` rows: whole shards from
    the nearer ranks, the rest from the farthest."""
    return [min(own, rows - k * own) for k in range(-(-rows // own))]


def _memory_format(x: torch.Tensor):
    return (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


class _Halo(torch.autograd.Function):
    """x (B, C, h, W), this rank's rows -> (B, C, rows + h + rows, W): the
    rows above and below it, taken from as many ranks as the halo spans
    (the nearest neighbour's whole shard, then the next one's, ...); zeros
    past the crop's top and bottom. Backward: the halo rows' gradients go
    back to their owners, which add them to their rows."""

    @staticmethod
    def forward(ctx, x, rows, group):
        own = x.shape[2]
        ctx.rows, ctx.group = rows, group
        above, below = [], []
        for hop, n in enumerate(_hops(rows, own), 1):
            top, bottom = _swap(group, x[:, :, :n], x[:, :, own - n:], hop)
            above.insert(0, (top, n))
            below.append((bottom, n))

        def fill(parts):
            return [x.new_zeros(x.shape[:2] + (n,) + x.shape[3:]) if got is None
                    else got.to(memory_format=torch.contiguous_format) for got, n in parts]

        # in x's layout (channels-last on the card), as the convolution that
        # reads it expects
        out = torch.cat(fill(above) + [x] + fill(below), dim=2)
        return out.contiguous(memory_format=_memory_format(x))

    @staticmethod
    def backward(ctx, g):
        rows = ctx.rows
        own = g.shape[2] - 2 * rows
        dx = g[:, :, rows:rows + own].clone()
        done = 0  # the halo rows of the nearer hops, on each side
        for hop, n in enumerate(_hops(rows, own), 1):
            g_top = g[:, :, rows - done - n:rows - done]
            g_bottom = g[:, :, rows + own + done:rows + own + done + n]
            done += n
            # the rank above sends back what it held of our top rows, the
            # rank below what it held of our bottom rows
            from_up, from_down = _swap(ctx.group, g_top, g_bottom, hop)
            if from_up is not None:
                dx[:, :, :n] += from_up
            if from_down is not None:
                dx[:, :, own - n:] += from_down
        return dx, None, None


def exchange_halo(x: torch.Tensor, rows: int, group) -> torch.Tensor:
    """``rows`` rows of the ranks above and below this rank's rows of ``x``
    (NCHW), differentiable, reaching past the nearest neighbour when the
    halo is taller than a shard; zeros past the crop's top and bottom."""
    return _Halo.apply(x, rows, group)
