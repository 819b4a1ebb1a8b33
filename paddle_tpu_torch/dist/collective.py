"""Collectives over the process group: the counterparts of
``paddle_tpu/dist/collective.py``'s (``collective.py:30-243``).

The JAX package calls a collective eagerly on a GLOBAL array, the
concatenation over dim 0 of every rank's block (``_eager_shard_map``,
``:58-84``). Here each rank is a process holding its own block: rank
``r`` holds rows ``[r*k, (r+1)*k)`` of the JAX package's global array,
and the concatenation of the ranks' results is the JAX package's
result. So:

- ``all_reduce`` (``ReduceOp.SUM``, ``MAX``, ``MIN``, ``PROD``): every
  rank gets the reduction of every rank's block, in place;
  ``reduce`` is the same (as in the JAX package, every rank keeps the
  value; only ``dst``'s is meaningful in the reference);
- ``all_gather``: the concatenation of the blocks along ``axis`` (the
  JAX package's eager call returns the global array itself); its list
  form fills the list with each rank's block;
- ``reduce_scatter``: block ``r`` (along dim 0) of the sum;
- ``broadcast``: ``src``'s block, in place;
- ``all_to_all``: block ``j`` of rank ``i``'s ``split_axis`` chunks
  goes to rank ``j``, concatenated there along ``concat_axis`` in rank
  order;
- ``ppermute(perm)``: rank ``d`` takes rank ``s``'s block for each
  ``(s, d)``; a rank that receives nothing gets zeros;
- ``scatter``: rank ``r`` gets chunk ``r`` of ``src``'s list (or of its
  tensor);
- ``barrier``: the group's barrier after the card's queued work.

A 0-d tensor is the identity (it has no per-rank axis: the JAX package
reads it as the global value already, ``:64-70``). A leading dimension
that the rank count does not divide raises ``ValueError`` where the op
splits it (``reduce_scatter``, ``all_to_all``), as ``:76-84`` raises.
In a world of one, or with no group, every collective is the identity.

On a ``gloo`` group a card tensor goes to ``all_reduce`` and
``broadcast`` as it is (gloo takes CUDA tensors for those two) and is
staged through a pinned host buffer for every other collective, which
gloo takes only on the host. The backend stays the one
``init_parallel_env`` chose.

``STATS`` counts the calls of each kind and the bytes handed to them
(each tensor's ``nbytes`` at the call): the gradient exchange
(``dist.gradcomm``) reads them a step. A call across ranks is also
recorded in ``ops.control_flow.DEVICE_READS`` (as ``"collective"``)
while ``framework.TrainStep`` listens there: a host collective cannot be
captured in a CUDA graph, so the step that made it stays uncaptured.
"""
from __future__ import annotations

import torch

from ..core.tensor import plain
from ..ops import control_flow
from . import env as _env

__all__ = [
    "all_reduce", "all_gather", "reduce_scatter", "broadcast", "all_to_all",
    "ppermute", "reduce", "scatter", "barrier", "ReduceOp", "split_axis",
    "STATS", "reset_stats",
]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"


# kind -> calls, and "bytes": the bytes handed to every call
STATS = {"all_reduce": 0, "broadcast": 0, "all_gather": 0,
         "reduce_scatter": 0, "all_to_all": 0, "send_recv": 0,
         "scatter": 0, "barrier": 0, "bytes": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def _count(kind, *tensors):
    STATS[kind] += 1
    STATS["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
    if control_flow.DEVICE_READS[0] is not None:
        control_flow.DEVICE_READS[0].append("collective")


def _torch_op(op):
    import torch.distributed as dist

    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT}[op]


def _group(group):
    """``(group, rank count, rank)``; the group None in a world of
    one."""
    g = group if group is not None else _env.get_group()
    if g is None:
        return None, 1, 0
    import torch.distributed as dist

    return g, dist.get_world_size(g), dist.get_rank(g)


def _staged(group, t):
    """Whether ``t`` goes through a pinned host buffer: a card tensor on
    a gloo group."""
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def raw_all_reduce(t, op=ReduceOp.SUM, group=None):
    """``t`` reduced over the group in place (no 0-d rule); returns
    ``t``."""
    g, n, _ = _group(group)
    if n == 1:
        return t
    import torch.distributed as dist

    _count("all_reduce", t)
    dist.all_reduce(t, op=_torch_op(op), group=g)
    return t


def raw_all_gather(t, group=None):
    """``(n, *t.shape)``: every rank's ``t`` stacked in rank order."""
    g, n, _ = _group(group)
    if n == 1:
        return t.unsqueeze(0).clone()
    import torch.distributed as dist

    _count("all_gather", t)
    src = _host(t) if _staged(g, t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=g)
    return torch.stack(parts).to(t.device)


def raw_all_to_all(t, group=None):
    """``t`` of shape ``(n, ...)``: row ``j`` goes to rank ``j``; returns
    ``(n, ...)`` whose row ``i`` came from rank ``i``."""
    g, n, _ = _group(group)
    if n == 1:
        return t.clone()
    import torch.distributed as dist

    _count("all_to_all", t)
    src = _host(t) if _staged(g, t) else t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=g)
    return out.to(t.device)


def _check_split(x, n, what):
    if x.shape[0] % n:
        raise ValueError(
            f"{what} over {n} ranks: leading dim {x.shape[0]} is not "
            "divisible; the ranks' blocks must split evenly along dim 0. "
            "Reshape or pad the input")


def all_reduce(tensor, op=ReduceOp.SUM, group=None, axis_name=None,
               sync_op=True):
    """ref: c_allreduce_sum/max/min/prod, in place."""
    x = plain(tensor)
    if x.dim() == 0:
        return tensor
    raw_all_reduce(x, op, group)
    return tensor


def all_gather(tensor_or_list, tensor=None, group=None, axis_name=None,
               axis=0, tiled=True):
    """ref: c_allgather. The blocks concatenated along ``axis``; with a
    list first argument, the list filled with each rank's block."""
    out_list = tensor_or_list if isinstance(tensor_or_list, list) else None
    src = tensor if out_list is not None else tensor_or_list
    x = plain(src)
    _, n, _ = _group(group)
    parts = raw_all_gather(x, group) if x.dim() else None
    if out_list is not None:
        out_list.extend([x] if parts is None else list(parts.unbind(0)))
        return out_list
    if parts is None:
        return src
    return torch.cat(list(parts.unbind(0)), dim=axis) if tiled else parts


def reduce_scatter(tensor, op=ReduceOp.SUM, group=None, axis_name=None,
                   scatter_dimension=0):
    """ref: c_reducescatter: block ``rank`` of the sum along
    ``scatter_dimension``."""
    x = plain(tensor)
    g, n, _ = _group(group)
    if n == 1 or x.dim() == 0:
        return tensor
    x = x.movedim(scatter_dimension, 0)
    _check_split(x, n, "reduce_scatter")
    import torch.distributed as dist

    _count("reduce_scatter", x)
    src = _host(x) if _staged(g, x) else x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=src.device,
                      pin_memory=src.is_pinned())
    # reduce_scatter_single is reduce_scatter_tensor's newer name
    rs = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    rs(out, src, op=_torch_op(op), group=g)
    return out.to(x.device).movedim(0, scatter_dimension)


def raw_broadcast(t, src=0, group=None):
    """``src``'s ``t`` to every rank in place (no 0-d rule); returns
    ``t``."""
    g, n, _ = _group(group)
    if n == 1:
        return t
    import torch.distributed as dist

    _count("broadcast", t)
    dist.broadcast(t, src, group=g)
    return t


def broadcast(tensor, src=0, group=None, axis_name=None):
    """ref: c_broadcast: every rank takes ``src``'s block, in place."""
    x = plain(tensor)
    if x.dim():
        raw_broadcast(x, src, group)
    return tensor


def all_to_all(tensor, group=None, axis_name=None, split_axis=0,
               concat_axis=0):
    """ref: alltoall. Chunk ``j`` of this rank's ``split_axis`` goes to
    rank ``j``; the received chunks concatenate along ``concat_axis``."""
    x = plain(tensor)
    g, n, _ = _group(group)
    if n == 1 or x.dim() == 0:
        return tensor
    _check_split(x.movedim(split_axis, 0), n, "all_to_all")
    chunks = torch.stack(x.chunk(n, dim=split_axis))
    got = raw_all_to_all(chunks, g)
    return torch.cat(list(got.unbind(0)), dim=concat_axis)


def ppermute(tensor, perm, axis_name=None, group=None):
    """Neighbour exchange: rank ``d`` takes rank ``s``'s block for each
    ``(s, d)`` of ``perm``; a rank no pair sends to gets zeros."""
    x = plain(tensor)
    g, n, r = _group(group)
    if n == 1 or x.dim() == 0:
        return tensor
    import torch.distributed as dist

    out = torch.zeros_like(x)
    staged = _staged(g, x)
    src = _host(x) if staged else x.contiguous()
    recv = _host(out) if staged else out
    ops = []
    for s, d in perm:
        if s == r and d == r:
            recv.copy_(src)
        elif s == r:
            ops.append(dist.P2POp(dist.isend, src, d, g))
        elif d == r:
            ops.append(dist.P2POp(dist.irecv, recv, s, g))
    _count("send_recv", x)
    for w in dist.batch_isend_irecv(ops) if ops else []:
        w.wait()
    return recv.to(x.device)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, axis_name=None):
    """ref: c_reduce. Every rank keeps the value, as in the JAX package;
    only rank ``dst``'s is meaningful in the reference."""
    return all_reduce(tensor, op=op, group=group, axis_name=axis_name)


def scatter(tensor, tensor_list=None, src=0, group=None, axis_name=None):
    """ref: c_scatter: rank ``r`` gets ``tensor_list[r]`` of rank
    ``src`` (or chunk ``r`` of ``src``'s ``tensor``), in place in
    ``tensor`` when the shapes agree."""
    x = plain(tensor)
    g, n, r = _group(group)
    if n == 1:
        if tensor_list is not None:
            return torch.cat([plain(t) for t in tensor_list])
        return tensor
    import torch.distributed as dist

    if tensor_list is None:
        full = x.clone()
        broadcast(full, src, g)
        _check_split(full, n, "scatter")
        return full.chunk(n)[r].clone()
    parts = [plain(t) for t in tensor_list]
    out = torch.empty_like(parts[0])
    staged = _staged(g, out)
    recv = _host(out) if staged else out
    send = [(_host(p) if staged else p.contiguous()) for p in parts] \
        if r == src else None
    _count("scatter", out)
    dist.scatter(recv, send, src=src, group=g)
    out = recv.to(out.device)
    if tuple(x.shape) == tuple(out.shape):
        x.copy_(out)
        return tensor
    return out


def barrier(group=None):
    """ref: barrier op: the card's queued work, then the group's
    barrier."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    g, n, _ = _group(group)
    if n == 1:
        return
    import torch.distributed as dist

    _count("barrier")
    dist.barrier(group=g)


def split_axis(x, axis_name=None, axis=0, group=None):
    """This rank's slice of ``x`` along ``axis``."""
    _, n, r = _group(group)
    size = x.shape[axis] // n
    return x.narrow(axis, r * size, size)
