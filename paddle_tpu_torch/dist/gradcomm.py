"""The gradient exchange of data parallelism: bucketed, accumulated,
quantized. The counterpart of ``paddle_tpu/dist/gradcomm.py``.

The planning is that module's, copied as pure Python: ``CommOptions``,
``Bucket``, ``BucketPlan`` and ``plan_buckets`` (``gradcomm.py:74-224``)
and the reserved state names ``EF_PREFIX`` and ``STEP_VAR``. The JAX
package vmaps the step over a device-major batch and reduces ``(ndev,
F)`` buffers; here each rank is a process and holds its own row of that
buffer, a ``(padded,)`` float32 flat a bucket:

- **fp32**: one ``all_reduce`` a bucket, then the product with
  ``float32(1 / denom)`` (``:323-331``);
- **int8** (EQuARX-style, ``:340-385``): per bucket ``c = flat * inv +
  residual``; ``c``'s row quantized to int8 with one scale and
  stochastic rounding (``_quantize_rows`` over ``hash_uniform`` noise);
  the new residual ``c - q1 * scale1``; one int8 ``all_to_all`` (chunk
  ``j`` of every rank to rank ``j``) and an ``all_gather`` of the
  scales; each rank's chunk dequantized and summed in rank order; that
  chunk requantized under the salt ``bsalt ^ 0xA5A5A5A5``, and one int8
  ``all_gather`` of the chunks (and one of their scales).

``hash_uniform`` is the JAX package's lattice hash bit for bit. torch has
no full unsigned 32-bit arithmetic: the hash runs in int64 and masks to
32 bits after every product (the low 32 bits of a wrapped int64 product
are the uint32 product's). Rank ``r`` takes row ``r`` of the ``(n, F)``
lattice: its indices start at ``r * F``.

``Exchange`` holds a step's plan and flats: ``gather`` copies (or adds)
this rank's gradients into the flats, ``reduce`` exchanges them, and
``grads`` reads each parameter's gradient back in its own type. Each
exchange records the collectives' calls and bytes and its host wall
(``last``).

Not ported here: ``device_major`` (the JAX package's vmap device, which a
process-per-rank design has no use for) and ``split_update_segment``
(the static program's data parallelism, ROADMAP Queue 1 item 6c).
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from . import collective

__all__ = ["CommOptions", "Bucket", "BucketPlan", "plan_buckets",
           "implicit_plan", "exchange_bucketed", "hash_uniform",
           "Exchange", "EF_PREFIX", "STEP_VAR", "MB"]

MB = 1 << 20

# reserved optimizer-state names of the exchange's state
EF_PREFIX = "@comm@ef@"       # per-bucket error-feedback residual
STEP_VAR = "@comm@step"       # stochastic-rounding salt counter

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CommOptions:
    """Gradient-exchange configuration (``gradcomm.py:74-128``):
    ``bucket_bytes`` caps a flat bucket, ``last_bucket_bytes`` the first
    to fire (the reference's ``last_comm_buffer_size``),
    ``accumulate_steps`` exchanges once per N microbatches of a fused
    window, ``quantize`` is None (float32) or ``"int8"``,
    ``gradient_scale`` ``"mean"`` divides the sum by the rank count."""

    bucket_bytes: int = 25 * MB
    last_bucket_bytes: int = 1 * MB
    accumulate_steps: int = 1
    quantize: str | None = None
    gradient_scale: str = "mean"

    def __post_init__(self):
        if self.bucket_bytes <= 0 or self.last_bucket_bytes <= 0:
            raise ValueError("bucket caps must be positive byte counts, "
                             f"got {self.bucket_bytes}/"
                             f"{self.last_bucket_bytes}")
        if self.accumulate_steps < 1:
            raise ValueError(
                f"accumulate_steps must be >= 1, got {self.accumulate_steps}")
        if self.quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', "
                             f"got {self.quantize!r}")
        if self.gradient_scale not in ("mean", "sum"):
            raise ValueError("gradient_scale must be 'mean' or 'sum', "
                             f"got {self.gradient_scale!r}")

    def cache_axis(self):
        return (self.bucket_bytes, self.last_bucket_bytes,
                self.accumulate_steps, self.quantize, self.gradient_scale)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One flat exchange buffer: member gradients in availability order."""

    names: tuple
    shapes: tuple
    sizes: tuple
    offsets: tuple
    numel: int
    padded: int           # numel padded up to a multiple of ndev


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: tuple
    ndev: int
    options: CommOptions

    @property
    def n_buckets(self):
        return len(self.buckets)

    def flatten_local(self, locals_):
        """name -> this rank's gradient into one zero-padded ``(padded,)``
        float32 flat a bucket."""
        out = []
        for b in self.buckets:
            flat = torch.cat([locals_[n].reshape(-1).float()
                              for n in b.names])
            if b.padded != b.numel:
                flat = torch.cat([flat, flat.new_zeros(b.padded - b.numel)])
            out.append(flat)
        return out

    def unflatten(self, flats, dtypes=None):
        """Reduced ``(padded,)`` flats back to name -> full-shape
        gradients (in ``dtypes[name]`` where given)."""
        out = {}
        for b, flat in zip(self.buckets, flats):
            for n, shape, size, off in zip(b.names, b.shapes, b.sizes,
                                           b.offsets):
                g = flat[off:off + size].reshape(shape)
                if dtypes is not None and n in dtypes:
                    g = g.to(dtypes[n])
                out[n] = g
        return out


def _bucket(cur, ndev):
    names = tuple(n for n, _, _ in cur)
    shapes = tuple(tuple(int(d) for d in s) for _, s, _ in cur)
    sizes = tuple(math.prod(s) if s else 1 for s in shapes)
    offsets, off = [], 0
    for sz in sizes:
        offsets.append(off)
        off += sz
    return Bucket(names, shapes, sizes, tuple(offsets), off,
                  off + ((-off) % ndev))


def plan_buckets(entries, options, ndev):
    """Gradients ``(name, shape, dtype)`` in availability order (the
    backward's: reverse parameter order) into size-bounded flat buckets
    (``gradcomm.py:171-224``): the first capped at ``last_bucket_bytes``,
    the rest at ``bucket_bytes``, sized at 4 bytes an element (the flats
    are float32); a gradient larger than its cap is a bucket of its
    own."""
    buckets = []
    cur, cur_bytes = [], 0

    def cap():
        return options.last_bucket_bytes if not buckets \
            else options.bucket_bytes

    def close():
        nonlocal cur, cur_bytes
        if cur:
            buckets.append(_bucket(cur, ndev))
        cur, cur_bytes = [], 0

    for name, shape, dtype in entries:
        nbytes = (math.prod(shape) if len(shape) else 1) * 4
        if cur and cur_bytes + nbytes > cap():
            close()
        cur.append((name, shape, dtype))
        cur_bytes += nbytes
        if cur_bytes >= cap():
            close()
    close()
    if not buckets:
        raise ValueError("no gradients to plan buckets over")
    return BucketPlan(tuple(buckets), int(ndev), options)


def implicit_plan(entries, ndev):
    """One bucket a gradient, in ``entries``' order: the exchange the
    JAX package's implicit path makes (GSPMD's all-reduce a parameter
    gradient), float32 and averaged."""
    return BucketPlan(tuple(_bucket([e], ndev) for e in entries),
                      int(ndev), CommOptions())


# -- stochastic rounding noise -------------------------------------------------


def hash_uniform(shape, salt, offset=0, device=None):
    """Uniform noise in [-0.5, 0.5) from the lattice hash of
    ``gradcomm.py:227-249``, bit for bit: element ``i`` (row-major) of
    ``shape`` hashes index ``offset + i`` under the uint32 ``salt`` (an
    int, or an int64 tensor holding it)."""
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    if isinstance(salt, torch.Tensor):
        salt = salt.to(device=idx.device, dtype=torch.int64) & _M32
    else:
        salt = int(salt) & _M32
    x = ((idx ^ salt) * 2654435761) & _M32
    x = ((x ^ (x >> 16)) * 2246822519) & _M32
    x = ((x ^ (x >> 13)) * 3266489917) & _M32
    x = x ^ (x >> 16)
    return ((x >> 8).to(torch.float32) * 2.0 ** -24 - 0.5).reshape(shape)


def _quantize_rows(x, noise):
    """Per-row symmetric int8 quantization with stochastic rounding
    (``gradcomm.py:288-294``): ``(q int8, scale (rows, 1) float32)``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    scale = torch.clamp(x.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-30)
    q = torch.clamp(torch.round(x / scale + noise), -127, 127).to(torch.int8)
    return q, scale


def _bucket_salt(salt, i):
    """``salt * 0x9E3779B1 + i`` in uint32 (an int64 tensor)."""
    return (salt.to(torch.int64) * 0x9E3779B1 + i) & _M32


def exchange_bucketed(plan, flats, group=None, residuals=None, salt=None,
                      denom=None):
    """Reduce this rank's ``(padded,)`` float32 bucket flats over the
    group (``gradcomm.py:297-386``), in place: each flat becomes
    ``sum over ranks / denom`` (fp32) or its int8 estimate. ``denom``
    defaults to the rank count ("mean") times ``accumulate_steps``. The
    int8 path takes this rank's residuals (one ``(padded,)`` tensor a
    bucket, updated in place) and the salt (the step counter, a 0-d
    integer tensor). Returns ``flats``."""
    opts = plan.options
    _, n, rank = collective._group(group)
    if denom is None:
        denom = (float(n) if opts.gradient_scale == "mean" else 1.0) * \
            float(opts.accumulate_steps)
    dev = flats[0].device
    # a fill, not a copy from the host: a graph may capture it
    inv = torch.full((), 1.0 / denom, dtype=torch.float32, device=dev)
    if opts.quantize is None:
        for f in flats:
            collective.raw_all_reduce(f, group=group)
            f.mul_(inv)
        return flats
    if residuals is None or len(residuals) != len(flats):
        raise ValueError(
            "int8 exchange needs one error-feedback residual per bucket "
            f"(got {None if residuals is None else len(residuals)} for "
            f"{len(flats)} buckets)")
    if salt is None:
        raise ValueError("int8 exchange needs a salt (step counter) for "
                         "stochastic rounding")
    for i, (flat, resid) in enumerate(zip(flats, residuals)):
        F = flat.numel()
        C = F // n
        c = (flat * inv + resid).reshape(1, F)
        bsalt = _bucket_salt(salt, i)
        q1, scale1 = _quantize_rows(
            c, hash_uniform((1, F), bsalt, rank * F, dev))
        resid.copy_((c - q1.float() * scale1).reshape(F))
        x = collective.raw_all_to_all(q1.reshape(n, C), group)
        s1 = collective.raw_all_gather(scale1.reshape(1), group)
        y = (x.float() * s1).sum(0).reshape(1, C)
        q2, scale2 = _quantize_rows(
            y, hash_uniform((1, C), bsalt ^ 0xA5A5A5A5, rank * C, dev))
        q2r = collective.raw_all_gather(q2.reshape(C), group)
        s2r = collective.raw_all_gather(scale2.reshape(1), group)
        flat.copy_((q2r.float() * s2r).reshape(F))
    return flats


class Exchange:
    """A step's gradient exchange over ``group`` (None: this process
    alone, no collective): the plan over ``named`` (``(name,
    parameter)`` in the optimizer's order; the plan takes them reversed,
    the backward's order), one float32 flat a bucket on ``device``, and the
    error-feedback state of the int8 path in ``optimizer``'s state
    (``EF_PREFIX<i>.residual``, ``STEP_VAR.count``), where its
    ``state_dict`` and checkpoints carry it."""

    def __init__(self, plan, named, optimizer, group, device):
        self.plan, self.group = plan, group
        self.params = dict(named)
        self.flats = [torch.zeros(b.padded, dtype=torch.float32,
                                  device=device) for b in plan.buckets]
        self.unreached = set()
        self.last = None
        self.n, self.rank = (1, 0) if group is None else \
            collective._group(group)[1:]
        self.state_keys = ()
        if plan.options.quantize:
            keys = []
            for i, b in enumerate(plan.buckets):
                name = EF_PREFIX + str(i)
                s = optimizer._accumulators.setdefault(name, {})
                r = s.get("residual")
                if r is None:
                    r = torch.zeros(b.padded, dtype=torch.float32)
                elif tuple(r.shape) != (b.padded,):
                    raise ValueError(
                        f"{name}.residual has shape {tuple(r.shape)}; this "
                        f"plan's bucket {i} holds {b.padded} values")
                s["residual"] = r.to(device=device, dtype=torch.float32)
                keys.append(name)
            s = optimizer._accumulators.setdefault(STEP_VAR, {})
            s["count"] = s.get("count", torch.zeros((), dtype=torch.int32))\
                .to(device=device, dtype=torch.int32).reshape(())
            keys.append(STEP_VAR)
            self.state_keys = tuple(keys)
        self._opt = optimizer

    @torch.no_grad()
    def gather(self, first):
        """This rank's gradients into the flats: copied on the first
        microbatch of a window (a parameter without a gradient as
        zeros, and marked unreached), added after. Device work only."""
        if first:
            self.unreached = set()
        for b, flat in zip(self.plan.buckets, self.flats):
            for name, size, off in zip(b.names, b.sizes, b.offsets):
                g = self.params[name].grad
                dst = flat[off:off + size]
                if g is None:
                    if first:
                        self.unreached.add(name)
                        dst.zero_()
                elif first:
                    dst.copy_(g.reshape(-1))
                else:
                    dst.add_(g.reshape(-1))

    @torch.no_grad()
    def reduce(self, losses, denom):
        """Exchange the flats (``exchange_bucketed``) and the window's
        local losses, in place: ``losses`` becomes their sum over the
        ranks, over the rank count under "mean" (the JAX step's loss,
        ``jit.py:178-179``). Across ranks it records ``last``: the calls
        of each kind, the bytes and the host wall from the card's queued
        work done to the exchange done. In a process alone it is device
        work only, which a graph may capture."""
        if self.n == 1:
            inv = torch.full((), 1.0 / denom, dtype=torch.float32,
                             device=self.flats[0].device)
            for f in self.flats:
                f.mul_(inv)
            return losses
        if losses.is_cuda:
            torch.cuda.current_stream().synchronize()
        before = dict(collective.STATS)
        t0 = time.perf_counter()
        resid = salt = None
        if self.plan.options.quantize:
            acc = self._opt._accumulators
            resid = [acc[k]["residual"] for k in self.state_keys[:-1]]
            salt = acc[STEP_VAR]["count"]
        exchange_bucketed(self.plan, self.flats, self.group, resid, salt,
                          denom)
        if salt is not None:
            salt.add_(1)
        total = collective.raw_all_reduce(losses.float(), group=self.group)
        if self.plan.options.gradient_scale == "mean":
            total.div_(self.n)
        losses.copy_(total)
        if losses.is_cuda:
            torch.cuda.current_stream().synchronize()
        self.last = {k: collective.STATS[k] - before[k]
                     for k in collective.STATS
                     if collective.STATS[k] != before[k]}
        self.last["ms"] = (time.perf_counter() - t0) * 1e3
        return losses

    def grads(self):
        """``[(name, parameter, gradient)]`` in the optimizer's order,
        the gradient in the parameter's type (views of the flats when it
        is float32); unreached parameters left out: their update is
        skipped, as the JAX step skips it (``jit.py:179-189``)."""
        out = {}
        for b, flat in zip(self.plan.buckets, self.flats):
            for name, shape, size, off in zip(b.names, b.shapes, b.sizes,
                                              b.offsets):
                if name in self.unreached:
                    continue
                p = self.params[name]
                out[name] = flat[off:off + size].view(shape).to(p.dtype)
        return [(name, p, out[name]) for name, p in self.params.items()
                if name in out]
