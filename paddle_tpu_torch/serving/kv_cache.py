"""Paged KV-cache: fixed-size pages from one preallocated device pool.

The serving memory model (vLLM's PagedAttention, arXiv 2604.15464's
TPU shape): instead of one contiguous ``(B, max_len, H, D)`` cache —
which reserves worst-case length for every request and fragments the
batch — the pool is ``num_pages`` fixed-size pages, and each sequence
holds an ordered *page table* of the pages its tokens live in. Free
pages are a **host-side free list**: allocation and release are pure
Python bookkeeping (no device traffic), and the device pools change
only through the engine's prefill/decode steps, which write new
tokens' K/V **in place** (``write_tokens``, an ``index_put_``) — one
resident copy of each pool across the run.

Page 0 is the **null page**: never allocated, it absorbs the K/V
writes of padded batch lanes (a bucketed decode step always writes B
lanes; parking dead lanes on a real page would corrupt a live
sequence) and backs the clamped tail entries of padded page tables.

Accounting is strict: every page is either in the free list or in
exactly one sequence's table (``verify()``), so ``alloc == free``
balance after any request teardown — including a chaos-killed one —
is a testable invariant, not a hope.
"""
from __future__ import annotations

import time as _time

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from ..obs import lockdep as _lockdep
from ..obs import metrics as _metrics
from ..resilience.policy import TransientError

__all__ = ["PagedKVCache", "PageAllocationError", "CachePressureError",
           "write_tokens"]

_M_USED = _metrics.gauge("serving.kv.used_pages")
_M_FREE = _metrics.gauge("serving.kv.free_pages")
_M_ALLOCS = _metrics.counter("serving.kv.page_allocs")
_M_FREES = _metrics.counter("serving.kv.page_frees")


class PageAllocationError(RuntimeError):
    """The pool cannot satisfy an allocation (free list exhausted)."""


class CachePressureError(TransientError):
    """Page pressure the scheduler may relieve by preempting a victim —
    a ``TransientError`` so the engine's ``RecoveryPolicy`` retry path
    (``resilience.policy.retry_call``) drives relief with the same
    bounded-retry machinery every other recoverable fault uses."""


class PagedKVCache:
    """Host-side allocator + device-side pools for paged K/V.

    >>> cache = PagedKVCache(num_pages=64, page_size=16, num_heads=4,
    ...                      head_dim=32, device="cpu")
    >>> cache.alloc("req1", 40)        # 3 pages for a 40-token prompt
    >>> cache.extend("req1")           # decode: page 3 only at 49->...
    >>> cache.free("req1")

    Device pools ``k_pages``/``v_pages`` are ``(num_layers, num_pages,
    page_size, num_heads, head_dim)`` torch tensors on ``device``
    (default ``cuda``; ``"cpu"`` only when asked for), created lazily on
    first touch. The engine's steps update them in place — the
    allocator only hands out page ids.
    """

    NULL_PAGE = 0

    def __init__(self, num_pages, page_size, num_heads, head_dim,
                 num_layers=1, dtype="float32", max_seq_len=None,
                 device=None):
        self.device = resolve_device(device)
        self.torch_dtype = resolve_dtype(dtype)
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_layers = int(num_layers)
        self.dtype = dtype
        capacity = (self.num_pages - 1) * self.page_size
        self.max_seq_len = int(max_seq_len) if max_seq_len else capacity
        if self.max_seq_len > capacity:
            # advertising more than the pool holds would defeat the
            # engine's at-the-door oversize rejection: an accepted
            # request could still never be admitted (permanent FIFO-
            # head stall for everything queued behind it)
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds pool capacity "
                f"{capacity} tokens ({self.num_pages - 1} usable pages "
                f"x {self.page_size})")
        # lowest-id-first allocation keeps traces deterministic
        self._free = sorted(range(1, self.num_pages))
        self._tables = {}    # seq_id -> [page ids, in order]
        self._lengths = {}   # seq_id -> tokens stored
        # page-second attribution (obs.usage): integrate pages-held x
        # time per sequence, in INTEGER nanoseconds so per-tenant sums
        # are exact (float accumulation is not associative). The clock
        # is injectable (Scheduler aligns it with its own) so the
        # integrals are ManualClock-exact in tests; stamps live and die
        # with the page table, so closure (no open stamp without a
        # table) is part of verify().
        self.clock = None             # None -> time.monotonic
        self._page_open = {}          # seq_id -> [last_ns, pages, acc_ns]
        self._page_ns = {}            # seq_id -> closed integral (int ns)
        self._seq_allocs = 0          # alloc() calls granted a table
        self._seq_frees = 0           # free() calls that released one
        # leaf of the serving order (engine.step -> scheduler -> cache):
        # nothing may be acquired while this is held
        self._lock = _lockdep.lock("serving.kv_cache")
        self._k = None
        self._v = None
        self._update_gauges()

    # -- device pools --------------------------------------------------------
    @property
    def k_pages(self):
        self._ensure_pools()
        return self._k

    @property
    def v_pages(self):
        self._ensure_pools()
        return self._v

    def _ensure_pools(self):
        if self._k is None:
            shape = (self.num_layers, self.num_pages, self.page_size,
                     self.num_heads, self.head_dim)
            self._k = torch.zeros(shape, dtype=self.torch_dtype,
                                  device=self.device)
            self._v = torch.zeros(shape, dtype=self.torch_dtype,
                                  device=self.device)

    def set_pools(self, k_pages, v_pages):
        """Install replacement pools (same shape, type and device). The
        engine's steps write the pools in place and never call this; it
        is the only sanctioned way to swap the buffers, so the page
        accounting and its stamps always describe the pools in use."""
        shape = (self.num_layers, self.num_pages, self.page_size,
                 self.num_heads, self.head_dim)
        for t in (k_pages, v_pages):
            if tuple(t.shape) != shape or t.dtype != self.torch_dtype or \
                    t.device != self.device:
                raise ValueError(
                    f"pool must be {shape} {self.torch_dtype} on "
                    f"{self.device}, got {tuple(t.shape)} {t.dtype} on "
                    f"{t.device}")
        self._k, self._v = k_pages, v_pages

    # -- allocation ----------------------------------------------------------
    def pages_needed(self, n_tokens):
        return -(-int(n_tokens) // self.page_size)

    def can_alloc(self, n_tokens):
        with self._lock:
            return self.pages_needed(n_tokens) <= len(self._free)

    def alloc(self, seq_id, n_tokens):
        """Allocate pages for ``n_tokens`` (a prompt). All-or-nothing:
        on pressure nothing is held. Returns the page ids granted."""
        n_tokens = int(n_tokens)
        if n_tokens > self.max_seq_len:
            raise ValueError(
                f"sequence of {n_tokens} tokens exceeds max_seq_len "
                f"{self.max_seq_len}")
        need = self.pages_needed(n_tokens)
        with self._lock:
            if seq_id in self._tables:
                raise KeyError(f"sequence {seq_id!r} already allocated")
            if need > len(self._free):
                raise PageAllocationError(
                    f"need {need} pages for {n_tokens} tokens, "
                    f"{len(self._free)} free")
            pages = [self._free.pop(0) for _ in range(need)]
            self._tables[seq_id] = pages
            self._lengths[seq_id] = n_tokens
            self._page_open[seq_id] = [self._stamp_ns(), need, 0]
            self._seq_allocs += 1
            _M_ALLOCS.inc(need)
            self._update_gauges_locked()
            return list(pages)

    def extend(self, seq_id, n_tokens=1):
        """Grow a sequence by ``n_tokens`` (decode appends). Allocates
        a new page only when the last page fills; all-or-nothing under
        pressure (the sequence keeps its old length). Returns the list
        of newly granted pages (usually empty)."""
        n_tokens = int(n_tokens)
        with self._lock:
            if seq_id not in self._tables:
                raise KeyError(f"unknown sequence {seq_id!r}")
            cur = self._lengths[seq_id]
            if cur + n_tokens > self.max_seq_len:
                raise ValueError(
                    f"sequence {seq_id!r} would exceed max_seq_len "
                    f"{self.max_seq_len}")
            need = self.pages_needed(cur + n_tokens) - \
                self.pages_needed(cur)
            if need > len(self._free):
                raise PageAllocationError(
                    f"extend({seq_id!r}) needs {need} page(s), "
                    f"{len(self._free)} free")
            new = [self._free.pop(0) for _ in range(need)]
            self._tables[seq_id].extend(new)
            self._lengths[seq_id] = cur + n_tokens
            if new:
                # page count changed: close the integral's interval at
                # the OLD count and restamp at the new one
                st = self._page_open[seq_id]
                now = self._stamp_ns()
                st[2] += (now - st[0]) * st[1]
                st[0] = now
                st[1] += len(new)
                _M_ALLOCS.inc(len(new))
            self._update_gauges_locked()
            return new

    def free(self, seq_id):
        """Release every page a sequence holds (finish, preemption, or
        a chaos-killed request — the teardown path is the same).
        Returns the number of pages released; unknown ids are a no-op
        (teardown must be idempotent under crash-retry)."""
        with self._lock:
            pages = self._tables.pop(seq_id, None)
            self._lengths.pop(seq_id, None)
            if pages is not None:
                # close the page-second integral; a re-admission after
                # preemption re-allocs under the same seq_id, so closed
                # integrals ACCUMULATE across incarnations
                st = self._page_open.pop(seq_id)
                st[2] += (self._stamp_ns() - st[0]) * st[1]
                self._page_ns[seq_id] = \
                    self._page_ns.get(seq_id, 0) + st[2]
                self._seq_frees += 1
            if not pages:
                return 0
            self._free.extend(pages)
            self._free.sort()
            _M_FREES.inc(len(pages))
            self._update_gauges_locked()
            return len(pages)

    # -- page-second attribution ---------------------------------------------
    def _stamp_ns(self):
        """Now, in integer nanoseconds on the injected clock. Called
        under the leaf lock; the clock is a plain callable (monotonic
        or a ManualClock read), never blocking."""
        clk = self.clock
        return int(round((clk() if clk is not None else
                          _time.monotonic()) * 1e9))

    def page_usage(self):
        """Pull-only snapshot of the page-second integrals: per-seq
        CLOSED integrals (int ns; accumulated across preempt/re-admit
        incarnations), currently-OPEN page counts, and the alloc/free
        closure counters. Nothing here mutates the integrals."""
        with self._lock:
            return {
                "closed_ns": dict(self._page_ns),
                "open": {sid: st[1]
                         for sid, st in self._page_open.items()},
                "seq_allocs": self._seq_allocs,
                "seq_frees": self._seq_frees,
            }

    def closed_page_ns(self, seq_id):
        """Closed page-second integral for one sequence (int ns)."""
        with self._lock:
            return self._page_ns.get(seq_id, 0)

    @property
    def page_bytes(self):
        """HBM bytes one page pins across BOTH pools and all layers —
        the page-MB-s chargeback conversion factor."""
        itemsize = self.torch_dtype.itemsize
        return (2 * self.num_layers * self.page_size * self.num_heads
                * self.head_dim * itemsize)

    # -- introspection (locked like the mutators: the engine loop is
    # single-threaded, but submit/cancel may come from other threads
    # and a torn read here would KeyError the whole serve step) -------------
    def page_table(self, seq_id):
        with self._lock:
            return list(self._tables[seq_id])

    def length(self, seq_id):
        with self._lock:
            return self._lengths[seq_id]

    def sequences(self):
        with self._lock:
            return sorted(self._tables)

    def padded_page_tables(self, seq_ids, width=None):
        """``(len(seq_ids), width)`` int32 table for the kernel, tail
        entries parked on the null page. ``width`` defaults to the
        pool-wide maximum (``max_seq_len`` pages); callers batching
        short contexts pass the batch's own bucket so the kernel grid
        stays O(context)."""
        width = width or self.table_width
        out = np.full((len(seq_ids), width), self.NULL_PAGE, np.int32)
        with self._lock:
            for i, sid in enumerate(seq_ids):
                pages = self._tables[sid]
                if len(pages) > width:
                    raise ValueError(
                        f"sequence {sid!r} holds {len(pages)} pages > "
                        f"table width {width}")
                out[i, :len(pages)] = pages
        return out

    @property
    def table_width(self):
        return self.pages_needed(self.max_seq_len)

    def write_slots(self, seq_ids):
        """``(page_id, offset)`` arrays addressing each sequence's NEXT
        token slot (position == current length). The caller must have
        ``extend``-ed first so the page exists."""
        pages = np.empty(len(seq_ids), np.int32)
        offs = np.empty(len(seq_ids), np.int32)
        with self._lock:
            for i, sid in enumerate(seq_ids):
                pos = self._lengths[sid] - 1
                pages[i] = self._tables[sid][pos // self.page_size]
                offs[i] = pos % self.page_size
        return pages, offs

    def stats(self):
        """Pool occupancy + fragmentation: ``utilization`` is live
        tokens over the capacity of the pages holding them (1.0 = no
        internal fragmentation); ``fragmentation`` its complement."""
        with self._lock:
            used = self.num_pages - 1 - len(self._free)
            tokens = sum(self._lengths.values())
            cap = used * self.page_size
            return {
                "num_pages": self.num_pages,
                "page_size": self.page_size,
                "used_pages": used,
                "free_pages": len(self._free),
                "sequences": len(self._tables),
                "tokens": tokens,
                "utilization": (tokens / cap) if cap else 1.0,
                "fragmentation": (1.0 - tokens / cap) if cap else 0.0,
            }

    def verify(self):
        """Every page (except null) is free or owned exactly once."""
        with self._lock:
            owned = [p for t in self._tables.values() for p in t]
            seen = set(owned)
            assert len(owned) == len(seen), "page owned twice"
            assert not (seen & set(self._free)), "page both free+owned"
            assert self.NULL_PAGE not in seen, "null page allocated"
            total = 1 + len(self._free) + len(owned)
            assert total == self.num_pages, \
                f"page leak: {self.num_pages - total} unaccounted"
            # page-second closure: an open stamp exists iff the page
            # table does (alloc==free discipline for the integrals)
            assert set(self._page_open) == set(self._tables), \
                "page-second stamp out of sync with page tables"
            assert self._seq_allocs - self._seq_frees == \
                len(self._tables), "page-second alloc/free counter leak"
        return True

    def _update_gauges_locked(self):
        _M_USED.set(self.num_pages - 1 - len(self._free))
        _M_FREE.set(len(self._free))

    def _update_gauges(self):
        with self._lock:
            self._update_gauges_locked()


def write_tokens(k_pages, v_pages, k_new, v_new, page_ids, offsets,
                 layer=0):
    """In-place scatter of one new token per lane into the pools:
    ``k_new``/``v_new`` are ``(B, H, D)``, ``page_ids``/``offsets``
    ``(B,)`` integer tensors. Returns the (same) pools.

    Padded lanes all target the null page (often at one offset), and
    ``index_put_`` leaves which duplicate wins unspecified. That is
    harmless: page 0 is never allocated, so no live sequence reads it
    (a padded lane's length is 0 and its clamped table entries are
    masked)."""
    idx = (page_ids.long(), offsets.long())
    k_pages[layer].index_put_(idx, k_new.to(k_pages.dtype))
    v_pages[layer].index_put_(idx, v_new.to(v_pages.dtype))
    return k_pages, v_pages
