"""ServeEngine: continuous-batching generation over the paged KV cache.

The serving data plane. Each ``step()`` takes one ``Scheduler`` batch
and drives it through two eager PyTorch steps, both under
``torch.inference_mode()``:

- **prefill** (shapes bucketed by context length): encode a newly
  admitted (or preemption-resumed) request's context, scatter its K/V
  into the pages the scheduler allocated, and emit the first generated
  token — the TTFT token.
- **decode** (shapes bucketed by batch size and table width): for every
  in-flight request, embed its newest token, append that token's K/V to
  its pages, run the ragged ``paged_decode_attention`` kernel (CUDA C++
  on the card) across the whole mixed batch, and emit each request's
  next token. Both steps write the K/V pools **in place**, so one copy
  of each pool stays resident across the run.

The buckets remain although nothing is compiled: padded decode lanes
write to the null page exactly as in the JAX engine, and ``compiles``
in ``stats()`` counts the distinct step shapes a run has used.

Decode semantics follow ``inference.decoder.greedy_search`` (argmax
continuation, EOS stop, fixed ``max_new_tokens`` cap); a ``sample_fn``
swaps the token choice (the beam analog lives in ``inference.decoder``
— beams multiply KV pages per request and stay out of the continuous
batch). Cache pressure reuses the resilience machinery end to end:
page exhaustion surfaces as ``CachePressureError`` (a
``TransientError``), and the engine relieves it inside
``resilience.policy.retry_call`` — preempting the scheduler's chosen
victim per retry under the policy's bounded budget, so every relief
attempt ticks ``resilience.retries`` and journals the same
``resilience.retry`` events a training guard would.

Per-request observability: lifecycle span markers
(``serving.request.{admit,first_token,finish}``), ``serving.*``
metrics (queue-depth gauge; TTFT/TPOT/e2e latency histograms with
p50/p99), and — when a run journal is active — one ``request`` record
per finished request (arrival/admit/first-token/finish timestamps,
pages held, preemptions) that ``tools/run_report.py`` summarizes.
All hooks follow the established zero-overhead contract: inactive
journal = one None check.
"""
from __future__ import annotations

import itertools
import time
import weakref

import numpy as np
import torch

from ..nn.layer import Layer
from ..core.tensor import Parameter
from .._device import resolve_device
from ..obs import journal as _journal
from ..obs import lockdep as _lockdep
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..obs import usage as _usage
from ..resilience import inject as _inject
from ..ops.kernels import paged_attention as _pa
from ..resilience.policy import RecoveryPolicy, retry_call
from .kv_cache import (CachePressureError, PagedKVCache,
                       PageAllocationError, write_tokens)
from .scheduler import CANCELLED, FINISHED, RUNNING, Request, Scheduler

__all__ = ["ServeEngine", "TinyLM", "live_engines", "request_phases",
           "preempt_loss_ms"]

# process-wide replica registry: every ServeEngine registers a weakref
# at construction, so the SLO exporter (obs.export.MetricsExporter with
# no explicit engine list) discovers every live replica in the process
# without any wiring. Weak by design — the registry must never keep a
# replaced replica (and its KV pools) alive.
_ENGINES_LOCK = _lockdep.lock("serving.engines")
_ENGINES: list = []
_REPLICA_IDS = itertools.count()


def live_engines():
    """Every ServeEngine constructed in this process and still alive,
    oldest first — the default scrape set for ``obs.export``."""
    out = []
    with _ENGINES_LOCK:
        keep = []
        for ref in _ENGINES:
            eng = ref()
            if eng is not None:
                keep.append(ref)
                out.append(eng)
        _ENGINES[:] = keep
    return out

# latency buckets: sub-ms toy decode through multi-second cold first
# prefills; +inf overflow implicit
_LAT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                250.0, 500.0, 1000.0, 2500.0, 5000.0, 15000.0, 60000.0)
_M_TTFT = _metrics.histogram("serving.ttft_ms", _LAT_BUCKETS)
_M_TPOT = _metrics.histogram("serving.tpot_ms", _LAT_BUCKETS)
_M_E2E = _metrics.histogram("serving.e2e_ms", _LAT_BUCKETS)
_M_STEP = _metrics.histogram("serving.step_ms", _LAT_BUCKETS)
_M_TOKENS = _metrics.counter("serving.tokens_generated")
_M_FINISHED = _metrics.counter("serving.requests_finished")
_M_CANCELLED = _metrics.counter("serving.requests_cancelled")

_DECODE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return n


def _len_bucket(n, floor):
    """Context-length bucket for prefill: next power of two (>= the
    page size). Unlike batch sizes, context lengths are unbounded —
    a fixed table would compile one executable per distinct length
    past its cap (and every preemption-resume depth is a distinct
    length); powers of two bound the cache at log2(max_seq_len)."""
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


class TinyLM(Layer):
    """A deterministic one-layer attention LM — the built-in serving
    model. Tied embeddings, one causal attention layer with residual,
    weights drawn from a seeded numpy RNG in the JAX ``TinyLM``'s order
    (``embedding``, ``wq``, ``wk``, ``wv``, ``wo``), so the same seed
    gives the same weights in both packages.

    ``reference_generate`` is the dense oracle: step-by-step greedy
    decode with a contiguous (unpaged) KV history — the engine's
    paged continuous-batching output is pinned token-for-token
    against it.

    Runs on ``device`` (default ``cuda``; ``"cpu"`` only when asked
    for). The weights are float32 parameters without gradients: this
    model only serves.
    """

    PARAMS = ("embedding", "wq", "wk", "wv", "wo")

    def __init__(self, vocab_size=32, num_heads=2, head_dim=8, seed=0,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.embed_dim = self.num_heads * self.head_dim
        rng = np.random.RandomState(seed)
        E = self.embed_dim

        def w(*shape):
            # float32 draws divided in float64 (numpy's promotion), then
            # rounded to float32 — as the JAX model's jnp.asarray does
            a = rng.randn(*shape).astype(np.float32) / np.sqrt(shape[0])
            return Parameter(
                torch.from_numpy(a).to(self.device, torch.float32),
                trainable=False)

        self.embedding = w(self.vocab_size, E)
        self.wq, self.wk, self.wv, self.wo = w(E, E), w(E, E), w(E, E), \
            w(E, E)

    def qkv(self, token_ids):
        """(N,) ids -> (emb (N,E), q/k/v (N,H,D))."""
        emb = torch.index_select(self.embedding, 0, token_ids)
        shp = (emb.shape[0], self.num_heads, self.head_dim)
        return (emb, (emb @ self.wq).reshape(shp),
                (emb @ self.wk).reshape(shp),
                (emb @ self.wv).reshape(shp))

    def head(self, attn, emb):
        """attention out (N,H,D) + residual -> logits (N,V) (tied)."""
        out = attn.reshape(emb.shape) @ self.wo + emb
        return out @ self.embedding.T

    @torch.inference_mode()
    def reference_generate(self, prompt, max_new_tokens, eos_id=None):
        """Dense greedy decode (contiguous KV, no paging): the oracle.
        The argmax runs on the host in numpy, as the engine's does, so
        ties break the same way."""
        ctx = [int(t) for t in prompt]
        for _ in range(max_new_tokens):
            ids = torch.tensor(ctx, dtype=torch.long, device=self.device)
            emb, q, k, v = self.qkv(ids)
            attn = _pa.dense_decode_reference(
                q[-1:], k[None], v[None])[0]           # (1,H,D)
            logits = self.head(attn[None], emb[-1:])
            nxt = int(np.argmax(logits[0].cpu().numpy()))
            ctx.append(nxt)
            if eos_id is not None and nxt == eos_id:
                break
        return ctx[len(prompt):]


class ServeEngine:
    """Continuous-batching serve loop over a model + paged KV cache.

    >>> eng = ServeEngine(TinyLM(), PagedKVCache(64, 8, 2, 8))
    >>> r = eng.submit([3, 1, 4], max_new_tokens=8)
    >>> eng.run()                       # until idle
    >>> r.generated

    Threading contract: ``step()``/``run()`` belong to ONE serve-loop
    thread. ``submit()`` and ``cancel()`` are safe from other threads
    (scheduler and cache state are lock-protected); a cancel landing
    while its request is inside the current step's batch takes effect
    at the next step boundary.
    """

    def __init__(self, model, cache, scheduler=None, policy=None,
                 sample_fn=None, clock=None, replica_id=None):
        self.model = model
        self.cache = cache
        if model.device != cache.device:
            raise ValueError(f"model is on {model.device}, cache on "
                             f"{cache.device}")
        self.device = cache.device
        if cache.num_heads != model.num_heads or \
                cache.head_dim != model.head_dim:
            raise ValueError(
                f"cache geometry ({cache.num_heads}h x {cache.head_dim}d)"
                f" != model ({model.num_heads}h x {model.head_dim}d)")
        if cache.num_layers != 1:
            # the engine's steps read/write layer 0 only; a
            # multi-layer pool would silently waste HBM on layers the
            # engine never touches (the allocator keeps the layer axis
            # for models driving the kernel directly)
            raise ValueError(
                f"ServeEngine drives single-layer models; got a "
                f"num_layers={cache.num_layers} pool")
        if scheduler is not None and scheduler.cache is not cache:
            raise ValueError(
                "scheduler wraps a different PagedKVCache than the one "
                "passed to ServeEngine — pages would allocate in one "
                "pool and be read from the other")
        self.scheduler = scheduler or Scheduler(
            cache, clock=clock if clock is not None else time.monotonic)
        if clock is not None and scheduler is not None:
            raise ValueError("pass clock via the Scheduler when you "
                             "construct one yourself")
        self.clock = self.scheduler.clock
        self.policy = policy or RecoveryPolicy(max_retries=3,
                                               sleep=lambda s: None)
        self.sample_fn = sample_fn
        self._shapes = set()     # (kind, bucket[, table width]) seen
        self._compiles = 0
        self._dispatches = 0
        self.finished = []       # completed Request objects, in order
        self._steps = 0
        self._last_emit = {}     # rid -> last token emission time
        # serializes step() against cancel(): a cancel landing while
        # its request is inside the current batch must wait for the
        # step boundary, or the freed rid KeyErrors the batch build
        # Lock order inside a replica: engine.step -> scheduler ->
        # cache (lockdep-checked under PADDLE_TPU_LOCKDEP)
        self._step_lock = _lockdep.rlock("serving.engine.step")
        # SLO-export identity: stable per process, rides the exporter's
        # replica="N" label so multi-replica scrapes stay attributable.
        # A fleet launcher passes the FLEET-assigned id instead — the
        # per-process counter restarts at 0 in every worker process, so
        # two replicas' scrapes would otherwise collide on replica="0"
        self.replica_id = next(_REPLICA_IDS) if replica_id is None \
            else int(replica_id)
        # per-tenant device-second attribution (obs.usage): charged
        # from step() always-on (plain int/dict arithmetic, the same
        # cost class as the step_ms histogram observe); read pull-only
        self.usage = _usage.UsageMeter(replica_id=self.replica_id)
        # requests that finished mid-step: their journal records are
        # deferred to the end of step() so the pass's device-second
        # charge is already in request_ns when the record is written
        self._finished_this_step = []
        with _ENGINES_LOCK:
            _ENGINES.append(weakref.ref(self))

    # -- intake --------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, rid=None, eos_id=None,
               arrival_t=None, trace=None, tenant=None):
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      rid=rid, eos_id=eos_id, arrival_t=arrival_t,
                      trace=trace, tenant=tenant)
        if any(not 0 <= t < self.model.vocab_size for t in req.prompt):
            raise ValueError("prompt token out of vocab range")
        # the deepest context this request can reach is
        # prompt + max_new_tokens - 1 (the final token never needs a
        # slot): reject what can NEVER fit, at the door. An oversize
        # request admitted anyway would ValueError mid-decode (killing
        # the loop for every other in-flight request); a
        # budget-unschedulable one would block the FIFO head forever —
        # a silent stall that starves everything queued behind it
        worst = len(req.prompt) + int(max_new_tokens) - 1
        if worst > self.cache.max_seq_len:
            raise ValueError(
                f"request needs up to {worst} cached tokens > "
                f"max_seq_len {self.cache.max_seq_len}")
        if worst > self.scheduler.token_budget:
            raise ValueError(
                f"request may re-prefill up to {worst} tokens > "
                f"token_budget {self.scheduler.token_budget}: it could "
                "never be (re-)admitted")
        return self.scheduler.submit(req)

    def cancel(self, request):
        """Tear down a request wherever it is (the chaos-kill path):
        pages freed, journaled as cancelled — alloc==free still holds.
        No-op on an already-terminal request: the cancel-vs-complete
        race must not double-journal or rewrite FINISHED state. Blocks
        until any in-flight step() completes (the documented next-
        step-boundary semantics) — tearing pages out from under the
        running batch would KeyError the serve loop."""
        with self._step_lock:
            if request.state in (FINISHED, CANCELLED):
                return
            self.scheduler.finish(request, state=CANCELLED)
            self._last_emit.pop(request.rid, None)
            _M_CANCELLED.inc()
            self._journal_request(request)

    # -- the two steps -------------------------------------------------------
    def _note_shape(self, kind, **fields):
        """Count the first use of a step shape — what the JAX engine
        counts as one compile — and journal it the same way."""
        key = (kind,) + tuple(sorted(fields.items()))
        if key in self._shapes:
            return
        self._shapes.add(key)
        self._compiles += 1
        if _journal.ACTIVE is not None:
            _journal.ACTIVE.event("compile", source="serving", entry=kind,
                                  **fields)

    def _prefill_step(self, tokens, length, pid, off):
        """Encode one padded context: write its K/V (padded positions go
        to the null page) and return the last live position's logits.
        ``tokens``/``pid``/``off`` are ``(Lb,)`` device tensors, ``length``
        the true context length (a host int)."""
        model, cache = self.model, self.cache
        emb, q, k, v = model.qkv(tokens)
        write_tokens(cache.k_pages, cache.v_pages, k, v, pid, off)
        last = length - 1
        attn = _pa.dense_decode_reference(
            q[last][None], k[None], v[None],
            lengths=torch.tensor([length], device=self.device))[0]
        return model.head(attn[None], emb[last][None])[0]

    def _decode_step(self, tokens, tables, lengths, slot_pages, slot_offs):
        """One batched decode: append each lane's newest K/V (written
        BEFORE attention, so ``lengths`` include the query), attend
        through the page tables with the paged kernel, return logits."""
        model, cache = self.model, self.cache
        emb, q, k, v = model.qkv(tokens)
        write_tokens(cache.k_pages, cache.v_pages, k, v, slot_pages,
                     slot_offs)
        attn = _pa.paged_decode_attention(
            q, cache.k_pages[0], cache.v_pages[0], tables, lengths)
        return model.head(attn, emb)

    def warm(self, max_batch=8):
        """Run EVERY bucketed step this engine can reach once, up front:
        all prefill context-length buckets (the ``_len_bucket``
        power-of-two ladder from ``page_size`` to ``max_seq_len``) and
        every decode (batch-bucket, table-width) pair up to
        ``max_batch`` lanes — the JAX engine's ``warm()`` set, entry for
        entry, each counted and journaled as that engine's compile is.
        Each step reads and writes the null page only (page 0, every
        table entry and write slot), so no sequence's pages change; on
        the card it loads the kernel library and pays every shape's
        first launch before a fleet replica reports ready. There is no
        executable to cache: a later step of the same shape runs
        exactly as a warmed one did. Returns the number of entries
        warmed."""
        dev, page_size = self.device, self.cache.page_size
        n = 0
        with torch.inference_mode():
            blen = page_size
            while True:
                bucket_len = _len_bucket(blen, page_size)
                self._note_shape("prefill", bucket=bucket_len)
                self._prefill_step(
                    torch.zeros(bucket_len, dtype=torch.long, device=dev),
                    1, torch.zeros(bucket_len, dtype=torch.long,
                                   device=dev),
                    torch.arange(bucket_len, device=dev) % page_size)
                n += 1
                if blen >= self.cache.max_seq_len:
                    break
                blen *= 2
            # reachable table widths are _len_bucket(pages, 1) clamped
            # to the pool-wide maximum — enumerate exactly that set
            widths, w = [], 1
            while w < self.cache.table_width:
                widths.append(w)
                w *= 2
            widths.append(self.cache.table_width)
            for b in _DECODE_BUCKETS:
                if b > max(int(max_batch), 1):
                    break
                zeros = torch.zeros(b, dtype=torch.int32, device=dev)
                for w in widths:
                    self._note_shape("decode", bucket=b, table_width=w)
                    self._decode_step(
                        torch.zeros(b, dtype=torch.long, device=dev),
                        torch.zeros((b, w), dtype=torch.int32, device=dev),
                        torch.ones(b, dtype=torch.int32, device=dev),
                        zeros, zeros)
                    n += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)   # a failed launch shows here
        return n

    # -- the serve loop ------------------------------------------------------
    def step(self):
        """One engine iteration: schedule, prefill admissions, decode
        the running set, retire finished requests. Returns the Batch
        served (falsy when idle)."""
        with self._step_lock:   # cancel() waits for the step boundary
            if _inject.ACTIVE and "replica_kill" in _inject.ACTIVE:
                # serve-loop chaos boundary (the elastic.fire_step_chaos
                # twin): lets the fleet drill kill THIS replica mid-step,
                # gated on serve-step count + replica id. Inactive cost:
                # one empty-dict truthiness test
                _inject.fire("replica_kill", step=self._steps + 1,
                             rank=self.replica_id)
            t0 = self.clock()
            batch = self.scheduler.schedule()
            if not batch:
                return batch
            if _journal.ACTIVE is not None and batch.decodes:
                # reqtrace decode-step mark: which requests decoded at
                # which engine clock — the per-step resolution the
                # assembled timelines anchor decode progress on
                _journal.ACTIVE.event(
                    "req.decode_mark", at=t0, step=self._steps + 1,
                    replica=self.replica_id,
                    rids=[r.rid for r in batch.decodes])
            try:
                with _trace.span("serving.step",
                                 prefills=len(batch.prefills),
                                 decodes=len(batch.decodes)):
                    for req in batch.prefills:
                        p0 = self.clock()
                        self._prefill_one(req)
                        self.usage.charge_prefill(req,
                                                  self.clock() - p0)
                    if batch.decodes:
                        d0 = self.clock()
                        survivors = self._decode_batch(
                            [r for r in batch.decodes
                             if r.state == RUNNING])
                        # the span splits across the lanes that
                        # actually decoded; an all-preempted pass
                        # charges nobody
                        self.usage.charge_decode(survivors,
                                                 self.clock() - d0)
            finally:
                # journal finishes only now: the pass's charge is in
                # request_ns, so the record's device_ns is final
                for req in self._finished_this_step:
                    self._journal_request(req)
                del self._finished_this_step[:]
            self._steps += 1
            step_ms = (self.clock() - t0) * 1e3
            _M_STEP.observe(step_ms)
            return batch

    def run(self, max_steps=None):
        """Serve until idle (or ``max_steps``). Returns steps taken."""
        steps = 0
        while not self.scheduler.idle:
            if max_steps is not None and steps >= max_steps:
                break
            if not self.step():
                break  # budget/pool gridlock: nothing schedulable
            steps += 1
        return steps

    # -- prefill -------------------------------------------------------------
    def _prefill_one(self, req):
        ctx = req.context
        L = len(ctx)
        page_size = self.cache.page_size
        bucket_len = _len_bucket(L, page_size)
        self._note_shape("prefill", bucket=bucket_len)
        tokens = np.zeros(bucket_len, np.int64)
        tokens[:L] = ctx
        pages = np.asarray(self.cache.page_table(req.rid), np.int64)
        # positions past the context write to the null page
        pos = np.arange(bucket_len)
        pid = np.zeros(bucket_len, np.int64)
        pid[:L] = pages[pos[:L] // page_size]
        dev = self.device
        with _trace.span("serving.prefill", rid=req.rid, tokens=L), \
                torch.inference_mode():
            logits = self._prefill_step(
                torch.from_numpy(tokens).to(dev), L,
                torch.from_numpy(pid).to(dev),
                torch.from_numpy(pos % page_size).to(dev))
            self._dispatches += 1
            logits = logits.cpu().numpy()   # the TTFT token's host sync
            self._emit_token(req, logits, first=req.first_token_t is None)

    # -- decode --------------------------------------------------------------
    def _relieve_pressure(self, req):
        victim = self.scheduler.preempt_for(req)
        if victim is None:
            raise PageAllocationError(
                f"pool too small for {req.rid!r}: nothing to preempt")
        if _journal.ACTIVE is not None:
            _journal.ACTIVE.event("serving.preempt", victim=victim.rid,
                                  for_request=req.rid)

    def _decode_batch(self, decodes):
        survivors = []
        for r in decodes:
            if r.state != RUNNING:
                continue  # preempted relieving an earlier lane
            if self.cache.length(r.rid) >= self.cache.max_seq_len:
                # belt-and-braces for requests submitted around
                # ``submit()`` (straight to the scheduler): finish
                # truncated instead of letting extend() ValueError
                # take down the whole serve loop
                self._finish(r)
                continue
            try:
                retry_call(lambda: self.scheduler.extend(r, 1),
                           self.policy, describe=f"extend {r.rid}",
                           before_retry=lambda: self._relieve_pressure(r))
                survivors.append(r)
            except (CachePressureError, PageAllocationError):
                # relief budget spent, or no other victim exists
                # (PageAllocationError from _relieve_pressure): r
                # itself yields its pages and requeues
                self.scheduler.preempt(r)
        # relieving a LATER lane may have preempted an earlier survivor
        # (it was the youngest running) — it no longer holds pages
        survivors = [r for r in survivors if r.state == RUNNING]
        if not survivors:
            return survivors
        n = len(survivors)
        bucket = _bucket(n, _DECODE_BUCKETS)
        rids = [r.rid for r in survivors]
        need = max(len(self.cache.page_table(rid)) for rid in rids)
        # table width is bucketed by the batch's ACTUAL max pages, not
        # the pool-wide maximum: the table's width bounds the pages a
        # lane may reach, so a pool-wide table would only pad
        W = min(_len_bucket(need, 1), self.cache.table_width)
        self._note_shape("decode", bucket=bucket, table_width=W)
        tokens = np.zeros(bucket, np.int64)
        tokens[:n] = [r.context[-1] for r in survivors]
        tables = np.zeros((bucket, W), np.int32)
        tables[:n] = self.cache.padded_page_tables(rids, width=W)
        lengths = np.zeros(bucket, np.int32)
        lengths[:n] = [self.cache.length(rid) for rid in rids]
        slot_pages = np.zeros(bucket, np.int32)   # padding -> null page
        slot_offs = np.zeros(bucket, np.int32)
        sp, so = self.cache.write_slots(rids)
        slot_pages[:n], slot_offs[:n] = sp, so
        dev = self.device
        with _trace.span("serving.decode", batch=n, bucket=bucket), \
                torch.inference_mode():
            logits = self._decode_step(
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(lengths).to(dev),
                torch.from_numpy(slot_pages).to(dev),
                torch.from_numpy(slot_offs).to(dev))
            self._dispatches += 1
            logits = logits.cpu().numpy()   # ONE host sync per step
            for i, r in enumerate(survivors):
                self._emit_token(r, logits[i],
                                 first=r.first_token_t is None)
        return survivors

    # -- token plumbing ------------------------------------------------------
    def _choose(self, logits_row):
        if self.sample_fn is not None:
            return int(self.sample_fn(logits_row))
        return int(np.argmax(np.asarray(logits_row)))

    def _emit_token(self, req, logits_row, first=False):
        now = self.clock()
        tok = self._choose(logits_row)
        req.generated.append(tok)
        _M_TOKENS.inc()
        if first:
            req.first_token_t = now
            _M_TTFT.observe((now - req.arrival_t) * 1e3)
            with _trace.span("serving.request.first_token", rid=req.rid):
                pass
        else:
            _M_TPOT.observe((now - self._last_emit.get(req.rid, now))
                            * 1e3)
        self._last_emit[req.rid] = now
        if req.done:
            self._finish(req)

    def _finish(self, req):
        self.scheduler.finish(req, state=FINISHED)
        self._last_emit.pop(req.rid, None)
        self.finished.append(req)
        _M_FINISHED.inc()
        _M_E2E.observe((req.finish_t - req.arrival_t) * 1e3)
        with _trace.span("serving.request.finish", rid=req.rid,
                         tokens=len(req.generated)):
            pass
        # deferred: step() journals after the pass's usage charge lands
        self._finished_this_step.append(req)

    # -- observability -------------------------------------------------------
    def _journal_request(self, req):
        if _journal.ACTIVE is not None:
            extra = request_phases(req)
            if req.trace is not None:
                extra["trace"] = req.trace
            # chargeback extras: resolved tenant + the int-ns device /
            # page integrals, so obs.usage.rollup_requests rebuilds the
            # per-tenant table from journals alone, exact to the ns
            extra["tenant"] = req.tenant or _usage.DEFAULT_TENANT
            extra["device_ns"] = self.usage.request_ns.get(req.rid, 0)
            extra["page_ns"] = self.cache.closed_page_ns(req.rid)
            _journal.ACTIVE.record_request(
                rid=req.rid, state=req.state,
                arrival_t=req.arrival_t, admit_t=req.admit_t,
                first_token_t=req.first_token_t, finish_t=req.finish_t,
                prompt_tokens=len(req.prompt),
                output_tokens=len(req.generated),
                pages_peak=req.pages_peak,
                preemptions=req.preemptions, replica=self.replica_id,
                **extra)

    def stats(self):
        """Engine + pool + latency snapshot (plain data). Latency
        percentiles are computed from THIS engine's finished requests
        (exact, per-instance) — the ``serving.*`` histograms remain
        the process-wide view and would misattribute other engines'
        samples here."""
        snap = {
            "steps": self._steps, "compiles": self._compiles,
            "dispatches": self._dispatches,
            "finished": len(self.finished),
            "queue_depth": self.scheduler.queue_depth,
            "running": len(self.scheduler.running),
            "preemptions": self.scheduler.preemptions,
            "kv": self.cache.stats(),
            "usage": self.usage.snapshot(),
        }
        fin = list(self.finished)
        lat = {
            "ttft_ms": [(r.first_token_t - r.arrival_t) * 1e3
                        for r in fin if r.first_token_t is not None],
            "tpot_ms": [(r.finish_t - r.first_token_t) * 1e3 /
                        (len(r.generated) - 1)
                        for r in fin if len(r.generated) > 1
                        and r.first_token_t is not None],
            "e2e_ms": [(r.finish_t - r.arrival_t) * 1e3 for r in fin
                       if r.finish_t is not None],
        }
        for name, xs in lat.items():
            if xs:
                snap[name] = {"count": len(xs),
                              "p50": _metrics.exact_percentile(xs, 50),
                              "p99": _metrics.exact_percentile(xs, 99)}
        # phase attribution sums over finished requests (the numerators
        # of the per-replica phase-share gauges obs.export publishes):
        # queue (arrival->admit) + prefill + preempt + decode == e2e
        phases = {"queue": 0.0, "prefill": 0.0, "preempt": 0.0,
                  "decode": 0.0}
        for r in fin:
            if r.admit_t is not None and r.arrival_t is not None:
                phases["queue"] += (r.admit_t - r.arrival_t) * 1e3
            p = request_phases(r)
            phases["prefill"] += p.get("prefill_ms", 0.0)
            phases["preempt"] += p.get("preempt_ms", 0.0)
            phases["decode"] += p.get("decode_ms", 0.0)
        snap["phase_ms"] = phases
        return snap


def preempt_loss_ms(req):
    """Total wall time ``req`` spent preempted, in ms: every
    ``preempt_ts[i]`` pairs with ``resume_ts[i]`` (the scheduler stamps
    both), and a final unpaired preempt — the request was torn down
    while still PREEMPTED — pairs with ``finish_t``."""
    loss = 0.0
    for i, p in enumerate(req.preempt_ts):
        end = req.resume_ts[i] if i < len(req.resume_ts) else req.finish_t
        if end is not None:
            loss += (end - p) * 1e3
    return loss


def request_phases(req):
    """Engine-side phase decomposition of one terminal request (ms):
    ``prefill_ms`` (admit -> first token), ``preempt_ms`` (total time
    parked by preemption), ``decode_ms`` (first token -> finish, minus
    preemption loss). Together with the ``queue_ms`` the journal
    derives (arrival -> admit) the four telescope exactly to e2e —
    the attribution invariant ``obs.reqtrace`` builds on. Fields are
    emitted only when their stamps exist (a rejected request has no
    admission, a cancelled one may have no first token)."""
    out = {}
    if req.admit_t is not None and req.first_token_t is not None:
        out["prefill_ms"] = (req.first_token_t - req.admit_t) * 1e3
    if req.finish_t is not None:
        if req.preempt_ts:
            out["preempt_ms"] = preempt_loss_ms(req)
        if req.first_token_t is not None:
            out["decode_ms"] = (req.finish_t - req.first_token_t) * 1e3 \
                - out.get("preempt_ms", 0.0)
    return out

