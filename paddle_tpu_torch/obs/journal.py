"""RunJournal: an append-only JSONL flight recorder for one run.

The serving core of ``paddle_tpu.obs.journal``, with the same record
schema: a durable ``journal.jsonl`` under a run directory (an explicit
path or env ``PADDLE_TPU_RUN_DIR``) holding

- one ``run_start`` header (pid, argv, env knobs),
- discrete ``event`` records (compile, preemption, retry, chaos
  activation, lock-order cycles, the reqtrace lifecycle marks),
- one ``request`` record per finished request (lifecycle timestamps on
  the serving clock, derived latencies, pages and preemptions),
- a ``step`` record per training step (``record_step``: loss, fetches
  summary, step_ms, examples/s, FLOPs when the caller knows them,
  skipped/nonfinite marks),
- ``anomaly`` records from the step detectors (``obs.anomaly``:
  ``LossSpike``, ``LossPlateau``, ``NonfiniteStreak``,
  ``ThroughputDrop``, ...) evaluated on every step record,
- a ``backend`` event with the torch device probe and the peak FLOP/s,
  written with the first request or step record (by then the run has
  touched its device) or earlier through ``note_backend()``, and
- one ``run_end`` summary with the MFU/goodput accounting
  (``obs.mfu``).

Write path: records buffer in memory and flush every ``flush_every``
records or ``flush_interval_s`` seconds — a line is written whole, so a
reader never sees a torn record. The file rotates at ``max_bytes``
(``journal.jsonl`` is always the live tail; rotated parts are
``journal.<n>.jsonl``). An unclosed journal flushes on interpreter exit;
an exception leaving the ``with`` block (or an explicit
``postmortem()``) also dumps ``postmortem.json``.

Hook contract: every production hook is ``if _journal.ACTIVE is not
None: ...`` — with no journal the serve and step paths pay one None
check. With a journal, summarizing a step's loss tensor costs one
scalar device->host read.

The static ``Executor`` journals each ``run`` as one step record
(``record_executor_run``, ``source="executor"``) and each ``run_steps``
window as one record with ``steps_fused=K`` (``record_fused_run``); the
``Predictor`` journals each ``run`` with ``source="predictor"`` and the
caller's batch as its examples. Their ``flops`` and ``comm`` stay None:
the reference reads them from XLA's analysis of the compiled entry,
which the port's CUDA graphs have no counterpart of yet (ROADMAP Queue
1 item 8). ``record_plan`` journals any object with ``event_fields()``;
``record_memory`` journals the byte fields its caller gives (the
compiled-entry prediction waits for ``analysis/memory.py``, item 9).

Not here yet: the start at import from ``PADDLE_TPU_RUN_DIR``
(``start_run()`` reads that variable when it is given no directory).
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import time
from collections import deque

from . import lockdep as _lockdep
from . import metrics as _metrics
from . import trace as _trace
from .anomaly import AnomalyEngine, default_detectors
from .mfu import MFUAccounting, peak_flops

__all__ = ["RunJournal", "ACTIVE", "start_run", "end_run",
           "JOURNAL_FILE", "POSTMORTEM_FILE", "TRACE_FILE", "RANK_ENV",
           "SUPERVISOR_DIR", "ROUTER_DIR", "rank_subdir", "env_rank"]

JOURNAL_FILE = "journal.jsonl"
POSTMORTEM_FILE = "postmortem.json"
TRACE_FILE = "trace.json"
# the rank identity a gang launcher hands each worker, alongside a
# per-rank run dir
RANK_ENV = "PADDLE_TPU_RANK"
# where a supervisor's own events land under the fleet run dir — ONE
# constant shared by the writer and the reader (obs.fleet); a rename on
# either side would silently orphan the record
SUPERVISOR_DIR = "supervisor"
# likewise for the serve-fleet router's own journal (writer:
# serving.fleet.Router / drill; reader: obs.fleet.router_summary)
ROUTER_DIR = "router"

# The active journal every hook checks (mirrors resilience.inject.ACTIVE:
# None => hooks are a single None check and nothing else).
ACTIVE = None


def rank_subdir(rank):
    """One naming convention for per-rank journal dirs (``rank_00``,
    ``rank_01``, ...)."""
    return f"rank_{int(rank):02d}"


def env_rank(env=None):
    """This process's rank from ``PADDLE_TPU_RANK``, or None outside a
    supervised gang (or on an unparseable value — identity must never
    break journaling)."""
    v = (env if env is not None else os.environ).get(RANK_ENV)
    if v in (None, ""):
        return None
    try:
        return int(v)
    except ValueError:
        return None


def _env_knobs():
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(("PADDLE_TPU_", "CUDA_", "TORCH_",
                             "PYTORCH_"))}


def _backend_info():
    """The torch device probe (the ``backend`` event's fields): the
    CUDA devices when there are any, else the host."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {"backend": "cpu", "platform": "cpu", "ndev": 1,
                    "device_count": 1, "device_kind": "cpu",
                    "device_kinds": {"cpu": 1}}
        n = torch.cuda.device_count()
        names = [torch.cuda.get_device_name(i) for i in range(n)]
        kinds = {}
        for name in names:
            kinds[name] = kinds.get(name, 0) + 1
        return {"backend": "cuda", "platform": "gpu", "ndev": n,
                "device_count": n, "device_kind": names[0],
                "device_kinds": kinds,
                "devices": [{"id": i, "kind": name, "process": 0}
                            for i, name in enumerate(names)],
                "torch": torch.__version__, "cuda": torch.version.cuda}
    except Exception as e:  # the journal must work without a device
        return {"backend": None, "ndev": None,
                "backend_error": f"{type(e).__name__}: {e}"}


def _summarize_value(v, sync=True):
    """Small, JSON-safe summary of one fetched value: size-1 numerics
    inline as a float (one host read), everything else as shape/dtype
    metadata, so a large device tensor is never copied for logging.
    ``sync=False`` forbids even that read for a tensor off the host (a
    lazy or async fetch must not pay a hidden device->host sync for
    logging); host values stay readable."""
    import numpy as np
    import torch

    if isinstance(v, torch.Tensor):
        readable = sync or v.device.type == "cpu"
        if readable and v.numel() == 1 and not v.is_complex():
            return float(v.detach().reshape(()))
        return {"shape": [int(s) for s in v.shape],
                "dtype": str(v.dtype).replace("torch.", "")}
    shape, dtype = getattr(v, "shape", None), getattr(v, "dtype", None)
    if shape is None or dtype is None:
        if isinstance(v, (bool, int, float)):
            return float(v)
        return {"repr": repr(v)[:80]}
    size = 1
    for s in shape:
        size *= int(s)
    try:
        if size == 1 and np.dtype(dtype).kind in "fiub":
            return float(np.asarray(v).reshape(()))
    except (TypeError, ValueError):
        pass
    return {"shape": [int(s) for s in shape], "dtype": str(dtype)}


class RunJournal:
    """One run's flight recorder. Usable three ways:

    - explicitly: ``j = start_run("/runs/exp7")`` ... ``end_run()``;
    - scoped: ``with RunJournal("/runs/exp7") as j:`` — an exception
      leaving the block writes the postmortem before closing;
    - standalone (not installed): ``RunJournal(d).start()``.

    With ``rank=`` (or env ``PADDLE_TPU_RANK``) the journal writes under
    ``<run_dir>/rank_NN/`` so N workers journaling into one run dir never
    tear each other's lines.
    """

    def __init__(self, run_dir=None, *, rank=None, flush_every=32,
                 flush_interval_s=5.0, max_bytes=64 << 20,
                 postmortem_events=64, detectors=None,
                 anomaly_callback=None, peak=None):
        run_dir = run_dir or os.environ.get("PADDLE_TPU_RUN_DIR")
        if not run_dir:
            raise ValueError(
                "RunJournal needs a run directory: pass run_dir or set "
                "PADDLE_TPU_RUN_DIR")
        self.rank = env_rank() if rank is None else int(rank)
        if self.rank is not None and os.path.basename(
                os.path.normpath(str(run_dir))) != rank_subdir(self.rank):
            run_dir = os.path.join(str(run_dir), rank_subdir(self.rank))
        self.run_dir = str(run_dir)
        self.flush_every = max(1, int(flush_every))
        self.flush_interval_s = float(flush_interval_s)
        self.max_bytes = int(max_bytes)
        # leaf lock: record/event paths are called from under the
        # scheduler/engine locks, so nothing may be acquired while THIS
        # is held (lockdep enforces it)
        self._lock = _lockdep.rlock("obs.journal")
        self._buf = []
        self._file = None
        self._bytes = 0
        self._part = 0
        self._last_flush = time.monotonic()
        self._closed = True
        self._t_start = None
        self._requests = 0
        self._events = 0
        self._step = 0
        self._last_timer_ms = None
        self._last_steps = deque(maxlen=int(postmortem_events))
        self._last_events = deque(maxlen=int(postmortem_events))
        self._postmortem_written = False
        self._backend_written = False
        self.accounting = MFUAccounting(peak=peak)
        if detectors is None:
            try:
                detectors = default_detectors()
            except Exception as e:
                # a typo'd PADDLE_TPU_ANOMALY spec must cost the
                # detectors, not the whole flight recorder
                import warnings

                warnings.warn(
                    f"anomaly detectors disabled — bad PADDLE_TPU_ANOMALY "
                    f"spec? ({type(e).__name__}: {e})", RuntimeWarning)
                detectors = []
        self.anomalies = AnomalyEngine(detectors,
                                       callback=anomaly_callback)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        with self._lock:
            if not self._closed:
                return self
            os.makedirs(self.run_dir, exist_ok=True)
            self._file = open(self._path(), "a", encoding="utf-8")
            self._bytes = self._file.tell()
            # resume-safe rotation: continue numbering after any parts a
            # previous run into this dir already rotated out
            for fn in os.listdir(self.run_dir):
                if fn.startswith("journal.") and fn.endswith(".jsonl") \
                        and fn != JOURNAL_FILE:
                    try:
                        self._part = max(self._part,
                                         int(fn.split(".")[1]))
                    except ValueError:
                        pass
            self._closed = False
            self._t_start = time.monotonic()
            atexit.register(self._atexit)
        rec = {
            "t": "run_start", "ts": time.time(), "pid": os.getpid(),
            "argv": list(sys.argv), "run_dir": self.run_dir,
            "env": _env_knobs()}
        if self.rank is not None:
            rec["rank"] = self.rank
        self._write(rec)
        return self

    def close(self, exc=None):
        """Write the run_end summary and release the file. ``exc`` (an
        exception instance) additionally writes the postmortem first."""
        with self._lock:
            if self._closed:
                return
            if exc is not None:
                self.postmortem(exc)
            elif _trace.tracing_enabled() and not self._postmortem_written:
                # clean close with tracing on: leave the run's Chrome
                # trace next to the journal
                try:
                    _trace.export_chrome_trace(
                        os.path.join(self.run_dir, TRACE_FILE))
                except OSError:
                    pass
            self._write({"t": "run_end", "ts": time.time(),
                         "summary": self.summary()}, _locked=True)
            self._flush_locked()
            self._file.close()
            self._file = None
            self._closed = True
            atexit.unregister(self._atexit)
        global ACTIVE
        if ACTIVE is self:
            ACTIVE = None

    def _atexit(self):
        try:
            self.close()
        except Exception:
            pass

    def _adopt_trace_rank(self):
        """Becoming the process-wide journal with a rank identity also
        adopts that rank for trace exports (one process = one rank)."""
        if self.rank is not None and _trace.current_rank() is None:
            _trace.set_rank(self.rank)

    def __enter__(self):
        """Scoped use installs the journal process-wide for the block —
        the hooks all read ``journal.ACTIVE``."""
        global ACTIVE
        self._prev_active = ACTIVE
        self.start()
        ACTIVE = self
        self._adopt_trace_rank()
        return self

    def __exit__(self, exc_type, exc, tb):
        global ACTIVE
        self.close(exc=exc)
        prev = getattr(self, "_prev_active", None)
        if ACTIVE is None and prev is not None and not prev.closed:
            ACTIVE = prev
        return False

    @property
    def closed(self):
        return self._closed

    # -- write path ----------------------------------------------------------
    def _path(self):
        return os.path.join(self.run_dir, JOURNAL_FILE)

    def _write(self, rec, _locked=False):
        line = json.dumps(rec, default=str)
        if _locked:
            self._buf.append(line)
            self._maybe_flush_locked(len(line))
            return
        with self._lock:
            if self._closed:
                return
            self._buf.append(line)
            self._maybe_flush_locked(len(line))

    def _maybe_flush_locked(self, nbytes):
        self._bytes += nbytes + 1
        now = time.monotonic()
        if len(self._buf) >= self.flush_every or \
                now - self._last_flush >= self.flush_interval_s:
            self._flush_locked()

    def _flush_locked(self):
        if self._buf and self._file is not None:
            self._file.write("\n".join(self._buf) + "\n")
            self._file.flush()
            self._buf.clear()
        self._last_flush = time.monotonic()
        if self._bytes >= self.max_bytes and self._file is not None:
            self._file.close()
            self._part += 1
            os.replace(self._path(), os.path.join(
                self.run_dir, f"journal.{self._part}.jsonl"))
            self._file = open(self._path(), "a", encoding="utf-8")
            self._bytes = 0

    def flush(self):
        with self._lock:
            if not self._closed:
                self._flush_locked()

    # -- recording -----------------------------------------------------------
    def record_request(self, rid, state=None, arrival_t=None,
                       admit_t=None, first_token_t=None, finish_t=None,
                       prompt_tokens=None, output_tokens=None,
                       pages_peak=None, preemptions=0, **extra):
        """Append one per-request serving record: the request's
        lifecycle timestamps in the SERVING clock (the engine's
        injectable clock, so tests are exact), derived TTFT/TPOT/e2e/
        queue latencies in ms, and the KV-page + preemption footprint.
        Per-phase ms fields ride ``extra`` (the engine passes
        ``prefill_ms``/``preempt_ms``/``decode_ms``; with the derived
        ``queue_ms`` they telescope exactly to ``e2e_ms``)."""
        rec = {"t": "request", "rid": rid, "ts": time.time()}
        if state is not None:
            rec["state"] = state
        for k, v in (("arrival_t", arrival_t), ("admit_t", admit_t),
                     ("first_token_t", first_token_t),
                     ("finish_t", finish_t)):
            if v is not None:
                rec[k] = float(v)
        if prompt_tokens is not None:
            rec["prompt_tokens"] = int(prompt_tokens)
        if output_tokens is not None:
            rec["output_tokens"] = int(output_tokens)
        if pages_peak is not None:
            rec["pages_peak"] = int(pages_peak)
        if preemptions:
            rec["preemptions"] = int(preemptions)
        if arrival_t is not None and admit_t is not None:
            rec["queue_ms"] = (admit_t - arrival_t) * 1e3
        if arrival_t is not None and first_token_t is not None:
            rec["ttft_ms"] = (first_token_t - arrival_t) * 1e3
        if arrival_t is not None and finish_t is not None:
            rec["e2e_ms"] = (finish_t - arrival_t) * 1e3
        if first_token_t is not None and finish_t is not None and \
                output_tokens and output_tokens > 1:
            rec["tpot_ms"] = (finish_t - first_token_t) * 1e3 / \
                (output_tokens - 1)
        rec.update(extra)
        with self._lock:
            if self._closed:
                return None
            self._note_backend_locked()
            self._requests += 1
            self._write(rec, _locked=True)
        return rec

    def record_step(self, loss=None, fetches=None, step_ms=None,
                    examples=None, flops=None, skipped=False,
                    nonfinite=False, source=None, comm=None, **extra):
        """Append one per-step record. ``loss`` is a number, a 0-d tensor
        (read to the host here) or None; ``fetches`` a list of values
        (the first four summarized). ``step_ms`` defaults to the last
        ``note_step_ms``. ``comm``, a dict of the step's collective bytes
        (``all_reduce_bytes``, ``total_bytes``, ``wire_bytes``), is kept
        on the record when given."""
        import math

        # host-side value summarization stays OUTSIDE the lock (it may
        # read a scalar off the device); all shared mutation — step
        # counter, accounting, detectors, buffers — happens under ONE
        # lock hold so concurrent steppers can't lose counts
        if loss is not None:
            try:
                loss = float(loss)
            except (TypeError, ValueError):
                loss = None
        if loss is not None and not math.isfinite(loss):
            nonfinite = True
        fetch_summary = extra.pop("_fetch_summary", None)
        if fetch_summary is None and fetches:
            fetch_summary = [_summarize_value(v) for v in fetches[:4]]
        with self._lock:
            if self._closed:
                return None
            self._note_backend_locked()
            self._step += 1
            if step_ms is None:
                step_ms, self._last_timer_ms = self._last_timer_ms, None
            rec = {"t": "step", "step": self._step, "ts": time.time(),
                   "loss": loss, "step_ms": step_ms}
            if fetch_summary:
                rec["fetches"] = fetch_summary
            if examples:
                rec["examples"] = int(examples)
                if step_ms:
                    rec["examples_per_s"] = examples / (step_ms / 1e3)
            if flops:
                rec["flops"] = float(flops)
            if comm:
                rec["comm"] = comm
            if skipped:
                rec["skipped"] = True
            if nonfinite:
                rec["nonfinite"] = True
            if source:
                rec["source"] = source
            rec.update(extra)
            self.accounting.record(
                step_ms=step_ms, flops=flops, examples=examples,
                productive=not (skipped or nonfinite),
                weight=rec.get("steps_fused") or 1)
            self._last_steps.append(rec)
            self._write(rec, _locked=True)
            for fired in self.anomalies.observe(rec):
                self._write({"t": "anomaly", "ts": time.time(), **fired},
                            _locked=True)
        return rec

    def record_plan(self, plan, **fields):
        """One ``plan`` event: ``plan.event_fields()`` (the mesh shape,
        per-axis roles, canonical axes, predicted vs measured collective
        wire bytes and their ``mismatch``) plus ``fields``, the payload
        ``tools/torch_run_report.py`` renders and gates on."""
        return self.event("plan", **plan.event_fields(), **fields)

    def record_memory(self, compiled=None, analysis=None,
                      predicted_bytes=None, per_device_bytes=None,
                      measured_bytes=None, **fields):
        """One ``memory`` event: the predicted peak bytes, the measured
        ones and ``drift``, their relative delta, from the byte fields
        the caller gives. A compiled entry's own prediction needs
        ``analysis/memory.py`` (ROADMAP Queue 1 item 9): ``compiled`` or
        ``analysis`` raise ``NotImplementedError``."""
        if compiled is not None or analysis is not None:
            raise NotImplementedError(
                "record_memory of a compiled entry needs analysis/memory.py,"
                " which is not ported to paddle_tpu_torch yet (ROADMAP "
                "Queue 1 item 9): pass the byte fields")
        drift = None
        ref = per_device_bytes or predicted_bytes
        if ref and measured_bytes:
            drift = abs(ref - measured_bytes) / measured_bytes
        return self.event(
            "memory", predicted_peak_bytes=predicted_bytes,
            per_device_bytes=per_device_bytes,
            measured_peak_bytes=measured_bytes, drift=drift, **fields)

    def record_executor_run(self, compiled, fetches, run_ms, synced=True,
                            source="executor", examples=None):
        """One step record for a static ``Executor.run`` (or, with
        ``source="predictor"``, a ``Predictor.run``): the first four
        fetches summarized once (``synced=False``: no device read), the
        first as the loss when it is a number, ``run_ms`` as the step's
        time, ``examples`` (default: the entry's largest leading feed
        dimension, ``examples_hint``)."""
        summary = [_summarize_value(v, sync=synced)
                   for v in fetches[:4]] if fetches else None
        loss = summary[0] if summary and isinstance(summary[0], float) \
            else None
        if examples is None:
            examples = getattr(compiled, "examples_hint", None)
        return self.record_step(
            loss=loss, step_ms=run_ms, examples=examples, source=source,
            _fetch_summary=summary)

    def record_fused_run(self, compiled, fetches, run_ms, steps,
                         synced=True):
        """One step record for a ``run_steps`` window of K steps, with
        ``steps_fused=K``: the loss is the last microbatch's, the
        examples cover all K."""
        import numpy as np

        steps = int(steps)
        summary = [_summarize_value(v, sync=synced)
                   for v in fetches[:4]] if fetches else None
        loss = None
        if fetches and synced:
            try:  # the stacked (K,) losses -> the last one
                arr = np.asarray(fetches[0])
                if arr.shape == (steps,) and arr.dtype.kind in "fiub":
                    loss = float(arr[-1])
            except (TypeError, ValueError):
                pass
        hint = getattr(compiled, "examples_hint", None)
        return self.record_step(
            loss=loss, step_ms=run_ms,
            examples=hint * steps if hint else None, source="executor",
            steps_fused=steps, _fetch_summary=summary)

    def note_step_ms(self, ms):
        """Step-timer feed: remember the latest timed step so the next
        ``record_step`` without an explicit ``step_ms`` uses it."""
        self._last_timer_ms = float(ms)

    def sync_step(self, global_step):
        """Number the next step record ``global_step``: a trainer's own
        step count, so records line up across ranks and relaunches
        (``obs.fleet.align_steps``)."""
        with self._lock:
            self._step = int(global_step) - 1

    def _note_backend_locked(self):
        if not self._backend_written:
            self._backend_written = True
            self.event("backend", peak_flops_per_s=peak_flops(),
                       **_backend_info())

    def note_backend(self):
        """Write the ``backend`` event now unless it is written already:
        for a process that has touched its device before its first
        request record (a fleet worker after ``warm()``), so a replica
        killed before it finishes a request still journals its card."""
        with self._lock:
            if not self._closed:
                self._note_backend_locked()

    def event(self, kind, **fields):
        """Append one discrete event record (compile, preemption,
        resilience retry, chaos activation, ...)."""
        with self._lock:
            if self._closed:
                return None
            if kind.startswith("resilience.retry"):
                self.accounting.note_retry()
            rec = {"t": "event", "kind": kind, "ts": time.time(),
                   "step": self._step, **fields}
            self._events += 1
            self._last_events.append(rec)
            self._write(rec, _locked=True)
        return rec

    # -- summaries -----------------------------------------------------------
    def summary(self):
        out = self.accounting.summary()
        out["steps"] = self._step
        out["optimizer_steps"] = (self.accounting.productive
                                  + self.accounting.skipped)
        out["requests"] = self._requests
        out["events"] = self._events
        if self._t_start is not None:
            wall = time.monotonic() - self._t_start
            out["wall_s"] = wall
            if wall > 0 and self._step:
                out["steps_per_s"] = self._step / wall
        out["anomalies_fired"] = len(self.anomalies.fired)
        return out

    def postmortem(self, exc=None, note=None):
        """Dump ``postmortem.json``: the summary, recent events, the
        exception (if any), a metrics snapshot, and — when span tracing
        is on — a Chrome trace next to it."""
        with self._lock:
            dump = {
                "ts": time.time(), "run_dir": self.run_dir,
                "note": note, "summary": self.summary(),
                "last_steps": list(self._last_steps),
                "last_events": list(self._last_events),
                "anomalies": list(self.anomalies.fired),
                "metrics": _metrics.snapshot(),
            }
            if exc is not None:
                import traceback

                dump["exception"] = {
                    "type": type(exc).__name__, "message": str(exc),
                    "traceback": traceback.format_exception(
                        type(exc), exc, exc.__traceback__),
                }
            path = os.path.join(self.run_dir, POSTMORTEM_FILE)
            os.makedirs(self.run_dir, exist_ok=True)
            if _trace.tracing_enabled():
                try:
                    trace_path = os.path.join(self.run_dir, TRACE_FILE)
                    _trace.export_chrome_trace(trace_path)
                    dump["trace_file"] = trace_path
                except OSError:
                    pass
            with open(path, "w", encoding="utf-8") as f:
                json.dump(dump, f, default=str, indent=1)
            self._postmortem_written = True
            if not self._closed:
                self.event("postmortem", path=path,
                           error=(f"{type(exc).__name__}: {exc}"
                                  if exc is not None else note))
                self._flush_locked()
        return path


def start_run(run_dir=None, **kw):
    """Create, start, and install the process-wide journal (replacing
    any previous one after closing it). ``run_dir`` defaults to env
    ``PADDLE_TPU_RUN_DIR``."""
    global ACTIVE
    if ACTIVE is not None:
        ACTIVE.close()
    j = RunJournal(run_dir, **kw).start()
    ACTIVE = j
    j._adopt_trace_rank()
    return j


def end_run(exc=None):
    """Close and uninstall the process-wide journal (no-op without
    one). Returns the final summary dict, or None."""
    global ACTIVE
    j, ACTIVE = ACTIVE, None
    if j is None:
        return None
    out = j.summary()
    j.close(exc=exc)
    return out
