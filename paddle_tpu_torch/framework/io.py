"""Serialization: ``save``/``load`` and crash-safe training checkpoints.

The port of ``paddle_tpu/framework/io.py``'s ``save``/``load`` (:67-86)
and its checkpoint half (:235-735), with the JAX package's on-disk
format, so a checkpoint crosses between the two packages: pickled dicts
of numpy arrays (protocol 4) in ``model.pdparams``, ``opt.pdopt`` and
``meta.pkl``, and a ``manifest.json`` (``format: 1``) holding each
file's size and crc32 and each array's crc32, shape and dtype. Equal
arrays give equal crc32s in either package.

bfloat16: numpy has no bfloat16 of its own; the JAX package's arrays
are ``ml_dtypes.bfloat16``, whose pickle names that module. This package
never imports ``ml_dtypes``. Its writer emits a bfloat16 tensor's bits
as exactly the pickle numpy makes of an ``ml_dtypes`` array (so the JAX
package loads it as bfloat16), and its reader maps the ``ml_dtypes``
name to a stand-in that turns such an array into a bfloat16 CPU tensor.
``load`` therefore returns numpy arrays, and bfloat16 tensors where the
file holds bfloat16.

Checkpoints (``save_checkpoint``/``load_checkpoint``):

- atomic publish: the files go to ``.tmp_ckpt_<step>`` and are renamed to
  ``ckpt_<step>`` once complete; ``keep_last`` rotation ignores garbage
  names;
- ``async_=True``: the state is copied to the host on the calling thread
  (into pinned buffers; every device-to-host copy has finished when the
  call returns, so the next step may overwrite the storage), and the
  pickling, crc and
  publish run on one writer thread; at most one save is in flight, and
  every save first waits for the previous one and re-raises its failure
  once (``wait_checkpoints``);
- ``load_checkpoint`` verifies against the manifest and falls back to the
  newest intact checkpoint, cleans ``.tmp_ckpt_*`` orphans older than a
  60 s grace and warns on garbage names; ``verify_checkpoint`` adds the
  per-array pass that names the array at fault;
- the model's values are written into its parameters and buffers with
  ``copy_`` (``set_state_dict``), the optimizer's into its state
  (``Optimizer.set_state_dict``), so a captured ``TrainStep`` replays on
  after a load without a new capture;
- the ``ckpt_slow``/``ckpt_crash`` chaos points fire before the publish,
  ``ckpt_truncate``/``ckpt_bitflip`` after it; metrics
  ``checkpoint.*``, spans ``checkpoint.save``/``snapshot``/``load`` and
  journal events ``checkpoint.save``/``save_failed``/``load``/
  ``fallback`` as the reference's.

Not ported: the program-level functions (``save_inference_model``,
``load_inference_model``, ``save_vars``/``load_vars`` and the rest),
which wait for ``static_`` (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import binascii
import json
import os
import pickle
import shutil
import threading
import time
import warnings

import numpy as np
import torch

from ..obs import journal as _journal
from ..obs import lockdep as _lockdep
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..resilience import inject as _chaos

_M_SAVE_MS = _metrics.histogram("checkpoint.save_ms")
_M_SNAPSHOT_MS = _metrics.histogram("checkpoint.snapshot_ms")
_M_LOAD_MS = _metrics.histogram("checkpoint.load_ms")
_M_VERIFY_MS = _metrics.histogram("checkpoint.verify_ms")
_M_SAVES = _metrics.counter("checkpoint.saves")
_M_SAVE_FAILURES = _metrics.counter("checkpoint.save_failures")
_M_LOADS = _metrics.counter("checkpoint.loads")
_M_FALLBACKS = _metrics.counter("checkpoint.fallbacks")

__all__ = [
    "save", "load", "set_state_dict", "save_checkpoint", "load_checkpoint",
    "verify_checkpoint", "AsyncCheckpoint", "wait_checkpoints",
    "CheckpointError",
]


# -- the pickle format: numpy's, with ml_dtypes' bfloat16 by name -----------

# numpy's array and scalar reconstructors, under the module names this
# numpy pickles them with
_RECONSTRUCT = np.zeros(0).__reduce__()[0]
_SCALAR = np.float32(0).__reduce__()[0]
# np.dtype(ml_dtypes.bfloat16).__reduce__()'s state: little-endian,
# 2 bytes, aligned to 2, flags 64 (NPY_USE_SETITEM)
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _MLDtypesBFloat16:
    """Stands for the class ``ml_dtypes.bfloat16`` in a pickle: written
    under that name, read back from it."""


class _BFloat16Dtype:
    """``numpy.dtype(ml_dtypes.bfloat16)``: what the writer pickles as
    that dtype, and what the reader makes of it."""

    def __setstate__(self, state):
        pass


_BF16_DTYPE = _BFloat16Dtype()


class _BFloat16Bits:
    """A bfloat16 tensor's bits on the host (a C-contiguous uint16
    array), pickled as numpy pickles an ``ml_dtypes.bfloat16`` array."""

    __slots__ = ("bits",)

    def __init__(self, bits):
        self.bits = bits


class _Pickler(pickle._Pickler):
    """The pure-Python pickler (its ``save_global`` can be overridden),
    writing ``_BFloat16Bits`` as an ``ml_dtypes.bfloat16`` array."""

    def reducer_override(self, obj):
        if isinstance(obj, _BFloat16Bits):
            b = obj.bits
            # a new (0,) each time, as numpy's reduce makes (a constant
            # tuple would be memoized and shorten the pickle)
            return (_RECONSTRUCT, (np.ndarray, tuple([0]), b"b"),
                    (1, b.shape, _BF16_DTYPE, False, b.tobytes()))
        if obj is _BF16_DTYPE:
            return (np.dtype, (_MLDtypesBFloat16, False, True),
                    _BF16_DTYPE_STATE)
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is not _MLDtypesBFloat16:
            return super().save_global(obj, name)
        self.save("ml_dtypes")
        self.save("bfloat16")
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _ArrayState:
    """What numpy's ``_reconstruct`` makes while unpickling, until BUILD
    hands it the array's state: then ``value`` is the array, or a
    bfloat16 tensor when the dtype is ``ml_dtypes.bfloat16``."""

    __slots__ = ("args", "value")

    def __init__(self, *args):
        self.args = args

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if isinstance(dtype, _BFloat16Dtype):
            bits = np.frombuffer(bytearray(raw), np.int16).reshape(
                shape, order="F" if fortran else "C")
            self.value = torch.from_numpy(
                np.ascontiguousarray(bits)).view(torch.bfloat16)
        else:
            self.value = _RECONSTRUCT(*self.args)
            self.value.__setstate__(state)


def _dtype(obj, align=False, copy=False):
    if obj is _MLDtypesBFloat16:
        return _BF16_DTYPE
    return np.dtype(obj, align, copy)


def _scalar(dtype, raw):
    if isinstance(dtype, _BFloat16Dtype):
        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)[0]
    return _SCALAR(dtype, raw)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _MLDtypesBFloat16
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        if module in ("numpy.core.multiarray", "numpy._core.multiarray"):
            if name == "_reconstruct":
                return _ArrayState
            if name == "scalar":
                return _scalar
        return super().find_class(module, name)


def _resolve(obj):
    """The unpickled tree with each ``_ArrayState`` replaced by its
    value."""
    if isinstance(obj, _ArrayState):
        return obj.value
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_resolve(v) for v in obj)
    return obj


def _read_pickle(f):
    return _resolve(_Unpickler(f).load())


def _host_tree(obj, copy=False):
    """A state tree with every tensor on the host as numpy (a bfloat16
    one as ``_BFloat16Bits``). A CUDA tensor is copied into a pinned host
    buffer, all of them queued without a wait and then waited for: when
    this returns, every copy has finished. (Pinned blocks go back to
    PyTorch's caching host allocator when the tree dies, so the next
    save's copies reuse them at the host link's rate; fresh pageable
    buffers are page-faulted in at a fraction of it.) With ``copy``,
    host tensors and arrays are copied too, so that the tree owns its
    bytes outright (an async writer serializes it while the step loop
    goes on writing the live storage)."""
    devices = set()

    def walk(o):
        if isinstance(o, torch.Tensor):
            t = o.detach()
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                devices.add(t.device)
            else:
                h = t.clone() if copy else t.contiguous()
            if h.dtype == torch.bfloat16:
                return _BFloat16Bits(h.view(torch.int16).numpy().view(
                    np.uint16))
            return h.numpy()
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(walk(v) for v in o)
        if isinstance(o, np.ndarray):
            return o.copy() if copy else o
        return o

    out = walk(obj)
    for d in devices:
        torch.cuda.synchronize(d)
    return out


def save(obj, path, protocol=4):
    """ref: paddle.save — state dicts and nested containers of tensors
    (any device) and arrays, as pickled numpy."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_host_tree(obj))


def load(path, return_numpy=False):
    """ref: paddle.load. Arrays come back as numpy, bfloat16 ones as CPU
    tensors; ``return_numpy`` is Paddle's argument and changes nothing,
    as in the reference."""
    with open(path, "rb") as f:
        return _read_pickle(f)


def _as_tensor(v):
    if isinstance(v, np.ndarray) and v.dtype.name == "bfloat16":
        v = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
    return torch.as_tensor(v)


@torch.no_grad()
def set_state_dict(model, state_dict):
    """Write ``state_dict`` (names to tensors, arrays or numbers) into
    ``model``'s parameters and persistent buffers, each with ``copy_``
    into its storage (cast to its type, moved to its device). As the
    reference's ``Layer.set_state_dict`` (``nn/layer.py:305-325``): a
    shape mismatch raises ``ValueError``; returns ``(missing,
    unexpected)`` names."""
    own = model.state_dict()
    missing, unexpected = [], []
    for name, value in state_dict.items():
        if name not in own:
            unexpected.append(name)
            continue
        v = _as_tensor(value)
        if tuple(v.shape) != tuple(own[name].shape):
            raise ValueError(
                f"shape mismatch for {name}: loaded {tuple(v.shape)} vs "
                f"expected {tuple(own[name].shape)}")
        own[name].copy_(v)
    for name in own:
        if name not in state_dict:
            missing.append(name)
    return missing, unexpected


# -- training checkpoints ----------------------------------------------------


class CheckpointError(RuntimeError):
    """A checkpoint exists but cannot be trusted (truncated, bit-flipped,
    unreadable, or missing files the manifest promises)."""


def _ckpt_step(dirname):
    """int step from a ckpt_* dir name, or None for garbage (a stray
    'ckpt_latest' symlink, 'ckpt_12.bak', editor droppings...)."""
    tail = dirname[len("ckpt_"):]
    return int(tail) if tail.isdigit() else None


def _leaf(obj):
    """``(C-contiguous array, dtype name)`` of an array leaf, or None: a
    bfloat16 one (written or read) as its uint16 bits, named
    ``bfloat16`` as the JAX package's manifest names it."""
    if isinstance(obj, _BFloat16Bits):
        return obj.bits, "bfloat16"
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        a = np.asarray(obj)
        if not a.flags.c_contiguous:    # (ascontiguousarray makes 0-d 1-d)
            a = np.ascontiguousarray(a)
        return a, str(a.dtype)
    return None


def _array_checksums(state):
    """{path: {crc32, shape, dtype}} for every array leaf of a (possibly
    nested) state dict — the per-array integrity record in the manifest."""
    out = {}

    def walk(obj, path):
        if isinstance(obj, dict):
            for k in obj:
                walk(obj[k], f"{path}/{k}" if path else str(k))
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}[{i}]")
        else:
            leaf = _leaf(obj)
            if leaf is not None:
                a, dtype = leaf
                # crc32 reads the array's buffer directly: no tobytes()
                out[path] = {"crc32": binascii.crc32(a) & 0xFFFFFFFF,
                             "shape": list(a.shape), "dtype": dtype}

    walk(state, "")
    return out


class _CrcWriter:
    """File-like sink that crc32s what passes through — lets pickle
    STREAM to disk (no whole-checkpoint blob in host RAM) while still
    digesting the exact bytes written."""

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.size = 0

    def write(self, b):
        self._f.write(b)
        self.crc = binascii.crc32(b, self.crc)
        self.size += len(b)
        return len(b)


def _dump_with_digest(obj, path):
    """Stream-pickle an already host-converted tree to ``path``; return
    the manifest file entry. The crc is computed on the exact bytes
    written, so any later truncation/bit-flip of the file is
    detectable."""
    with open(path, "wb") as f:
        w = _CrcWriter(f)
        _Pickler(w, protocol=4).dump(obj)
    return {"size": w.size, "crc32": w.crc & 0xFFFFFFFF}


class AsyncCheckpoint:
    """Handle for one in-flight ``save_checkpoint(..., async_=True)``.

    The step-path cost (host copy of every tensor) was already paid
    when the handle was returned; the pickle+crc write, manifest, and
    atomic publish run on a background writer thread. ``done()`` polls;
    ``result()`` joins, re-raises any writer failure, and returns the
    published path. A writer that dies mid-save never published
    anything — only a ``.tmp_ckpt_*`` orphan remains, so
    ``load_checkpoint``'s newest-intact fallback stays sound."""

    __slots__ = ("directory", "step", "path", "error", "_done", "_thread")

    def __init__(self, directory, step):
        self.directory = str(directory)
        self.step = int(step)
        self.path = None
        self.error = None
        self._done = threading.Event()
        self._thread = None

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"checkpoint step {self.step} still writing after "
                f"{timeout}s")
        # this save is settled: release the module barrier slot so an
        # already-observed failure is raised once, not at every
        # subsequent save
        global _ASYNC_PENDING
        with _ASYNC_LOCK:
            if _ASYNC_PENDING is self:
                _ASYNC_PENDING = None
        if self.error is not None:
            raise self.error
        return self.path


# held only around _ASYNC_PENDING handoff — wait_checkpoints() blocks
# on handle.result() strictly AFTER releasing (lockdep-checked)
_ASYNC_LOCK = _lockdep.lock("checkpoint.async_barrier")
_ASYNC_PENDING = None  # at most ONE async save is ever in flight


def wait_checkpoints(timeout=None):
    """Barrier on the in-flight async checkpoint save: returns its
    published path (or None when nothing is pending) and re-raises a
    writer failure. Call before a clean exit — e.g. the graceful-
    preemption path — so the last snapshot is durable."""
    with _ASYNC_LOCK:
        handle = _ASYNC_PENDING
    if handle is None:
        return None
    return handle.result(timeout)


def _snapshot_checkpoint(step, model, optimizer, scheduler, extra, copy):
    """Host-side materialization of everything the writer needs. This is
    the ONLY part of a save that reads live model state — it runs on the
    caller's thread, so by the time an async writer starts, the step
    loop may overwrite the storage freely."""
    state = {"step": int(step), "extra": extra or {}}
    snap = {"model": None, "opt": None}
    if model is not None:
        snap["model"] = _host_tree(dict(model.state_dict()), copy)
    if optimizer is not None:
        snap["opt"] = _host_tree(optimizer.state_dict(), copy)
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    snap["state"] = _host_tree(state, copy)
    return snap


def save_checkpoint(directory, step, model=None, optimizer=None,
                    scheduler=None, keep_last=3, extra=None, async_=False):
    """Atomic checkpoint with keep-last-k rotation, resume metadata, and
    an integrity manifest (per-file and per-array crc32) that
    ``load_checkpoint`` verifies before trusting the data. Returns the
    published path, or with ``async_=True`` an :class:`AsyncCheckpoint`
    handle.

    ``async_=True`` keeps the serialized write off the step loop: the
    state is copied to host arrays on the calling thread (the only
    step-path cost; every device-to-host copy has finished when the call
    returns), and the pickle+crc write, manifest, and atomic publish
    happen on a background writer thread, which touches host arrays
    only. Exactly one save is in flight at a time — any save (sync or
    async) first barriers on the previous in-flight one and re-raises
    its failure (once). The ``ckpt_<step>`` dir only appears when the
    writer COMPLETED, so a writer that dies mid-save leaves nothing the
    newest-intact fallback could mistake for a checkpoint."""
    # barrier: the previous writer owns the directory (rotation!) until
    # it finishes; its failure must surface, not vanish
    wait_checkpoints()
    t0 = time.perf_counter()
    if not async_:
        with _trace.span("checkpoint.save", step=int(step)):
            snap = _snapshot_checkpoint(step, model, optimizer, scheduler,
                                        extra, copy=False)
            out = _write_checkpoint(directory, step, snap, keep_last)
        # a save that died (e.g. injected ckpt_crash) published nothing:
        # checkpoint.saves counts only durable checkpoints
        save_ms = (time.perf_counter() - t0) * 1e3
        _M_SAVE_MS.observe(save_ms)
        _M_SAVES.inc()
        if _journal.ACTIVE is not None:
            _journal.ACTIVE.event("checkpoint.save", step=int(step),
                                  ms=save_ms, dir=str(directory))
        return out

    with _trace.span("checkpoint.snapshot", step=int(step)):
        snap = _snapshot_checkpoint(step, model, optimizer, scheduler,
                                    extra, copy=True)
    _M_SNAPSHOT_MS.observe((time.perf_counter() - t0) * 1e3)
    handle = AsyncCheckpoint(directory, step)

    def _writer():
        try:
            with _trace.span("checkpoint.save", step=int(step), async_=1):
                handle.path = _write_checkpoint(directory, step, snap,
                                                keep_last)
            save_ms = (time.perf_counter() - t0) * 1e3
            _M_SAVE_MS.observe(save_ms)
            _M_SAVES.inc()  # published: NOW it counts
            if _journal.ACTIVE is not None:
                _journal.ACTIVE.event("checkpoint.save", step=int(step),
                                      ms=save_ms, dir=str(directory),
                                      async_=True)
        except BaseException as e:  # surfaced by the next barrier
            handle.error = e
            _M_SAVE_FAILURES.inc()
            if _journal.ACTIVE is not None:
                _journal.ACTIVE.event(
                    "checkpoint.save_failed", step=int(step),
                    dir=str(directory),
                    error=f"{type(e).__name__}: {e}")
        finally:
            handle._done.set()

    # non-daemon: a CLEAN interpreter exit joins the writer (free
    # durability); a crash/SIGKILL still orphans only the tmp dir
    t = threading.Thread(target=_writer, name=f"ckpt-writer-{step}",
                         daemon=False)
    handle._thread = t
    global _ASYNC_PENDING
    with _ASYNC_LOCK:
        _ASYNC_PENDING = handle
    t.start()
    return handle


def _write_checkpoint(directory, step, snap, keep_last):
    """Serialize an already-snapshotted state tree to
    ``.tmp_ckpt_<step>`` and atomically publish it as ``ckpt_<step>``.
    Runs on the caller thread (sync save) or the writer thread (async
    save); touches only the snapshot, never live model state."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_ckpt_{step}")
    final = os.path.join(directory, f"ckpt_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"format": 1, "step": int(step), "files": {}, "arrays": {}}
    if snap["model"] is not None:
        manifest["files"]["model.pdparams"] = _dump_with_digest(
            snap["model"], os.path.join(tmp, "model.pdparams"))
        manifest["arrays"]["model.pdparams"] = _array_checksums(
            snap["model"])
    if snap["opt"] is not None:
        manifest["files"]["opt.pdopt"] = _dump_with_digest(
            snap["opt"], os.path.join(tmp, "opt.pdopt"))
        manifest["arrays"]["opt.pdopt"] = _array_checksums(snap["opt"])
    manifest["files"]["meta.pkl"] = _dump_with_digest(
        snap["state"], os.path.join(tmp, "meta.pkl"))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    if _chaos.ACTIVE:
        _chaos.fire("ckpt_slow", tmp)  # stall window: a writer killed
        # here leaves only the tmp orphan — publish never ran
        _chaos.fire("ckpt_crash", tmp)  # simulated death: tmp orphaned
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish: readers never see partial state
    if _chaos.ACTIVE:  # post-publish media corruption
        _chaos.fire("ckpt_truncate", final)
        _chaos.fire("ckpt_bitflip", final)
    # rotate (ignoring garbage dirs a crashed/foreign writer left behind)
    ckpts = _checkpoints(directory)
    for _, old in ckpts[:-keep_last]:
        shutil.rmtree(os.path.join(directory, old))
    return final


def _read_verified(path, name, entry):
    """Read + verify one checkpoint file against its manifest entry;
    returns the unpickled object or raises CheckpointError."""
    fpath = os.path.join(path, name)
    if not os.path.exists(fpath):
        raise CheckpointError(f"{path}: manifest lists {name} but the "
                              "file is missing")
    if entry is not None:
        # chunked digest pass: O(chunk) host memory even for huge files
        crc, size = 0, 0
        with open(fpath, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                crc = binascii.crc32(chunk, crc)
                size += len(chunk)
        if size != entry["size"]:
            raise CheckpointError(
                f"{fpath}: size {size} != manifest {entry['size']} "
                "(truncated write?)")
        if (crc & 0xFFFFFFFF) != entry["crc32"]:
            raise CheckpointError(f"{fpath}: crc32 mismatch (corrupt)")
    try:
        with open(fpath, "rb") as f:
            return _read_pickle(f)
    except Exception as e:
        raise CheckpointError(f"{fpath}: unreadable ({e})") from e


def _load_and_verify(path, deep=False):
    """Load every file of one checkpoint dir, verifying against the
    manifest when present (legacy manifest-less checkpoints are accepted
    if their pickles parse). Returns {filename: object}. ``deep``
    additionally re-verifies every per-array crc32 — the file-level crc
    over the same bytes already subsumes that on the normal load path,
    so the deep pass is for ``verify_checkpoint`` audits, where it
    pins down WHICH array diverged (and catches a file whose file-level
    digest was regenerated around an array-level edit)."""
    mpath = os.path.join(path, "manifest.json")
    manifest = None
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except Exception as e:
            raise CheckpointError(
                f"{mpath}: unreadable manifest ({e})") from e
        # a bit-flipped manifest can stay valid JSON with a broken
        # shape; that must read as "corrupt checkpoint" (fallback), not
        # KeyError (abort)
        if not isinstance(manifest, dict) or \
                not isinstance(manifest.get("files"), dict) or not all(
                    isinstance(e, dict) and "size" in e and "crc32" in e
                    for e in manifest["files"].values()):
            raise CheckpointError(
                f"{mpath}: malformed manifest structure (corrupt)")
    out = {}
    names = list(manifest["files"]) if manifest else \
        [n for n in ("meta.pkl", "model.pdparams", "opt.pdopt")
         if os.path.exists(os.path.join(path, n))]
    if "meta.pkl" not in names:
        raise CheckpointError(f"{path}: no meta.pkl")
    for name in names:
        entry = manifest["files"][name] if manifest else None
        obj = _read_verified(path, name, entry)
        if deep and manifest and name in manifest.get("arrays", {}):
            got = _array_checksums(obj)
            want = manifest["arrays"][name]
            if got != want:
                bad = sorted(set(want) ^ set(got)) or sorted(
                    k for k in want if got.get(k) != want[k])
                raise CheckpointError(
                    f"{path}/{name}: per-array checksum mismatch "
                    f"({bad[:4]})")
        out[name] = obj
    return out


def verify_checkpoint(path):
    """(ok, problems): integrity audit of one checkpoint dir without
    applying it to any model — includes the deep per-array checksum
    pass, so a mismatch names the specific corrupt array."""
    t0 = time.perf_counter()
    try:
        _load_and_verify(path, deep=True)
        return True, []
    except CheckpointError as e:
        return False, [str(e)]
    finally:
        _M_VERIFY_MS.observe((time.perf_counter() - t0) * 1e3)


def _tmp_age(path):
    """Seconds since the newest mtime under a tmp artifact (a LIVE
    save_checkpoint is actively writing, so its newest file is fresh)."""
    newest = os.path.getmtime(path)
    if os.path.isdir(path):
        for f in os.listdir(path):
            try:
                newest = max(newest, os.path.getmtime(
                    os.path.join(path, f)))
            except OSError:
                pass
    return time.time() - newest


def _clean_orphan_tmp(directory, grace_secs=60.0):
    """Remove ``.tmp_ckpt_*`` dirs (and stray ``*.tmp`` files) a crashed
    ``save_checkpoint`` left behind — they hold partial state and would
    otherwise accumulate forever. Artifacts younger than ``grace_secs``
    are left alone: they may belong to a CONCURRENT saver in another
    process, and tmp dirs never match the ``ckpt_*`` load pattern, so
    deferring their cleanup to a later load costs nothing."""
    for d in os.listdir(directory):
        if d.startswith(".tmp_ckpt_") or d.endswith(".tmp"):
            p = os.path.join(directory, d)
            try:
                if _tmp_age(p) < grace_secs:
                    continue
            except OSError:
                continue  # vanished: the concurrent saver published it
            warnings.warn(
                f"removing orphaned checkpoint artifact {p} (crashed "
                "save_checkpoint)", RuntimeWarning)
            if os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)
            else:
                try:
                    os.remove(p)
                except OSError:
                    pass


def load_checkpoint(directory, model=None, optimizer=None, scheduler=None,
                    step=None):
    """Load the newest *intact* checkpoint (or the given ``step``) into
    ``model`` (``set_state_dict``), ``optimizer`` and ``scheduler``;
    returns the resume step or None when the directory holds none.

    Robustness contract (chaos-tested): orphaned ``.tmp_ckpt_*`` dirs
    from crashed saves are cleaned up; garbage ``ckpt_*`` names are
    ignored with a warning; a corrupt/truncated newest checkpoint makes
    the loader fall back to the next-newest intact one. Only when every
    checkpoint fails verification — or an explicitly requested ``step``
    does — is ``CheckpointError`` raised.
    """
    t0 = time.perf_counter()
    with _trace.span("checkpoint.load"):
        out = _load_checkpoint(directory, model, optimizer, scheduler, step)
    if out is not None:  # an empty/missing directory loaded nothing:
        # checkpoint.loads counts only actual resumes (mirroring saves)
        load_ms = (time.perf_counter() - t0) * 1e3
        _M_LOAD_MS.observe(load_ms)
        _M_LOADS.inc()
        if _journal.ACTIVE is not None:
            _journal.ACTIVE.event("checkpoint.load", step=int(out),
                                  ms=load_ms, dir=str(directory))
    return out


def _checkpoints(directory, warn=False):
    """``(step, dirname)`` of every ``ckpt_<step>`` dir in ``directory``,
    oldest first; other ``ckpt_*`` names are skipped (with a warning
    when ``warn``)."""
    entries = []
    for d in os.listdir(directory):
        if not d.startswith("ckpt_"):
            continue
        s = _ckpt_step(d)
        if s is None:
            if warn:
                warnings.warn(
                    f"ignoring non-checkpoint entry {d!r} in {directory}",
                    RuntimeWarning)
            continue
        entries.append((s, d))
    return sorted(entries)


def newest_intact_step(directory):
    """Step of the newest checkpoint that ``load_checkpoint`` accepts
    (the same file-level checks), or None: the step it resumes from. The
    deep per-array pass of ``verify_checkpoint`` is not applied, as the
    load does not apply it."""
    if not directory or not os.path.isdir(directory):
        return None
    for s, d in reversed(_checkpoints(directory)):
        try:
            _load_and_verify(os.path.join(directory, d))
            return s
        except CheckpointError:
            continue
    return None


def _load_checkpoint(directory, model, optimizer, scheduler, step):
    if not os.path.isdir(directory):
        return None
    with _ASYNC_LOCK:
        pending = _ASYNC_PENDING
    if pending is None or pending.done():
        # never sweep while OUR writer thread is mid-save: its live
        # .tmp_ckpt_* is not an orphan (cross-process savers are
        # already covered by the mtime grace period)
        _clean_orphan_tmp(directory)
    entries = _checkpoints(directory, warn=True)
    if not entries:
        return None
    if step is not None:
        match = [d for s, d in entries if s == int(step)]
        if not match:
            raise CheckpointError(
                f"no checkpoint for step {step} in {directory} "
                f"(have steps {[s for s, _ in entries]})")
        payload = _load_and_verify(os.path.join(directory, match[0]))
    else:
        payload, failures = None, []
        for s, d in reversed(entries):
            try:
                payload = _load_and_verify(os.path.join(directory, d))
                break
            except CheckpointError as e:
                failures.append(str(e))
                _M_FALLBACKS.inc()
                if _journal.ACTIVE is not None:
                    _journal.ACTIVE.event("checkpoint.fallback",
                                          ckpt=d, error=str(e))
                warnings.warn(
                    f"checkpoint {d} failed verification ({e}); falling "
                    "back to the next-newest", RuntimeWarning)
        if payload is None:
            raise CheckpointError(
                f"every checkpoint in {directory} is corrupt:\n  " +
                "\n  ".join(failures))
    meta = payload["meta.pkl"]
    if model is not None:
        if "model.pdparams" not in payload:
            raise CheckpointError(
                f"checkpoint step {meta['step']} has no model state")
        set_state_dict(model, payload["model.pdparams"])
    if optimizer is not None and "opt.pdopt" in payload:
        optimizer.set_state_dict(payload["opt.pdopt"])
    if scheduler is not None and "scheduler" in meta:
        scheduler.set_state_dict(meta["scheduler"])
    return meta["step"]
