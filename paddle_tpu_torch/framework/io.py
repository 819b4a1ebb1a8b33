"""Serialization: ``save``/``load``, crash-safe training checkpoints,
inference bundles and the program-level variable I/O.

The port of ``paddle_tpu/framework/io.py``: ``save``/``load`` (:67-86),
its checkpoint half (:235-735), its inference bundles (:88-232) and
its var-level functions (:739-965), all in the JAX package's on-disk
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

Inference bundles (``save_inference_model``/``load_inference_model``):
``<prefix>.pdmodel`` is a pickle of plain Python (op types, variable
names, attributes, shapes, numpy dtype names) and
``<prefix>.pdiparams.npz`` holds the weights, so a bundle saved by
either package loads in the other; ops are rebuilt from the registry
(``ops._base``) by type. ``save_vars``/``load_vars`` and the rest write
and read one ``.npz`` of a program's variables; a load writes into the
tensors already in the scope where their shapes fit.

Not ported: ``aot_warm`` (the AOT executable cache, ROADMAP Queue 1 item
8) and ``batch`` (``reader.py``, item 10).
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

from ..core.tensor import plain
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
    "CheckpointError", "save_inference_model", "load_inference_model",
    "save_vars", "load_vars", "save_params", "load_params",
    "save_persistables", "load_persistables", "get_program_parameter",
    "get_program_persistable_vars", "persistable_footprint",
    "load_program_state", "set_program_state",
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
            t = torch.Tensor.detach(plain(o))
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
    return plain(v) if isinstance(v, torch.Tensor) else torch.as_tensor(v)


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


# -- inference bundles (ref: fluid.io save/load_inference_model) -------------


def _registry():
    """``ops._base.OP_REGISTRY`` with every module that registers an op
    imported, so a bundle's op types resolve by name."""
    from ..nn import functional  # noqa: F401  (linear, conv2d, ...)
    from ..ops import misc  # noqa: F401  (dequantize_weight)
    from ..ops._base import OP_REGISTRY

    return OP_REGISTRY


def _dtype_name(dtype):
    """A torch dtype's numpy name (``"float32"``), as a bundle stores it."""
    return str(dtype).replace("torch.", "")


def _numpy(t):
    """A scope value as a numpy array on the host."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if t.dtype == torch.bfloat16:
        raise ValueError("a bfloat16 value cannot go into an .npz archive "
                         "without ml_dtypes, which this package does not "
                         "import")
    return t.detach().cpu().numpy()


def _plain(v):
    """True for an attribute a bundle can hold: plain Python values in
    tuples, lists and string-keyed dicts."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return True
    if isinstance(v, (list, tuple)):
        return all(_plain(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _plain(x) for k, x in v.items())
    return False


def _forward_slice(program, feed_names, fetch_names):
    """Ops needed to compute fetches from feeds, excluding grad/opt ops
    (ref: prune() in framework.py)."""
    needed = set(fetch_names)
    ops = []
    for op in reversed(program.global_block.ops):
        if op.type.endswith("@grad") or op.type.startswith("optimize_") or \
                op.type in ("fill_ones_like", "fill_zeros_like",
                            "grad_accumulate", "grad_clip"):
            continue
        if any(o in needed for o in op.output_names):
            ops.append(op)
            needed.update(n for n in op.input_names if n is not None)
    return list(reversed(ops)), needed


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, main_program=None, aot_warm=None,
                         **kwargs):
    """ref: fluid.io.save_inference_model. Writes ``<prefix>.pdmodel`` and
    ``<prefix>.pdiparams.npz`` in the JAX package's format: the pdmodel
    is a pickle of plain Python only (feed and fetch names, each op as
    ``(type, input names, output names, attrs)``, each variable's shape
    and numpy dtype name), the npz holds ``w!<name>`` for each
    persistable and ``c!<name>`` for each constant the fetches need.
    ``main_program`` is the fluid-era spelling of ``program``.

    Only ops of the registry (``ops._base``) can be saved: a loader
    rebuilds each op from its type. An op the recorder took as a torch
    call (``_TorchCall``), or one whose attributes are not plain values,
    raises ``ValueError`` naming it. ``aot_warm`` as a directory raises:
    the AOT executable cache is not ported (ROADMAP Queue 1 item 8);
    ``None``/``False`` warm nothing, as in the JAX package with no cache
    active."""
    from ..static_.program import default_main_program, global_scope

    if isinstance(aot_warm, (str, bytes, os.PathLike)):
        raise NotImplementedError(
            "save_inference_model(aot_warm=<dir>): the AOT executable "
            "cache is not ported to paddle_tpu_torch yet (ROADMAP Queue 1 "
            "item 8)")
    registry = _registry()
    program = program or main_program or default_main_program()
    feed_names = [v if isinstance(v, str) else v.name for v in feed_vars]
    fetch_names = [v if isinstance(v, str) else v.name for v in fetch_vars]
    ops, needed = _forward_slice(program, feed_names, fetch_names)
    for op in ops:
        if registry.get(op.type) is not op.fn:
            raise ValueError(
                f"op {op!r} of type {op.type!r} is not a registered op "
                "(ops._base.register); a bundle can hold registered ops "
                "only")
        if not _plain(op.attrs):
            raise ValueError(f"op {op!r}: attributes {op.attrs} are not "
                             "plain Python values")

    blk = program.global_block
    scope = global_scope()
    weights, consts = {}, {}
    for name in blk.vars:
        if name not in needed:
            continue
        if name in program._constants:
            consts[name] = _numpy(program._constants[name])
        elif blk.var(name).persistable:
            arr = scope.find_var(name)
            if arr is not None:
                weights[name] = _numpy(arr)

    def meta(v):
        with torch._C.DisableTorchFunction():
            return list(v.shape), _dtype_name(v.dtype)

    desc = {
        "feed_names": feed_names,
        "fetch_names": fetch_names,
        "ops": [(op.type, list(op.input_names), list(op.output_names),
                 dict(op.attrs)) for op in ops],
        "vars": {v.name: meta(v) for v in blk.vars.values()},
    }
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path_prefix + ".pdmodel", "wb") as f:
        pickle.dump(desc, f, protocol=4)
    np.savez(path_prefix + ".pdiparams", __consts__=np.array(list(consts)),
             **{("c!" + k): v for k, v in consts.items()},
             **{("w!" + k): v for k, v in weights.items()})
    return feed_names


def load_inference_model(path_prefix, executor=None, device=None, **kwargs):
    """ref: fluid.io.load_inference_model -> ``(program, feed_names,
    fetch_names)``; the weights land in the global scope, on ``device``
    (default: the ``executor``'s place, else the card). Each op is
    rebuilt from the registry by its type. An int8 bundle's
    ``q!<name>``/``s!<name>`` pair becomes the persistables
    ``<name>@INT8`` and ``<name>@SCALE`` and a ``dequantize_weight`` op,
    put before the program's ops, that writes ``<name>``
    (``quant.quantize_inference_model``)."""
    from .._device import resolve_device
    from ..static_.program import Operator, Program, global_scope

    registry = _registry()
    if device is None and executor is not None:
        device = executor.place
    device = resolve_device(device)
    with open(path_prefix + ".pdmodel", "rb") as f:
        desc = pickle.load(f)
    data = np.load(path_prefix + ".pdiparams.npz"
                   if os.path.exists(path_prefix + ".pdiparams.npz")
                   else path_prefix + ".pdiparams")

    program = Program()
    blk = program.global_block
    for name, (shape, dtype) in desc["vars"].items():
        v = blk.create_var(name=name, shape=shape, dtype=dtype)
        if "w!" + name in data.files:
            v.persistable = True
    scope = global_scope()
    for k in data.files:
        if k.startswith("w!"):
            scope.set(k[2:], torch.as_tensor(data[k], device=device))
        elif k.startswith("c!"):
            program._constants[k[2:]] = torch.as_tensor(data[k])
    dequant_ops = []
    for k in data.files:
        if not k.startswith("q!"):
            continue
        name = k[2:]
        qarr, sarr = data[k], data["s!" + name]
        dtype = desc["vars"].get(name, (None, "float32"))[1]
        for suffix, arr in (("@INT8", qarr), ("@SCALE", sarr)):
            v = blk.create_var(name=name + suffix, shape=list(arr.shape),
                               dtype=str(arr.dtype))
            v.persistable = True
            scope.set(name + suffix, torch.as_tensor(arr, device=device))
        dequant_ops.append(Operator(
            "dequantize_weight", registry["dequantize_weight"],
            [name + "@INT8", name + "@SCALE"], [name], {"dtype": dtype}))
    for op in dequant_ops:
        blk.append_op(op)
    for type_, in_names, out_names, attrs in desc["ops"]:
        if type_ not in registry:
            raise ValueError(
                f"op '{type_}' not in the op registry; the model was saved "
                "with an op paddle_tpu_torch does not have")
        blk.append_op(Operator(type_, registry[type_], list(in_names),
                               list(out_names), dict(attrs)))
    program.bump()
    return program, desc["feed_names"], desc["fetch_names"]


# -- fluid.io var-level save/load (ref: fluid/io.py __all__) -----------------


def _program_vars(program, predicate):
    return [v for v in program.global_block.vars.values() if predicate(v)]


def get_program_parameter(program):
    """ref: io.py get_program_parameter."""
    return _program_vars(program, lambda v: v.is_parameter)


def get_program_persistable_vars(program):
    """ref: io.py get_program_persistable_vars."""
    return _program_vars(program, lambda v: v.persistable)


def persistable_footprint(program, scope=None):
    """Byte footprint of a Program's persistables as they lie in the
    scope: ``{"vars": [{name, shape, dtype, bytes}], "total_bytes": N}``;
    a variable with no value in the scope reports its shape and type
    with ``bytes=None``. Reads metadata only: no copy off the device."""
    from ..static_.program import global_scope

    scope = scope or global_scope()
    rows, total = [], 0
    for v in get_program_persistable_vars(program):
        arr = scope.find_var(v.name)
        if arr is not None:
            shape = tuple(int(s) for s in arr.shape)
            dtype = _dtype_name(arr.dtype)
            nbytes = arr.numel() * arr.element_size()
            total += nbytes
        else:
            with torch._C.DisableTorchFunction():
                shape, dtype = tuple(v.shape), _dtype_name(v.dtype)
            nbytes = None
        rows.append({"name": v.name, "shape": shape, "dtype": dtype,
                     "bytes": nbytes})
    return {"vars": rows, "total_bytes": total}


def _var_values(vars_):
    from ..static_.program import global_scope

    scope = global_scope()
    out = {}
    for v in vars_:
        name = v if isinstance(v, str) else v.name
        arr = scope.find_var(name)
        if arr is not None:
            out[name] = _numpy(arr)
    return out


def _vars_path(dirname, filename, default):
    """np.savez appends .npz on write but np.load does NOT on read —
    normalize once so non-default filenames round-trip."""
    p = os.path.join(dirname, filename or default) if dirname \
        else (filename or default)
    return p if p.endswith(".npz") else p + ".npz"


def _put(scope, name, arr, device):
    """``arr`` into ``scope[name]``: copied into the tensor there when its
    shape and type fit (its storage, which a captured graph reads,
    stays), else as a new tensor on ``device`` (default: that tensor's
    device, else the card)."""
    from .._device import resolve_device

    t = torch.as_tensor(np.asarray(arr))
    old = scope.find_var(name)
    if old is not None and old.shape == t.shape and old.dtype == t.dtype:
        with torch.no_grad():
            old.copy_(t)
        return
    if device is None and old is not None:
        device = old.device
    scope.set(name, t.to(resolve_device(device)))


def save_vars(executor=None, dirname=None, main_program=None, vars=None,
              predicate=None, filename=None):
    """Save selected program variables as one npz (ref: io.py
    save_vars; per-var files collapse into one archive here)."""
    from ..static_.program import default_main_program

    program = main_program or default_main_program()
    if vars is None:
        vars = _program_vars(program, predicate or
                             (lambda v: v.persistable))
    values = _var_values(vars)
    wanted = [v if isinstance(v, str) else v.name for v in vars]
    valueless = sorted(set(wanted) - set(values))
    if valueless:  # a silent partial save only fails at restore time
        raise ValueError(
            f"save_vars: no value in scope for {valueless} — run the "
            "startup program (initializers) before saving")
    path = _vars_path(dirname, filename, "__vars__.npz")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **values)
    return path


def load_vars(executor=None, dirname=None, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """Load variables saved by save_vars into the scope (ref: io.py
    load_vars): into the tensors already there, else onto the
    ``executor``'s place (the card without one)."""
    from ..static_.program import default_main_program, global_scope

    program = main_program or default_main_program()
    path = _vars_path(dirname, filename, "__vars__.npz")
    data = np.load(path, allow_pickle=False)
    scope = scope or global_scope()
    want = None
    if vars is not None:
        want = {v if isinstance(v, str) else v.name for v in vars}
    elif predicate is not None:
        want = {v.name for v in _program_vars(program, predicate)}
    if want is not None:
        missing = sorted(want - set(data.files))
        if missing:  # a silent partial restore looks like success
            raise ValueError(
                f"load_vars: {path} is missing variables {missing}")
    device = None if executor is None else executor.place
    for name in data.files:
        if want is None or name in want:
            _put(scope, name, data[name], device)


def save_params(executor=None, dirname=None, main_program=None,
                filename=None):
    """ref: io.py save_params — parameters only."""
    from ..static_.program import default_main_program

    program = main_program or default_main_program()
    return save_vars(executor, dirname, program,
                     vars=get_program_parameter(program),
                     filename=filename or "__params__.npz")


def load_params(executor=None, dirname=None, main_program=None,
                filename=None):
    from ..static_.program import default_main_program

    program = main_program or default_main_program()
    load_vars(executor, dirname, program,
              vars=get_program_parameter(program),
              filename=filename or "__params__.npz")


def save_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    """ref: io.py save_persistables — all persistable vars (params +
    optimizer state recorded in the program)."""
    from ..static_.program import default_main_program

    program = main_program or default_main_program()
    return save_vars(executor, dirname, program,
                     vars=get_program_persistable_vars(program),
                     filename=filename or "__persistables__.npz")


def load_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    from ..static_.program import default_main_program

    program = main_program or default_main_program()
    load_vars(executor, dirname, program,
              vars=get_program_persistable_vars(program),
              filename=filename or "__persistables__.npz")


def load_program_state(model_path, var_list=None):
    """ref: io.py load_program_state -> dict name->ndarray. Accepts an
    .npz path, a save_params/save_persistables dirname, or a save()
    pickle path."""
    p = model_path if model_path.endswith(".npz") else model_path + ".npz"
    if os.path.isdir(model_path):
        # the reference usage passes the save_* dirname
        for fn in ("__params__.npz", "__persistables__.npz",
                   "__vars__.npz"):
            cand = os.path.join(model_path, fn)
            if os.path.exists(cand):
                p = cand
                break
        else:
            raise FileNotFoundError(
                f"no saved variable archive under {model_path}")
    elif not os.path.exists(p):
        if not os.path.exists(model_path):
            raise FileNotFoundError(
                f"no program state at {model_path} (tried {p} too)")
        obj = load(model_path, return_numpy=True)  # a save() pickle
        if not isinstance(obj, dict):
            raise ValueError(
                f"{model_path} holds {type(obj).__name__}, not a "
                "name->array state dict")
        state = {k: np.asarray(v) for k, v in obj.items()}
        if var_list is not None:  # same strictness as the npz branch
            want = {v if isinstance(v, str) else v.name
                    for v in var_list}
            missing = sorted(want - set(state))
            if missing:
                raise ValueError(
                    f"load_program_state: {model_path} is missing "
                    f"{missing}")
            state = {k: v for k, v in state.items() if k in want}
        return state
    data = np.load(p, allow_pickle=False)
    want = None if var_list is None else {
        v if isinstance(v, str) else v.name for v in var_list}
    if want is not None:
        missing = sorted(want - set(data.files))
        if missing:  # same strictness as load_vars
            raise ValueError(
                f"load_program_state: {p} is missing {missing}")
    return {n: data[n] for n in data.files
            if want is None or n in want}


def set_program_state(program, state_dict, device=None):
    """ref: io.py set_program_state: write arrays into the global scope,
    into the tensors already there, else as new tensors on ``device``
    (default: the card)."""
    from ..static_.program import global_scope

    scope = global_scope()
    for name, arr in state_dict.items():
        _put(scope, name, arr, device)
