"""Build and load the package's CUDA kernels.

Each source under ``paddle_tpu_torch/csrc/`` exposes a plain C interface
and is compiled by ``nvcc`` into its own shared library, loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds. Libraries go
to ``build/paddle_tpu_torch/`` beside the package (``build/`` is
git-ignored), named by a digest of the source, the headers it includes
(``#include "..."``, transitively) and the command line, so an edited
source or header is rebuilt and a stale library is never loaded. A
build happens at first use; ``build()`` starts every missing build at
once and waits for all of them.

Nothing here runs at import: the CPU tests import every module, and the
host they run on has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "ARCH_FLAGS", "find_nvcc",
           "nvcc_command", "source_files", "library_path", "build", "load"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("paged_attention", "layernorm", "softmax_ce",
                        "flash_attention")}
# keep the "a": wgmma and setmaxnreg exist only for sm_90a
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                       "-fPIC")

_lock = threading.Lock()
_loaded = {}


def find_nvcc():
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda):"
                       " the CUDA kernels cannot be built")


def nvcc_command(nvcc, source, output):
    return [str(nvcc), *_FLAGS, "-o", str(output), str(source)]


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(source):
    """``source`` and every file it includes with quotes, transitively,
    each once, resolved beside the file that includes it."""
    files, todo = [], [Path(source)]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return files


def library_path(name):
    """Where the library of kernel ``name`` lives for its current
    source, the headers it includes, and the flags."""
    h = hashlib.sha256()
    for path in source_files(SOURCES[name]):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name, nvcc):
    """Start the build of ``name`` into a temporary file."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.so")
    proc = subprocess.Popen(nvcc_command(nvcc, SOURCES[name], tmp),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names=None):
    """Build every kernel in ``names`` (default: all) that is not built
    yet, all ``nvcc`` processes at once. Raises with the compiler's
    output when one fails. Returns the library paths."""
    names = list(SOURCES if names is None else names)
    with _lock:
        missing = [n for n in names if not library_path(n).exists()]
        nvcc = find_nvcc() if missing else None
        pending = [_start(n, nvcc) for n in missing]
        errors = []
        for proc, tmp, out in pending:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{out.name}: nvcc exit {proc.returncode}\n"
                              f"{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: a reader never sees half
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(errors))
    return [library_path(n) for n in names]


def load(name):
    """The ``ctypes`` library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path, = build([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
