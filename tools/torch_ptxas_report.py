#!/usr/bin/env python3
"""Registers and spills of each CUDA kernel of ``paddle_tpu_torch``, as
``nvcc -Xptxas -v`` reports them, and its tensor-core instructions.

    python3 tools/torch_ptxas_report.py [flash_attention ...]

Compiles each named source of ``paddle_tpu_torch/csrc`` (default: all)
with the package's own nvcc flags plus ``-Xptxas -v`` into a temporary
directory, and prints one line a kernel: its demangled name, registers
a thread, spill stores and loads, stack frame (bytes), and the number
of HMMA (tensor-core matrix multiply) instructions in its SASS, from
``cuobjdump -sass`` of the library. Needs ``nvcc`` and ``cuobjdump``
(the machine with the card has both), not a card.
"""
import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.ops.kernels import _build  # noqa: E402

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SASS_FN = re.compile(r"Function : (\w+)")


def demangle(names, nvcc):
    """Names through ``cu++filt`` beside nvcc (or ``c++filt``), where
    there is one."""
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if not os.access(filt, os.X_OK):
        filt = shutil.which("c++filt")
    if not filt or not names:
        return list(names)
    return subprocess.run([filt], input="\n".join(names), text=True,
                          capture_output=True,
                          check=True).stdout.splitlines()


def hmma_counts(lib, nvcc):
    """HMMA instructions a kernel (by mangled name) in ``lib``'s SASS."""
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", lib],
        capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if m := _SASS_FN.search(line):
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def report(name, nvcc):
    """One dict a kernel of source ``name``."""
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "lib.so")
        cmd = [*_build.nvcc_command(nvcc, _build.SOURCES[name], lib),
               "-Xptxas", "-v"]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{done.stderr}")
        hmma = hmma_counts(lib, nvcc)
    rows = []
    for line in done.stderr.splitlines():
        if m := _ENTRY.search(line):
            rows.append({"kernel": m.group(1),
                         "hmma": hmma.get(m.group(1))})
        elif rows and (m := _FRAME.search(line)):
            rows[-1].update(stack=int(m.group(1)), spill_stores=int(
                m.group(2)), spill_loads=int(m.group(3)))
        elif rows and (m := _USED.search(line)):
            rows[-1]["registers"] = int(m.group(1))
    for row, pretty in zip(rows, demangle([r["kernel"] for r in rows],
                                          nvcc)):
        row["kernel"] = pretty
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", default=sorted(_build.SOURCES))
    args = ap.parse_args()
    unknown = set(args.sources) - set(_build.SOURCES)
    if unknown:
        ap.error(f"no such source: {sorted(unknown)}")
    nvcc = _build.find_nvcc()
    for name in args.sources:
        for r in report(name, nvcc):
            print(f"ptxas {name}: {r['kernel']}: {r.get('registers')} "
                  f"registers, spill stores {r.get('spill_stores')} B, "
                  f"spill loads {r.get('spill_loads')} B, stack "
                  f"{r.get('stack')} B, HMMA {r['hmma']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
