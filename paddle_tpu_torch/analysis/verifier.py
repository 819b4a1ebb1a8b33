"""Program verifier: structural + shape/dtype checks before a replay.

The counterpart of ``paddle_tpu/analysis/verifier.py`` (ref:
``framework/ir/graph_helper.cc``, ``framework/op_desc.cc`` InferShape):
a malformed recorded Program is rejected HERE with an op/var-anchored
diagnostic, not as an error deep inside the replay.

Checks (codes documented in ``diagnostics.py``):

- PTA001 use-before-def   — an op reads a name no entry value (feed /
  constant / scope-held persistable) provides and no earlier op wrote.
- PTA002 dangling input   — an op reads a name the block never declared.
- PTA003 duplicate output — one op lists the same output name twice.
- PTA004 WAW clobber      — an ``assign_to`` overwrites an earlier op's
  output that nothing ever read (PTA010, a warning, between ordinary
  ops).
- PTA005/6 shape/dtype drift — every op is run again on ``meta`` tensors
  of its recorded inputs (the port's ``jax.eval_shape``; the kernels'
  plain versions, as recording runs them) and its outputs are checked
  against the recorded output Variables.
- PTA007 donation hazard  — an updated persistable is read after its
  last write. The Executor writes the persistables back into the
  Scope's storage at the end of the replay, and a captured CUDA graph
  reads and writes that storage in place: "the last write ends the
  buffer's life" keeps that sound.
- PTA009 static-dim feed mismatch — a fed array disagrees with a declared
  static (non ``-1``) dim of its data Variable (a warning).
"""
from __future__ import annotations

import warnings

import torch

from ..ops import kernels
from .diagnostics import DiagnosticReport, ERROR, WARNING
from .framework import AnalysisPass, PassContext, op_reads

__all__ = ["VerifierPass", "verify_program"]

_SINK_PREFIX = "_gsink"  # backward.py's dummy grad sinks: shape is a lie


class VerifierPass(AnalysisPass):
    name = "verifier"

    def __init__(self, infer_shapes=True):
        self.infer_shapes = infer_shapes

    # -- entry --------------------------------------------------------------
    def run(self, ctx: PassContext) -> None:
        self._check_structure(ctx)
        if self.infer_shapes:
            self._check_shapes(ctx)
        if ctx.feed_shapes is not None:
            self._check_feeds(ctx)

    # -- structural walk ----------------------------------------------------
    def _entry_defined(self, ctx):
        """Names with a value before op 0 executes: captured constants,
        feed/data slots, and persistables the Scope holds."""
        blk = ctx.block
        defined = set(ctx.program._constants)
        if ctx.feed_shapes is not None:
            # the replay env takes EVERY fed name, declared or not
            defined.update(ctx.feed_shapes)
        for name, v in blk.vars.items():
            if v.is_data:
                if ctx.feed_shapes is None:
                    defined.add(name)
            elif v.persistable:
                if ctx.scope_names is None or name in ctx.scope_names:
                    defined.add(name)
        return defined

    def _check_structure(self, ctx):
        blk, rep = ctx.block, ctx.report
        defined = self._entry_defined(ctx)
        # per-name write tracking: (writer_idx, writer_type, read_since)
        last_write: dict[str, tuple] = {}
        last_read: dict[str, int] = {}

        for idx, op in enumerate(ctx.ops):
            # reads first (an op reading and writing the same name — e.g.
            # grad_accumulate, the optimizer update — reads the OLD value)
            for n in op_reads(op):
                if n not in blk.vars and n not in ctx.program._constants \
                        and n not in (ctx.feed_shapes or ()):
                    rep.add("PTA002", ERROR,
                            f"input '{n}' is not declared in the block "
                            "(dangling reference — was the var created in "
                            "another Program?)",
                            op_idx=idx, op=op, var=n, pass_name=self.name)
                    continue
                if n not in defined and n not in last_write:
                    v = blk.vars.get(n)
                    hint = ""
                    if v is not None and v.is_data:
                        hint = " (declared as data but missing from feed)"
                    elif v is not None and v.persistable:
                        hint = (" (persistable not found in the Scope — "
                                "run the startup program first?)")
                    rep.add("PTA001", ERROR,
                            f"input '{n}' is read before any op defines "
                            f"it{hint}",
                            op_idx=idx, op=op, var=n, pass_name=self.name)
                last_read[n] = idx
                if n in last_write:
                    w_idx, w_type, _ = last_write[n]
                    last_write[n] = (w_idx, w_type, True)
            # writes
            seen_out = set()
            for n in op.output_names:
                if n in seen_out:
                    rep.add("PTA003", ERROR,
                            f"op writes output '{n}' twice; the replay env "
                            "keeps only the last value",
                            op_idx=idx, op=op, var=n, pass_name=self.name)
                seen_out.add(n)
                prev = last_write.get(n)
                if prev is not None and not prev[2]:
                    w_idx, w_type, _ = prev
                    if op.type == "assign_to":
                        rep.add("PTA004", ERROR,
                                f"assign_to clobbers '{n}' written by "
                                f"op#{w_idx} ({w_type}) that no op ever "
                                "read — the first computation is lost",
                                op_idx=idx, op=op, var=n,
                                pass_name=self.name)
                    else:
                        rep.add("PTA010", WARNING,
                                f"'{n}' written by op#{w_idx} ({w_type}) is "
                                "overwritten unread (dead write)",
                                op_idx=idx, op=op, var=n,
                                pass_name=self.name)
                last_write[n] = (idx, op.type, False)

        self._check_donation(ctx, last_write, last_read)

    def _check_donation(self, ctx, last_write, last_read):
        """Donated persistables: no read may follow the last write."""
        donated = ctx.donated
        if donated is None:
            # infer the Executor's donation set: SCOPE-HELD persistables
            # the program re-emits (Executor._compile donates exactly
            # persist_in ∩ written; a persistable the Scope doesn't hold
            # is plain env state and is never donated)
            donated = [n for n, v in ctx.block.vars.items()
                       if v.persistable and n in last_write
                       and (ctx.scope_names is None
                            or n in ctx.scope_names)]
        for n in donated:
            if n not in last_write:
                continue
            w_idx = last_write[n][0]
            r_idx = last_read.get(n, -1)
            if r_idx > w_idx:
                ctx.report.add(
                    "PTA007", ERROR,
                    f"donated persistable '{n}' is read at op#{r_idx} after "
                    f"its last write at op#{w_idx}; donation requires the "
                    "last write to end the buffer's live range",
                    op_idx=r_idx, op=ctx.ops[r_idx], var=n,
                    pass_name=self.name)

    # -- shape / dtype re-inference -----------------------------------------
    def _check_shapes(self, ctx):
        blk, rep = ctx.block, ctx.report

        def recorded_meta(n):
            if n in ctx.program._constants:
                return ctx.program._constants[n].to("meta")
            v = blk.vars.get(n)
            if v is None:
                return None
            return torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")

        env: dict[str, torch.Tensor] = {}
        with torch._C.DisableTorchFunction(), kernels.plain_versions():
            for idx, op in enumerate(ctx.ops):
                specs = [env.get(n, recorded_meta(n)) if n is not None
                         else None for n in op.input_names]
                if any(s is None and n is not None
                       for s, n in zip(specs, op.input_names)):
                    continue  # dangling input: already a PTA002 error
                try:
                    out = op.fn(*specs, **op.attrs)
                except Exception as e:  # noqa: BLE001 — any failure
                    rep.add("PTA008", WARNING,
                            f"shape re-inference failed for op "
                            f"'{op.type}': {type(e).__name__}: {e}",
                            op_idx=idx, op=op, pass_name=self.name)
                    for n in op.output_names:
                        r = recorded_meta(n)
                        if r is not None:
                            env[n] = r
                    continue
                outs = out if isinstance(out, (tuple, list)) else (out,)
                for n, o in zip(op.output_names, outs):
                    if o is None:  # no gradient for this input
                        r = recorded_meta(n)
                        if r is not None:
                            env[n] = r
                        continue
                    env[n] = torch.empty(tuple(o.shape), dtype=o.dtype,
                                         device="meta")
                    if n.startswith(_SINK_PREFIX):
                        continue  # placeholder vars, recorded shape a stub
                    r = recorded_meta(n)
                    if r is None:
                        continue
                    if tuple(r.shape) != tuple(o.shape):
                        rep.add("PTA005", ERROR,
                                f"shape drift on '{n}': recorded "
                                f"{tuple(r.shape)} but op '{op.type}' "
                                f"infers {tuple(o.shape)}",
                                op_idx=idx, op=op, var=n,
                                pass_name=self.name)
                    elif r.dtype != o.dtype:
                        rep.add("PTA006", ERROR,
                                f"dtype drift on '{n}': recorded {r.dtype} "
                                f"but op '{op.type}' infers {o.dtype}",
                                op_idx=idx, op=op, var=n,
                                pass_name=self.name)

    # -- feed cross-check ---------------------------------------------------
    def _check_feeds(self, ctx):
        for name, (shape, _dtype) in (ctx.feed_shapes or {}).items():
            v = ctx.block.vars.get(name)
            if v is None or not v.is_data:
                continue
            dyn = set(getattr(v, "dynamic_dims", ()) or ())
            with torch._C.DisableTorchFunction():
                declared = tuple(v.shape)
            mismatch = None
            if len(shape) != len(declared):
                mismatch = (f"rank {len(shape)} vs declared rank "
                            f"{len(declared)}")
            else:
                bad = [i for i in range(len(declared))
                       if i not in dyn and declared[i] != shape[i]]
                if bad:
                    mismatch = (f"dims {bad} of fed shape {tuple(shape)} != "
                                f"declared {declared} (dims {sorted(dyn)} "
                                "are dynamic)")
            if mismatch:
                msg = (f"feed '{name}' mismatches the declared static shape: "
                       f"{mismatch}; the program will be re-traced with the "
                       "fed shape, but a declared static dim usually means "
                       "this is a bug at the call site")
                ctx.report.add("PTA009", WARNING, msg, var=name,
                               pass_name=self.name)
                warnings.warn(msg, RuntimeWarning, stacklevel=4)


def verify_program(program, ops=None, fetch_names=(), feed_shapes=None,
                   donated=None, scope_names=None, infer_shapes=True,
                   raise_on_error=True):
    """Run the verifier over ``program`` and return the DiagnosticReport.

    ``infer_shapes=False`` limits it to the structural checks (used at
    graph-construction sites like append_backward; the Executor always
    runs the full check before its first replay of a program).
    """
    ctx = PassContext(program, ops=ops, fetch_names=fetch_names,
                      feed_shapes=feed_shapes, donated=donated,
                      scope_names=scope_names)
    VerifierPass(infer_shapes=infer_shapes).run(ctx)
    if raise_on_error:
        ctx.report.raise_if_errors()
    return ctx.report
