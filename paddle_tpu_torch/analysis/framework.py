"""Pass framework: PassContext / Pass / PassManager.

The counterpart of ``paddle_tpu/analysis/framework.py`` (ref:
``paddle/fluid/framework/ir`` ``pass.h`` Pass::Apply, ``PassBuilder``):
the "graph" is the recorded ``Block.ops`` list itself, so passes are
list-to-list rewrites.

- ``AnalysisPass`` — read-only; emits Diagnostics into the report.
- ``RewritePass``  — returns a NEW op list (the Program is never
  mutated: the Executor replays the rewritten list, while the user's
  Program and its cache-keying version stay as they were).

``PassManager.run`` threads one PassContext through the sequence and
records each rewrite's op counts in ``report.pass_stats``.
"""
from __future__ import annotations

import logging
import time

from ..obs import metrics as _obs_metrics
from .diagnostics import DiagnosticReport

_log = logging.getLogger("paddle_tpu_torch.analysis")

__all__ = ["PassContext", "Pass", "AnalysisPass", "RewritePass",
           "PassManager", "op_reads", "op_writes", "normalize_fetch"]


def normalize_fetch(fetch_list):
    """One canonical fetch_list resolution: ``(names, variable_handles)``.
    The Executor's key, the verifier and the DCE roots all read these
    names."""
    from ..static_.program import Variable

    names = tuple(f.name if isinstance(f, Variable) else str(f)
                  for f in fetch_list)
    handles = tuple(f for f in fetch_list if isinstance(f, Variable))
    return names, handles


def op_reads(op):
    """Input names an op actually reads (None slots are absent optionals)."""
    return [n for n in op.input_names if n is not None]


def op_writes(op):
    return list(op.output_names)


class PassContext:
    """Everything a pass may consult (ref: ir pass attrs): the Program
    (never mutated), the working op list (rewrites replace it), the
    fetch names (DCE roots), the fed ``{name: (shape, dtype)}`` when
    known, the donated names when known, the persistables the Scope
    holds when known (None: all of them), and the report."""

    def __init__(self, program, ops=None, fetch_names=(), feed_shapes=None,
                 donated=None, scope_names=None, fetch_vars=(), report=None):
        self.program = program
        self.ops = list(ops if ops is not None else program.global_block.ops)
        self.fetch_names = tuple(fetch_names)
        self.feed_shapes = feed_shapes
        self.donated = donated
        self.scope_names = scope_names
        self.fetch_vars = tuple(fetch_vars)
        self.report = report if report is not None else \
            DiagnosticReport(program)

    @property
    def block(self):
        return self.program.global_block

    def protected_names(self):
        """Names whose final value is observable outside the replay:
        fetches, persistables (written back to the Scope), feed/data
        slots. Rewrites keep every write to these."""
        out = set(self.fetch_names)
        for name, v in self.block.vars.items():
            if v.persistable or v.is_data:
                out.add(name)
        return out


class Pass:
    """Base pass (ref: ir/pass.h). ``name`` keys pass_stats and diagnostic
    provenance."""

    name = "pass"

    def run(self, ctx: PassContext) -> None:
        raise NotImplementedError


class AnalysisPass(Pass):
    """Read-only pass: inspects ctx.ops / ctx.program, emits diagnostics."""


class RewritePass(Pass):
    """Op-list rewrite: ``rewrite`` returns the new list; the manager
    records the op-count delta under this pass's name."""

    def run(self, ctx: PassContext) -> None:
        before = len(ctx.ops)
        ctx.ops = self.rewrite(ctx)
        removed = before - len(ctx.ops)
        ctx.report.pass_stats[self.name] = {
            "ops_before": before, "ops_after": len(ctx.ops),
            "removed": removed}
        if removed:
            _log.info("pass %s: removed %d of %d ops", self.name, removed,
                      before)

    def rewrite(self, ctx: PassContext) -> list:
        raise NotImplementedError


class PassManager:
    """Sequences passes over one PassContext (ref: ir PassBuilder)."""

    def __init__(self, passes=()):
        self.passes = list(passes)

    def add(self, p):
        self.passes.append(p)
        return self

    def run(self, program, ops=None, fetch_names=(), feed_shapes=None,
            donated=None, scope_names=None, fetch_vars=(), report=None):
        ctx = PassContext(program, ops=ops, fetch_names=fetch_names,
                          feed_shapes=feed_shapes, donated=donated,
                          scope_names=scope_names, fetch_vars=fetch_vars,
                          report=report)
        return self.run_ctx(ctx)

    def run_ctx(self, ctx):
        for p in self.passes:
            t0 = time.perf_counter()
            p.run(ctx)
            ms = (time.perf_counter() - t0) * 1e3
            # the report's pass_stats stays rewrite-only ({} when no
            # rewrite ran); every pass's time goes to obs.metrics
            if p.name in ctx.report.pass_stats:
                ctx.report.pass_stats[p.name]["ms"] = ms
            _obs_metrics.histogram(f"analysis.pass.{p.name}.ms").observe(ms)
        return ctx
