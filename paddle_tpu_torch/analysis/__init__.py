"""paddle_tpu_torch.analysis — the Program verifier and the compile
passes.

The counterpart of ``paddle_tpu/analysis`` (ref: the
``paddle/fluid/framework/ir`` pass infrastructure): a recorded Program
(``static_/program.py``) is checked and rewritten here before the
Executor first replays it, so a malformed graph dies with an
op/var-anchored diagnostic, and ops the fetches never need are dropped.

- ``diagnostics`` — coded findings (PTA*) with op/var provenance
- ``framework``   — Pass / AnalysisPass / RewritePass / PassManager
- ``verifier``    — use-before-def, dangling inputs, WAW hazards, shape
                    and dtype re-inference on ``meta``, donation safety
- ``passes``      — identity forwarding, dead-op elimination, CSE

``run_compile_passes`` is the Executor's single entry point: verify
always, optimize behind ``optimize_level``. Not ported: ``lint``,
``dataflow``, ``memory`` and ``concurrency``.
"""
from __future__ import annotations

from .diagnostics import (Diagnostic, DiagnosticReport,
                          ProgramVerificationError, ERROR, WARNING)
from .framework import (AnalysisPass, Pass, PassContext, PassManager,
                        RewritePass, normalize_fetch, op_reads, op_writes)
from .verifier import VerifierPass, verify_program
from .passes import (CSEPass, DeadOpEliminationPass, ForwardIdentityPass,
                     default_optimize_passes)

__all__ = [
    "Diagnostic", "DiagnosticReport", "ProgramVerificationError",
    "ERROR", "WARNING", "Pass", "AnalysisPass", "RewritePass",
    "PassContext", "PassManager", "normalize_fetch", "op_reads",
    "op_writes", "VerifierPass", "verify_program", "ForwardIdentityPass",
    "DeadOpEliminationPass", "CSEPass", "default_optimize_passes",
    "run_compile_passes",
]


def run_compile_passes(program, fetch_list=(), feed_shapes=None,
                       donated=None, scope_names=None, optimize_level=0,
                       infer_shapes=True, raise_on_error=True):
    """Verify ``program`` (always) and optimize its op list (behind
    ``optimize_level``); returns ``(ops, report)`` where ``ops`` is the
    (possibly rewritten) op list to replay. The Program itself is never
    mutated."""
    fetch_names, fetch_vars = normalize_fetch(fetch_list)
    ctx = PassContext(program, fetch_names=fetch_names,
                      feed_shapes=feed_shapes, donated=donated,
                      scope_names=scope_names, fetch_vars=fetch_vars)
    PassManager([VerifierPass(infer_shapes=infer_shapes)]).run_ctx(ctx)
    if raise_on_error:
        ctx.report.raise_if_errors()
    # rewrites only run on a verified program
    if not ctx.report.errors():
        PassManager(default_optimize_passes(optimize_level)).run_ctx(ctx)
    return ctx.ops, ctx.report
