"""Diagnostics: per-pass findings with op/var provenance.

The counterpart of ``paddle_tpu/analysis/diagnostics.py``, code for code
(the port raises the verifier's PTA001-PTA009 codes; the lint, dataflow,
memory and concurrency passes that raise the rest are not ported). The
reference's analog is its pass error plumbing
(``paddle/fluid/framework/ir/pass.h`` PADDLE_ENFORCE messages + the
``inference/analysis`` AnalysisPass reporting): every check emits a coded
Diagnostic instead of raising ad hoc, so the Executor can decide whether a
finding is fatal, the CLI can print a report, and tests can assert exact
codes.

Error codes (``PTA*`` = verifier, ``PTL*`` = lint):

==========  =========  =====================================================
code        severity   meaning
==========  =========  =====================================================
PTA001      error      use-before-def: op reads a var no prior op defined
PTA002      error      dangling input: op reads a name the block never declared
PTA003      error      duplicate output: one op writes the same name twice
PTA004      error      WAW clobber: ``assign_to`` overwrites a value no op read
PTA005      error      shape drift: re-inferred op output shape != recorded aval
PTA006      error      dtype drift: re-inferred op output dtype != recorded aval
PTA007      error      donation hazard: donated persistable read after last write
PTA008      warning    shape re-inference failed for an op (cannot cross-check)
PTA009      warning    fed shape mismatches a declared static (non -1) dim
PTA010      warning    WAW clobber between ordinary (non-assign) ops
PTA011      error      use-after-donate: two persistables share one Scope
                       buffer and one is donated (fused windows re-read it)
PTA012      warning    plan/spec mismatch: a feed/fetch/persistable sharding
                       spec is inconsistent with the installed ShardingPlan
PTA013      error      over-budget layout: a planner candidate's per-device
                       peak HBM exceeds the budget (candidate is infeasible)
PTL101      warning    feed/data var never read by any op and never fetched
PTL102      warning    fetch of a stale Variable handle (other Program / _stale)
PTL103      warning    captured constant never consumed
PTL104      warning    remat candidate: a long-lived, cheap-to-recompute
                       activation holds up the peak-HBM high-water mark
PTC001      error      inconsistent lock-acquisition order across methods
                       (A->B on one path, B->A on another: deadlock
                       precondition) — ``analysis/concurrency.py``
PTC002      error      blocking call (sleep / Thread.join / Popen.wait /
                       urlopen / untimed queue.get) under a held lock
PTC003      warning    attribute written from both a spawned-thread target
                       and a public method without a shared lock in scope
PTC004      error      runtime lock-order cycle witnessed by the lockdep
                       validator (``obs/lockdep.py``, both stacks attached)
==========  =========  =====================================================
"""
from __future__ import annotations

__all__ = ["Diagnostic", "DiagnosticReport", "ProgramVerificationError",
           "ERROR", "WARNING"]

ERROR = "error"
WARNING = "warning"

class Diagnostic:
    """One finding: code + severity + message + provenance (which op index /
    op repr / var name it anchors to, and which pass emitted it)."""

    __slots__ = ("code", "severity", "message", "op_idx", "op", "var",
                 "pass_name")

    def __init__(self, code, severity, message, op_idx=None, op=None,
                 var=None, pass_name=None):
        self.code = code
        self.severity = severity
        self.message = message
        self.op_idx = op_idx
        self.op = op
        self.var = var
        self.pass_name = pass_name

    def __repr__(self):
        where = []
        if self.op_idx is not None:
            where.append(f"op#{self.op_idx}")
        if self.op is not None:
            where.append(f"{self.op.type}")
        if self.var is not None:
            where.append(f"var '{self.var}'")
        loc = " @ " + " ".join(where) if where else ""
        return f"[{self.code}] {self.severity}{loc}: {self.message}"


class DiagnosticReport:
    """Ordered collection of Diagnostics for one program + pass run."""

    def __init__(self, program=None):
        self.program = program
        self.diagnostics: list[Diagnostic] = []
        self.pass_stats: dict[str, dict] = {}  # pass name -> {'removed': n, ...}

    def add(self, code, severity, message, op_idx=None, op=None, var=None,
            pass_name=None):
        d = Diagnostic(code, severity, message, op_idx=op_idx, op=op, var=var,
                       pass_name=pass_name)
        self.diagnostics.append(d)
        return d

    def errors(self):
        return [d for d in self.diagnostics if d.severity == ERROR]

    def warnings(self):
        return [d for d in self.diagnostics if d.severity == WARNING]

    def codes(self):
        return [d.code for d in self.diagnostics]

    def has(self, code):
        return any(d.code == code for d in self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self):
        return len(self.diagnostics)

    def raise_if_errors(self):
        errs = self.errors()
        if errs:
            raise ProgramVerificationError(errs, self)
        return self

    def __str__(self):
        lines = [f"DiagnosticReport: {len(self.errors())} error(s), "
                 f"{len(self.warnings())} warning(s)"]
        lines += [f"  {d!r}" for d in self.diagnostics]
        for name, stats in self.pass_stats.items():
            kv = ", ".join(f"{k}={v}" for k, v in stats.items())
            lines.append(f"  pass {name}: {kv}")
        return "\n".join(lines)


class ProgramVerificationError(RuntimeError):
    """Raised when the verifier finds error-severity diagnostics. Carries
    the full report so callers (and tests) can inspect exact codes."""

    def __init__(self, errors, report):
        self.errors = errors
        self.report = report
        msg = "\n".join(repr(d) for d in errors)
        super().__init__(
            f"Program verification failed with {len(errors)} error(s):\n{msg}")
