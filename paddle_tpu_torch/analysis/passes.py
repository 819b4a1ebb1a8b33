"""Optimization passes: identity forwarding, DCE, CSE.

The counterpart of ``paddle_tpu/analysis/passes.py`` (ref: the
``framework/ir`` graph passes, the inference ``ir_graph_clean_pass`` /
``simplify_with_basic_ops_pass`` that strips neutered dropout): an op the
replay never runs costs no launch, no memory and no place in a captured
graph.

All passes are list-to-list rewrites over ``ctx.ops`` (the input Program
is never mutated) and keep every write to a *protected* name — fetches,
persistables, data slots — so fetched values and Scope state are bitwise
identical to the unoptimized replay.
"""
from __future__ import annotations

from .framework import RewritePass, op_reads

__all__ = ["ForwardIdentityPass", "DeadOpEliminationPass", "CSEPass",
           "default_optimize_passes"]


def _is_identity(op):
    """Ops provably equal to forwarding their first input unchanged.

    ``clone(for_test=True)`` neuters dropout by rewriting ``p`` to 0.0,
    where the port's dropout returns ``x`` itself.
    """
    if op.type == "dropout":
        return float(op.attrs.get("p", 1.0)) == 0.0
    return False


class ForwardIdentityPass(RewritePass):
    """Rewire consumers of an identity op's output to read its input, then
    drop the op (ref: simplify_with_basic_ops_pass dropping eval-mode
    dropout). Protected outputs keep the op (the name must still be
    written for fetch/Scope visibility)."""

    name = "forward_identity"

    def rewrite(self, ctx):
        protected = ctx.protected_names()
        last_write = _last_write_index(ctx.ops)
        rename: dict[str, str] = {}
        out = []
        for idx, op in enumerate(ctx.ops):
            if op.input_names:
                op = _remap_inputs(op, rename)
            if (_is_identity(op) and len(op.output_names) == 1
                    and op.output_names[0] not in protected
                    and op.input_names and op.input_names[0] is not None):
                # inputs were remapped above, so src already chases chains
                src = op.input_names[0]
                tgt = op.output_names[0]
                # forwarding is only sound if nothing overwrites the
                # source later: readers of tgt would see the NEW value
                # (assign_to can redefine any name in-place)
                if last_write.get(src, -1) < idx:
                    rename[tgt] = src
                    continue
            # a write to a forwarded name ends the forwarding
            for n in op.output_names:
                rename.pop(n, None)
            out.append(op)
        return out


class DeadOpEliminationPass(RewritePass):
    """Reverse-liveness DCE: an op survives only if some output reaches a
    fetch or a persistable's final value (ref: ir_graph_clean_pass +
    inference ir "delete unused nodes"). Recorded ops are pure (a
    persistable is written only through the op's outputs), so an
    unreachable op is unobservable by construction."""

    name = "dead_op_elimination"

    def rewrite(self, ctx):
        blk = ctx.block
        live = set(ctx.fetch_names)
        for name, v in blk.vars.items():
            if v.persistable:
                live.add(name)
        keep = [False] * len(ctx.ops)
        for i in range(len(ctx.ops) - 1, -1, -1):
            op = ctx.ops[i]
            if any(n in live for n in op.output_names):
                keep[i] = True
                live.difference_update(op.output_names)
                live.update(op_reads(op))
        return [op for op, k in zip(ctx.ops, keep) if k]


class CSEPass(RewritePass):
    """Common-subexpression elimination keyed on
    ``(op.type, input value-versions, attrs)`` for pure registry kernels.

    Purity here is structural: the op's fn must be exactly the function
    the registry maps its type to (recorded torch calls, optimizer
    updates, grad clip are skipped), and dropout, which draws from the
    device's generator, is never merged. Input *versions* (bumped at
    every write) keep two textually equal ops distinct when an
    ``assign_to`` redefines a name between them.
    """

    name = "cse"

    def rewrite(self, ctx):
        from ..ops._base import OP_REGISTRY

        protected = ctx.protected_names()
        last_write = _last_write_index(ctx.ops)
        version: dict[str, int] = {}
        seen: dict[tuple, list] = {}
        rename: dict[str, str] = {}
        out = []
        for idx, op in enumerate(ctx.ops):
            if op.input_names:
                op = _remap_inputs(op, rename)
            key = None
            if (OP_REGISTRY.get(op.type) is op.fn and op.type != "dropout"
                    and not any(n in protected for n in op.output_names)):
                try:
                    akey = tuple(sorted(
                        (k, repr(v)) for k, v in op.attrs.items()))
                    key = (op.type,
                           tuple((n, version.get(n, 0))
                                 for n in op.input_names),
                           akey)
                except Exception:  # unorderable attrs: skip CSE for this op
                    key = None
            if key is not None and key in seen:
                cached = seen[key]
                # the cached outputs must still hold the value they held
                # when registered (no in-place write since), AND nothing
                # may overwrite them later — readers of the merged-away
                # name would see the clobbered value
                if all(version.get(n, 0) == v
                       and last_write.get(n, -1) < idx for n, v in cached):
                    for mine, (theirs, _) in zip(op.output_names, cached):
                        rename[mine] = theirs
                    continue
            for n in op.output_names:
                version[n] = version.get(n, 0) + 1
                rename.pop(n, None)  # in-place write ends any forwarding
            if key is not None:
                seen[key] = [(n, version.get(n, 0))
                             for n in op.output_names]
            out.append(op)
        return out


def _last_write_index(ops):
    """name -> index of the LAST op writing it (forwarding-safety guard)."""
    out: dict[str, int] = {}
    for idx, op in enumerate(ops):
        for n in op.output_names:
            out[n] = idx
    return out


def _remap_inputs(op, rename):
    if not rename or not any(n in rename for n in op.input_names if n):
        return op
    from ..static_.program import Operator

    new_in = [rename.get(n, n) if n is not None else None
              for n in op.input_names]
    return Operator(op.type, op.fn, new_in, list(op.output_names),
                    op.attrs, op.uid)


def default_optimize_passes(optimize_level):
    """Pass pipeline for an ``optimize_level`` (documented on
    ``Executor.run``): 0 = none, 1 = identity forwarding + DCE (always
    semantics-preserving), 2 = additionally CSE."""
    passes = []
    if optimize_level >= 1:
        passes += [ForwardIdentityPass(), DeadOpEliminationPass()]
    if optimize_level >= 2:
        passes.append(CSEPass())
    return passes
