"""The machinery of the tensor-API parity tables
(``tests/test_torch_tensor_{math,reduce,manip,linalg}.py``): one
``Case`` a name (or a trap), run through the JAX package and through
``paddle_tpu_torch`` on the CPU with the same numpy inputs.

A case's ``call(m, d, *xs)`` is written once for both packages: ``m``
is ``paddle_tpu`` or ``paddle_tpu_torch``, ``d`` the keywords only the
port takes (``device="cpu"`` for the makers), ``xs`` the inputs as each
package's tensors. The inputs come from ``RandomState(0)`` (the output
cotangents of a gradient case from ``RandomState(1)``). Outputs are
compared value by value, nested tuples flattened:

- ``f32``: float32 arithmetic and reductions, rtol 1e-6 (and atol 1e-6
  of the largest |value| of the array: sums in another order);
- ``special``: transcendental and special functions, rtol 1e-5;
- ``linalg``: 1e-4 relative; decompositions through ``check`` by their
  invariants;
- ``exact``: integer, boolean and index results, layout and gathers,
  and anything else that is not a float (the JAX package's indices are
  int32, the port's int64: values are compared, not types).

With ``grad``, the gradients of every float input of ``sum(out * g)``
are held to the JAX tape's at the same tolerance (``f32`` for an
``exact`` case: its gradient sums). With ``types``, each output's type
is held to the JAX package's too: float32 where it gives float32, bool
where bool, an integer where an integer (int64 for its int32: the
port's integers and indices are int64).
"""
import numpy as np
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt

TOL = {"f32": 1e-6, "special": 1e-5, "linalg": 1e-4, "exact": 0.0}
CPU = {"device": "cpu"}


class Case:
    """``name``: the API name the case covers; ``inputs``: makers
    ``rng -> array``; ``check(got, want, arrays)`` replaces the value
    comparison (then ``want`` may be the JAX outputs or None with
    ``jax=False``)."""

    def __init__(self, name, call, inputs=(), tol="f32", grad=False,
                 check=None, label=None, jax=True, types=False):
        self.name, self.call, self.inputs = name, call, tuple(inputs)
        self.tol, self.grad, self.check, self.jax = tol, grad, check, jax
        self.types = types
        self.id = label or name

    def __repr__(self):
        return self.id


def ids(cases):
    return [c.id for c in cases]


# -- input makers -------------------------------------------------------------

def f(*shape, lo=None, hi=None):
    """float32 N(0, 1) (or U(lo, hi))."""
    if lo is not None:
        return lambda r: r.uniform(lo, hi, shape).astype(np.float32)
    return lambda r: r.randn(*shape).astype(np.float32)


def i(lo, hi, *shape):
    return lambda r: r.randint(lo, hi, shape).astype(np.int64)


def b(*shape):
    return lambda r: r.rand(*shape) > 0.5


def c(a, dtype=None):
    a = np.asarray(a, dtype)
    return lambda r: a.copy()


def spd(n):
    """A symmetric positive-definite float32 matrix."""
    def make(r):
        a = r.randn(n, n)
        return (a @ a.T + n * np.eye(n)).astype(np.float32)
    return make


# -- running ------------------------------------------------------------------

def flat(v):
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in flat(x)]
    return [v]


def to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().resolve_conj().numpy()
    if isinstance(v, jpt.Tensor):
        return np.asarray(v._data)
    return np.asarray(v)


def _floats(arrays):
    return [k for k, a in enumerate(arrays) if a.dtype == np.float32]


def _cotangents(outs):
    rng = np.random.RandomState(1)
    return [np.asarray(rng.randn(*np.shape(o)), np.float32)
            if np.asarray(o).dtype.kind == "f" else None for o in outs]


def run_jax(case, arrays):
    """The JAX package's outputs (and input gradients) as numpy."""
    grad_at = _floats(arrays) if case.grad else []
    xs = [jpt.to_tensor(a, stop_gradient=k not in grad_at)
          for k, a in enumerate(arrays)]
    outs = flat(case.call(jpt, {}, *xs))
    got = [to_numpy(o) for o in outs]
    grads = None
    if grad_at:
        loss = None
        for o, g in zip(outs, _cotangents(got)):
            if g is None:
                continue
            term = jpt.sum(jpt.multiply(o, jpt.to_tensor(g)))
            loss = term if loss is None else loss + term
        loss.backward()
        grads = [None if xs[k].grad is None else to_numpy(xs[k].grad)
                 for k in grad_at]
    return got, grads


def run_port(case, arrays, device="cpu"):
    """``paddle_tpu_torch``'s outputs (and input gradients) as numpy."""
    grad_at = _floats(arrays) if case.grad else []
    xs = [torch.from_numpy(np.array(a)).to(device).requires_grad_(
        k in grad_at) for k, a in enumerate(arrays)]
    outs = flat(case.call(pt, CPU if device == "cpu" else {}, *xs))
    got = [to_numpy(o) for o in outs]
    grads = None
    if grad_at:
        loss = None
        for o, g in zip(outs, _cotangents(got)):
            if g is None:
                continue
            term = (o * torch.from_numpy(g).to(device)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads = [None if xs[k].grad is None else to_numpy(xs[k].grad)
                 for k in grad_at]
    return got, grads


def close(got, want, tol, what):
    assert np.shape(got) == np.shape(want), \
        f"{what}: shape {np.shape(got)} vs the reference's {np.shape(want)}"
    got, want = np.asarray(got), np.asarray(want)
    if tol == "exact" or want.dtype.kind not in "fc":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    rtol = TOL[tol]
    finite = np.abs(want[np.isfinite(want)]) if want.size else want
    scale = float(finite.max()) if finite.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def same_type(got, want, what):
    """``got``'s type is the JAX package's ``want``'s, an int64 standing
    for its int32."""
    g, w = np.asarray(got).dtype, np.asarray(want).dtype
    assert g == w or (w == np.int32 and g == np.int64), \
        f"{what}: type {g} vs the reference's {w}"


def arrays_of(case):
    rng = np.random.RandomState(0)
    return [mk(rng) for mk in case.inputs]


def check_case(case):
    """The case through both packages; raises on a difference."""
    arrays = arrays_of(case)
    got, tgrads = run_port(case, arrays)
    want, jgrads = run_jax(case, arrays) if case.jax else (None, None)
    if case.check is not None:
        case.check(got, want, arrays)
    else:
        assert len(got) == len(want), (len(got), len(want))
        for k, (g, w) in enumerate(zip(got, want)):
            close(g, w, case.tol, f"{case.id} output {k}")
    if case.types:
        for k, (g, w) in enumerate(zip(got, want)):
            same_type(g, w, f"{case.id} output {k}")
    if case.grad and case.jax:
        # a gradient sums the cotangents a broadcast or repeat spread:
        # float32 sums in another order, even where the values are exact
        tol = "f32" if case.tol == "exact" else case.tol
        for k, (g, w) in enumerate(zip(tgrads, jgrads)):
            zero = lambda a, o: np.zeros_like(o) if a is None else a
            ref = arrays[_floats(arrays)[k]]
            close(zero(g, ref), zero(w, ref), tol, f"{case.id} gradient {k}")


def covered_names():
    """The names ``paddle_tpu/__init__.py:84-125`` imports from the JAX
    package's op modules (``mode as mode_op`` as ``mode_op``)."""
    import ast
    import os

    path = os.path.join(os.path.dirname(jpt.__file__), "__init__.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and 84 <= node.lineno <= 125 \
                and (node.module or "").startswith("ops."):
            names += [a.asname or a.name for a in node.names]
    return names
