"""Linear algebra, the counterparts of ``paddle_tpu/ops/linalg.py``'s:
``norm`` (``fro``, any ``p``, ``inf``, axis lists), ``dist``,
``cholesky``, ``inverse``, ``matrix_power``, ``pinv``, ``svd``, ``qr``,
``eig``/``eigvals`` (complex), ``eigh``/``eigvalsh``, ``matrix_rank``,
``det``, ``slogdet``, ``cross``, ``triangular_solve``,
``cholesky_solve``, ``solve``, ``lstsq``, ``histogram``, ``mv``,
``multi_dot``, ``cov`` and ``corrcoef``. No TPU kernel computes these;
here they are ``torch.linalg``'s (cuSOLVER and cuBLAS on the card).

The JAX package's forms are kept:

- ``svd`` returns ``V``, not ``Vᴴ``: the last two axes of ``vh``
  swapped (``linalg.py:84-87``);
- ``lstsq`` is ``jnp.linalg.lstsq``'s SVD solve (``linalg.py:179-182``):
  singular values below ``rcond * s[0]`` (default ``eps * max(m, n)``)
  dropped, so a rank-deficient system is solved, with the residuals,
  the rank and the singular values. ``torch.linalg.lstsq`` on the card
  has only the ``gels`` driver: full rank, no rank, no singular values;
- ``norm`` with a number ``p`` is ``sum(|x|^p)^(1/p)`` (``max``/``min``
  of ``|x|`` at ``±inf``, a count at 0);
- ``histogram`` with ``min == max == 0`` takes the data's range; its
  counts are integers;
- an integer or bool matrix is float32 in the decompositions, the
  solves, ``det``/``slogdet``, ``cov`` and ``corrcoef`` (``_float``), as
  jnp promotes it; ``mv`` and ``multi_dot`` of bools give a bool, as
  ``matmul`` does.
"""
from __future__ import annotations

import torch

from ._args import tensor
from ._base import register
from .math import _matmul
from .reduction import _float

__all__ = ["norm", "dist", "cholesky", "inverse", "matrix_power", "pinv",
           "svd", "qr", "eig", "eigh", "eigvals", "eigvalsh", "matrix_rank",
           "det", "slogdet", "cross", "triangular_solve", "cholesky_solve",
           "solve", "lstsq", "histogram", "mv", "multi_dot", "cov",
           "corrcoef"]

_INF = float("inf")


def _dims(axis, x):
    return tuple(range(x.dim())) if axis is None else axis


@register("p_norm", inputs=("x",))
def _p_norm(x, *, p=2.0, axis=None, keepdim=False):
    d = _dims(axis, x)
    if p == _INF:
        return torch.amax(torch.abs(x), dim=d, keepdim=keepdim)
    if p == -_INF:
        return torch.amin(torch.abs(x), dim=d, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=d, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=d, keepdim=keepdim) ** (1.0 / p)


@register("frobenius_norm", inputs=("x",))
def _fro(x, *, axis=None, keepdim=False):
    return torch.sqrt(torch.sum(torch.square(x), dim=_dims(axis, x),
                                keepdim=keepdim))


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The Frobenius norm (``p="fro"``) or the ``p``-norm of ``x`` over
    ``axis`` (``None``: all of it; an int or a list)."""
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    elif axis is not None:
        axis = int(axis)
    if p == "fro":
        return _fro(x, axis=axis, keepdim=bool(keepdim))
    return _p_norm(x, p=float(p), axis=axis, keepdim=bool(keepdim))


def dist(x, y, p=2.0, name=None):
    """The ``p``-norm of ``x - y``."""
    from .math import subtract

    return norm(subtract(x, y), p=p)


@register("cholesky", inputs=("x",))
def _cholesky(x, *, upper=False):
    lo = torch.linalg.cholesky(_float(x))
    return lo.transpose(-1, -2) if upper else lo


def cholesky(x, upper=False, name=None):
    """The Cholesky factor of ``x``: lower, or its transpose with
    ``upper``."""
    return _cholesky(x, upper=bool(upper))


@register("inverse", inputs=("x",))
def _inverse(x):
    return torch.linalg.inv(_float(x))


def inverse(x, name=None):
    """``x``'s inverse."""
    return _inverse(x)


@register("matrix_power", inputs=("x",))
def _matrix_power(x, *, n):
    return torch.linalg.matrix_power(x, n)


def matrix_power(x, n, name=None):
    """``x`` to the integer power ``n``."""
    return _matrix_power(x, n=int(n))


@register("pinv", inputs=("x",))
def _pinv(x, *, rcond=1e-15):
    return torch.linalg.pinv(_float(x), rtol=rcond)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    """The pseudo-inverse, singular values below ``rcond`` times the
    largest dropped."""
    return _pinv(x, rcond=float(rcond))


def svd(x, full_matrices=False, name=None):
    """``(U, S, V)`` with ``x = U diag(S) Vᵀ``."""
    u, s, vh = torch.linalg.svd(_float(x),
                                full_matrices=bool(full_matrices))
    return u, s, vh.transpose(-1, -2)


def qr(x, mode="reduced", name=None):
    """``(Q, R)``, ``reduced`` or ``complete``."""
    return tuple(torch.linalg.qr(_float(x), mode=mode))


def eig(x, name=None):
    """The eigenvalues and eigenvectors of a square ``x``, complex."""
    return tuple(torch.linalg.eig(_float(x)))


def eigh(x, UPLO="L", name=None):
    """The eigenvalues (ascending) and eigenvectors of a symmetric
    ``x``, from its ``UPLO`` triangle."""
    return tuple(torch.linalg.eigh(_float(x), UPLO=UPLO))


def eigvals(x, name=None):
    """The eigenvalues of a square ``x``, complex."""
    return torch.linalg.eigvals(_float(x))


def eigvalsh(x, UPLO="L", name=None):
    """The eigenvalues of a symmetric ``x``, ascending."""
    return torch.linalg.eigvalsh(_float(x), UPLO=UPLO)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The number of singular values above ``tol`` (default: the largest
    times ``eps * max(m, n)``)."""
    x = _float(x)
    if tol is None:
        return torch.linalg.matrix_rank(x)
    return torch.linalg.matrix_rank(x, atol=float(tol), rtol=0.0)


@register("det", inputs=("x",))
def _det(x):
    return torch.linalg.det(_float(x))


def det(x, name=None):
    """``x``'s determinant."""
    return _det(x)


@register("slogdet", inputs=("x",))
def _slogdet(x):
    sign, logdet = torch.linalg.slogdet(_float(x))
    return sign, logdet


def slogdet(x, name=None):
    """The sign and the log of the absolute value of ``x``'s
    determinant."""
    return _slogdet(x)


@register("cross", inputs=("x", "y"))
def _cross(x, y, *, axis=-1):
    return torch.linalg.cross(x, y, dim=axis)


def cross(x, y, axis=-1, name=None):
    """The cross product of 3-vectors along ``axis``."""
    return _cross(x, y, axis=int(axis))


@register("triangular_solve", inputs=("x", "y"))
def _triangular_solve(x, y, *, upper=True, transpose=False,
                      unitriangular=False):
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(a, y, upper=upper,
                                         unitriangular=unitriangular)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """``z`` with ``A z = y``, ``A`` the ``upper`` (else lower) triangle
    of ``x`` (of ``xᵀ`` with ``transpose``, still read from that
    triangle, as the JAX package reads it)."""
    return _triangular_solve(x, y, upper=bool(upper),
                             transpose=bool(transpose),
                             unitriangular=bool(unitriangular))


@register("cholesky_solve", inputs=("x", "y"))
def _cholesky_solve(x, y, *, upper=False):
    # the factor's other triangle is never read (nor differentiated)
    y = torch.triu(y) if upper else torch.tril(y)
    return torch.cholesky_solve(x, y, upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """``z`` with ``A z = x``, ``y`` the Cholesky factor of ``A``."""
    return _cholesky_solve(x, y, upper=bool(upper))


@register("solve", inputs=("x", "y"))
def _solve(x, y):
    return torch.linalg.solve(x, y)


def solve(x, y, name=None):
    """``z`` with ``x z = y``."""
    return _solve(x, y)


def _lstsq(a, b, rcond):
    """``jnp.linalg.lstsq``: ``(x, residuals, rank, s)``."""
    a, b = _float(a), _float(b)
    one_d = b.dim() == 1
    if one_d:
        b = b[:, None]
    m, n = a.shape
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    elif rcond < 0:
        rcond = torch.finfo(a.dtype).eps
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[:, None]
    x = vt.mT.conj() @ (s_inv * (u.mT.conj() @ b))
    resid = torch.sum(torch.abs(b - a @ x) ** 2, dim=0)
    if one_d:
        x = x.reshape(-1)
    return x, resid, rank, s


@register("lstsq_vals", inputs=("x", "y"))
def _lstsq_vals(x, y, *, rcond=None):
    return _lstsq(x, y, rcond)[0]


def lstsq(x, y, rcond=None, driver=None, name=None):
    """The least-squares solution of ``x z = y`` by an SVD, with the
    residuals, the rank and ``x``'s singular values."""
    return _lstsq(x, y, None if rcond is None else float(rcond))


def histogram(input, bins=100, min=0, max=0, name=None):
    """The counts of ``input`` in ``bins`` equal bins over ``[min,
    max]`` (``min == max == 0``: the data's range), int64."""
    x = tensor(input).reshape(-1)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.histc(x, bins=int(bins), min=float(min),
                       max=float(max)).to(torch.int64)


@register("mv", inputs=("x", "vec"))
def _mv(x, vec):
    return _matmul(x, vec)


def mv(x, vec, name=None):
    """The matrix-vector product."""
    return _mv(x, vec)


@register("multi_dot_2", inputs=("xs",))
def _multi_dot(*xs):
    if all(x.dtype == torch.bool for x in xs):
        out = xs[0]
        for x in xs[1:]:
            out = _matmul(out, x)
        return out
    return torch.linalg.multi_dot(xs)


def multi_dot(x, name=None):
    """The product of the matrices of the list ``x``, in the cheapest
    order."""
    return _multi_dot(*x)


@register("cov", inputs=("x",))
def _cov(x, *, rowvar=True, ddof=1):
    x = _float(x)
    return torch.cov(x if rowvar or x.dim() < 2 else x.transpose(0, 1),
                     correction=ddof)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """The covariance of ``x``'s rows (columns unless ``rowvar``), ``n -
    1`` in the divisor with ``ddof``."""
    return _cov(x, rowvar=bool(rowvar), ddof=1 if ddof else 0)


@register("corrcoef", inputs=("x",))
def _corrcoef(x, *, rowvar=True):
    x = _float(x)
    return torch.corrcoef(x if rowvar or x.dim() < 2
                          else x.transpose(0, 1))


def corrcoef(x, rowvar=True, name=None):
    """The correlation coefficients of ``x``'s rows (columns unless
    ``rowvar``)."""
    return _corrcoef(x, rowvar=bool(rowvar))
