"""paddle_tpu_torch.ops: the hand-written kernels (``ops.kernels``), the
ops of the ported paths that route to them or sit beside them
(``norm_ops``, ``random_ops``, ``activation``, ``conv``, ``misc``), and
the Paddle tensor API: every name ``paddle_tpu/__init__.py:84-125``
imports from the JAX package's op modules, from ``creation``, ``math``,
``reduction`` (``mode`` also as ``mode_op``), ``manipulation``,
``compare``, ``activation`` (``tanh``), ``linalg`` and
``control_flow``. ``paddle_tpu_torch`` exports the same names.

The flat ``ops.*`` names of the JAX package are bound here too, outside
``__all__`` (the tensor API): the activations, convolutions, pools and
resizes, dropouts, norms, ``misc``'s fluid ops, fluid's aliases
(``elementwise_add`` ... ``transpose_``; ``creation``'s ``range_``,
``uniform_random``, ``gaussian`` and ``gaussian_random`` too), ``mode``,
the unary ``angle``/``conj``/``deg2rad``/``frac``/``rad2deg``, the
registry's ``register``, and ``Tensor``/``to_tensor``. Every public name
of ``paddle_tpu.ops`` resolves here but those of its ``sequence``,
``labeling``, ``detection`` and ``rcnn`` modules (ROADMAP Queue 1) and
its registry's internals (``OP_REGISTRY``, ``apply``,
``monkey_patch_tensor``).

``_METHODS`` is this package's copy of the reference's method table
(``paddle_tpu/ops/__init__.py:126-198``) and ``_DUNDERS``/``_SWAPPED``
of its operators (``_rops``, ``:31-71``), bound on ``core.tensor
.Tensor`` to this package's ops. Every public op here and in its module
is a ``core.tensor.boundary``: a Paddle ``Tensor`` reaches it as a plain
tensor and its result is one again (``creation``'s always); the
control-flow ops take their operands as they are, since they hand them
to the caller's functions."""
from .compare import (allclose, bitwise_and, bitwise_not, bitwise_or,
                      bitwise_xor, equal, equal_all, greater_equal,
                      greater_than, is_empty, is_tensor, isclose, less_equal,
                      less_than, logical_and, logical_not, logical_or,
                      logical_xor, not_equal)
from .activation import tanh
from .control_flow import case, cond, scan, switch_case, while_loop
from .creation import (arange, assign, bernoulli, clone, diagflat, empty,
                       empty_like, eye, fill_constant, full, full_like,
                       linspace, logspace, meshgrid, multinomial, normal,
                       ones, ones_like, rand, randint, randn, randperm,
                       standard_normal, tril, triu, uniform, zeros,
                       zeros_like)
from .linalg import (cholesky, cholesky_solve, corrcoef, cov, cross, det,
                     dist, eig, eigh, eigvals, eigvalsh, histogram, inverse,
                     lstsq, matrix_power, matrix_rank, multi_dot, mv, norm,
                     pinv, qr, slogdet, solve, svd, triangular_solve)
from .manipulation import (as_complex, as_real, argsort, bincount,
                           broadcast_to, cast, chunk, concat, expand,
                           expand_as, flatten, flip, gather, gather_nd,
                           index_sample, index_select, masked_fill,
                           masked_select, moveaxis, nonzero, one_hot, pad,
                           put_along_axis, repeat_interleave, reshape, roll,
                           rot90, scatter, scatter_nd, scatter_nd_add,
                           shard_index, slice, sort, split, squeeze, stack,
                           strided_slice, swapaxes, t, take_along_axis, tile,
                           topk, transpose, unbind, unique, unsqueeze, where)
from .math import (abs, acos, acosh, add, add_n, asin, asinh, atan, atan2,
                   atanh, bmm, ceil, clip, cos, cosh, cumprod, cumsum,
                   diag, diagonal, digamma, divide, dot, einsum, erf, erfinv,
                   exp, expm1, floor, floor_divide, increment, inner, isfinite,
                   isinf, isnan, kron, lerp, lgamma, log, log1p, log2, log10,
                   logaddexp, matmul, maximum, minimum, mm, mod, mul,
                   multiply, nan_to_num, neg, outer, pow, reciprocal,
                   remainder, round, rsqrt, scale, sign, sin, sinh, sqrt,
                   square, stanh, subtract, tan, trace, trunc)
from .reduction import (all, amax, amin, any, argmax, argmin, count_nonzero,
                        kthvalue, logsumexp, max, mean, median, min, mode_op,
                        nanmean, nansum, prod, quantile, std, sum, var)

__all__ = [
    # creation
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
    "tril", "triu", "meshgrid", "diagflat", "assign", "clone", "rand",
    "randn", "randint", "randperm", "uniform", "normal", "bernoulli",
    "multinomial", "standard_normal", "fill_constant",
    # math
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "matmul", "mm", "bmm", "dot", "outer", "inner", "scale",
    "clip", "add_n", "cumsum", "cumprod", "lerp", "einsum", "kron", "trace",
    "diag", "diagonal", "nan_to_num", "stanh", "exp", "expm1", "log",
    "log2", "log10", "log1p", "sqrt", "rsqrt", "abs", "neg", "floor",
    "ceil", "round", "trunc", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "asinh", "acosh", "atanh", "erf", "erfinv", "sign",
    "reciprocal", "square", "digamma", "lgamma", "isnan", "isinf",
    "isfinite", "maximum", "minimum", "atan2", "logaddexp", "increment",
    "mul",
    # reduction
    "sum", "mean", "max", "min", "prod", "all", "any", "logsumexp",
    "argmax", "argmin", "std", "var", "median", "quantile", "kthvalue",
    "mode_op", "count_nonzero", "nansum", "nanmean", "amax", "amin",
    # manipulation
    "reshape", "transpose", "t", "flatten", "squeeze", "unsqueeze",
    "concat", "stack", "split", "chunk", "unbind", "slice", "strided_slice",
    "gather", "gather_nd", "take_along_axis", "index_select",
    "index_sample", "scatter", "scatter_nd", "scatter_nd_add",
    "put_along_axis", "tile", "expand", "broadcast_to", "expand_as",
    "repeat_interleave", "flip", "roll", "pad", "where", "topk", "sort",
    "argsort", "one_hot", "cast", "nonzero", "masked_select", "unique",
    "masked_fill", "bincount", "moveaxis", "swapaxes", "rot90",
    "shard_index", "as_real", "as_complex",
    # compare
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "isclose", "allclose", "equal_all", "is_empty",
    "is_tensor",
    # activation
    "tanh",
    # linalg
    "norm", "dist", "cholesky", "inverse", "matrix_power", "pinv", "svd",
    "qr", "eig", "eigh", "eigvals", "eigvalsh", "matrix_rank", "det",
    "slogdet", "cross", "triangular_solve", "cholesky_solve", "solve",
    "lstsq", "histogram", "mv", "multi_dot", "cov", "corrcoef",
    # control flow
    "cond", "while_loop", "case", "switch_case", "scan",
]

# the JAX package's flat ``ops.*`` names this package's modules define
from ._base import register  # noqa: E402,F401
from .activation import (celu, elu, gelu, glu, gumbel_softmax,  # noqa: E402,F401
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         leaky_relu, log_sigmoid, log_softmax, logsigmoid,
                         maxout, mish, prelu, relu, relu6, selu, sigmoid,
                         silu, softmax, softplus, softshrink, softsign,
                         swish, tanhshrink, thresholded_relu)
from .conv import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: E402,F401
                   adaptive_max_pool1d, adaptive_max_pool2d,
                   adaptive_pool3d, affine_grid, avg_pool1d, avg_pool2d,
                   avg_pool3d, conv1d, conv1d_transpose, conv2d,
                   conv2d_transpose, conv3d, conv3d_transpose,
                   deformable_conv, grid_sample, grid_sampler, im2sequence,
                   image_resize, interpolate, max_pool1d, max_pool2d,
                   max_pool3d, pixel_shuffle, pixel_unshuffle, pool2d,
                   resize_bilinear, resize_nearest, resize_trilinear,
                   shuffle_channel, space_to_depth, unfold, upsample)
from .creation import (gaussian, gaussian_random, range_,  # noqa: E402,F401
                       uniform_random)
from .manipulation import reshape_, reverse, top_k, transpose_  # noqa: E402,F401
from .math import (angle, conj, deg2rad, elementwise_add,  # noqa: E402,F401
                   elementwise_div, elementwise_mul, elementwise_sub,
                   floor_mod, frac, rad2deg, sums)
from .misc import (add_position_encoding, affine_channel,  # noqa: E402,F401
                   bilinear_tensor_product, bpr_loss, brelu, center_loss,
                   clip_by_norm, cos_sim, crop_tensor, ctc_greedy_decoder,
                   dice_loss, fsp_matrix, gather_tree, hash, huber_loss,
                   margin_rank_loss, mean_iou, multiplex,
                   polygon_box_transform, rank_loss, sampling_id,
                   similarity_focus, soft_relu, teacher_student_sigmoid_loss,
                   temporal_shift, tree_conv, unique_with_counts, unstack)
from .norm_ops import (batch_norm, data_norm, group_norm,  # noqa: E402,F401
                       instance_norm, l2_normalize, layer_norm,
                       local_response_norm, lrn, normalize, spectral_norm)
from .random_ops import (alpha_dropout, channel_shuffle,  # noqa: E402,F401
                         dropout, dropout2d, dropout3d)
from .reduction import mode  # noqa: E402,F401
from ..core.tensor import Tensor, to_tensor  # noqa: E402,F401

# -- the Paddle ``Tensor``'s methods and the user-facing boundaries --------
from . import (activation as _a, compare as _cm, conv as _conv,  # noqa: E402
               creation as _cr, linalg as _la, manipulation as _mp,
               math as _m, misc as _misc, norm_ops as _norm,
               random_ops as _rand, reduction as _r)
from ..core import tensor as _tensor  # noqa: E402

# the reference's method table (``paddle_tpu/ops/__init__.py:126-198``),
# bound to this package's ops
_METHODS = dict(
    # math
    add=_m.add, subtract=_m.subtract, multiply=_m.multiply,
    divide=_m.divide, matmul=_m.matmul, mm=_m.mm, bmm=_m.bmm, dot=_m.dot,
    pow=_m.pow, exp=_m.exp, log=_m.log, log2=_m.log2, log10=_m.log10,
    log1p=_m.log1p, sqrt=_m.sqrt, rsqrt=_m.rsqrt, abs=_m.abs,
    floor=_m.floor, ceil=_m.ceil, round=_m.round, trunc=_m.trunc,
    sin=_m.sin, cos=_m.cos, tan=_m.tan, sinh=_m.sinh, cosh=_m.cosh,
    asin=_m.asin, acos=_m.acos, atan=_m.atan, erf=_m.erf, sign=_m.sign,
    reciprocal=_m.reciprocal, square=_m.square, scale=_m.scale,
    clip=_m.clip, cumsum=_m.cumsum, cumprod=_m.cumprod,
    maximum=_m.maximum, minimum=_m.minimum, remainder=_m.remainder,
    mod=_m.remainder, floor_divide=_m.floor_divide, kron=_m.kron,
    trace=_m.trace, diagonal=_m.diagonal, lerp=_m.lerp, isnan=_m.isnan,
    isinf=_m.isinf, isfinite=_m.isfinite, nan_to_num=_m.nan_to_num,
    neg=_m.neg,
    # reduction
    sum=_r.sum, mean=_r.mean, max=_r.max, min=_r.min, prod=_r.prod,
    all=_r.all, any=_r.any, argmax=_r.argmax, argmin=_r.argmin,
    std=_r.std, var=_r.var, median=_r.median, logsumexp=_r.logsumexp,
    quantile=_r.quantile, kthvalue=_r.kthvalue, mode=_r.mode,
    count_nonzero=_r.count_nonzero, nansum=_r.nansum, nanmean=_r.nanmean,
    # manipulation
    reshape=_mp.reshape, transpose=_mp.transpose, flatten=_mp.flatten,
    squeeze=_mp.squeeze, unsqueeze=_mp.unsqueeze, split=_mp.split,
    chunk=_mp.chunk, unbind=_mp.unbind, gather=_mp.gather,
    gather_nd=_mp.gather_nd, scatter=_mp.scatter, tile=_mp.tile,
    expand=_mp.expand, expand_as=_mp.expand_as,
    broadcast_to=_mp.broadcast_to, flip=_mp.flip, roll=_mp.roll,
    topk=_mp.topk, sort=_mp.sort, argsort=_mp.argsort,
    index_select=_mp.index_select, index_sample=_mp.index_sample,
    masked_select=_mp.masked_select, masked_fill=_mp.masked_fill,
    where=_mp.where, nonzero=_mp.nonzero, unique=_mp.unique,
    repeat_interleave=_mp.repeat_interleave, moveaxis=_mp.moveaxis,
    swapaxes=_mp.swapaxes, take_along_axis=_mp.take_along_axis,
    put_along_axis=_mp.put_along_axis,
    # activation
    tanh=_a.tanh, softmax=_a.softmax, sigmoid=_a.sigmoid, relu=_a.relu,
    # linalg
    norm=_la.norm, dist=_la.dist, cholesky=_la.cholesky,
    inverse=_la.inverse, matrix_power=_la.matrix_power, det=_la.det,
    slogdet=_la.slogdet, cross=_la.cross, solve=_la.solve, mv=_la.mv,
    pinv=_la.pinv,
    # compare
    equal=_cm.equal, not_equal=_cm.not_equal, less_than=_cm.less_than,
    less_equal=_cm.less_equal, greater_than=_cm.greater_than,
    greater_equal=_cm.greater_equal, logical_and=_cm.logical_and,
    logical_or=_cm.logical_or, logical_not=_cm.logical_not,
    logical_xor=_cm.logical_xor, isclose=_cm.isclose,
    allclose=_cm.allclose, equal_all=_cm.equal_all,
    bitwise_and=_cm.bitwise_and, bitwise_or=_cm.bitwise_or,
    bitwise_xor=_cm.bitwise_xor, bitwise_not=_cm.bitwise_not,
    # creation-ish
    zeros_like=_cr.zeros_like, ones_like=_cr.ones_like,
    full_like=_cr.full_like, tril=_cr.tril, triu=_cr.triu,
)

# the reference's operators (``_rops``, ``:31-71``)
_DUNDERS = dict(
    __add__=_m.add, __sub__=_m.subtract, __mul__=_m.multiply,
    __truediv__=_m.divide, __floordiv__=_m.floor_divide,
    __mod__=_m.remainder, __pow__=_m.pow, __matmul__=_m.matmul,
    __neg__=_m.neg, __abs__=_m.abs, __invert__=_cm.logical_not,
    __eq__=_cm.equal, __ne__=_cm.not_equal, __lt__=_cm.less_than,
    __le__=_cm.less_equal, __gt__=_cm.greater_than,
    __ge__=_cm.greater_equal, __and__=_cm.logical_and,
    __or__=_cm.logical_or, __xor__=_cm.logical_xor)
_SWAPPED = dict(
    __radd__=_m.add, __rsub__=_m.subtract, __rmul__=_m.multiply,
    __rtruediv__=_m.divide, __rfloordiv__=_m.floor_divide,
    __rmod__=_m.remainder, __rpow__=_m.pow, __rmatmul__=_m.matmul)

_tensor.bind_methods(_METHODS, _DUNDERS, _SWAPPED)


def _boundaries():
    """Every public op, here and in its module, as a ``boundary`` (see
    the module's doc)."""
    makers = set(_cr.__all__) | {"gaussian", "gaussian_random", "range_",
                                 "uniform_random"}
    for mod in (_a, _cm, _conv, _cr, _la, _mp, _m, _misc, _norm, _rand,
                _r):
        public = {getattr(mod, n) for n in mod.__all__
                  if callable(getattr(mod, n)) and
                  not isinstance(getattr(mod, n), type)}
        for n, v in list(vars(mod).items()):
            # the module's ops and their aliases (``range_`` = ``arange``)
            if not n.startswith("_") and callable(v) and v in public:
                setattr(mod, n, _tensor.boundary(v, make=mod is _cr))
    g = globals()
    skip = {"register", "Tensor", "to_tensor", "cond", "while_loop",
            "case", "switch_case", "scan"}
    for n, v in list(g.items()):
        if n.startswith("_") or n in skip or not callable(v) or \
                isinstance(v, type) or type(v).__name__ == "module":
            continue
        g[n] = _tensor.boundary(v, make=n in makers)


_boundaries()
