"""paddle_tpu_torch.ops: the hand-written kernels (``ops.kernels``) and the
ops of the ported paths that route to them or sit beside them
(``norm_ops.layer_norm``, ``random_ops.dropout``, ``activation.gelu``,
and ``conv``, ``norm_ops``' other norms, ``manipulation``'s shape ops,
``reduction``'s ``max``/``min``/``mean``, ``math.add`` and ``matmul``,
``activation``'s others and ``misc.dequantize_weight``, which have no
kernel under them). The top-level tensor API comes with its own slice."""
from .manipulation import (concat, flatten, pad, reshape, split, squeeze,
                           stack, transpose, unsqueeze)
from .math import add, matmul
from .reduction import amax, amin, max, mean, min

__all__ = ["flatten", "reshape", "transpose", "concat", "split", "stack",
           "squeeze", "unsqueeze", "pad", "add", "matmul", "max", "amax",
           "min", "amin", "mean"]
