"""paddle_tpu_torch.ops: the hand-written kernels (``ops.kernels``) and the
ops of the ported paths that route to them or sit beside them
(``norm_ops.layer_norm``, ``random_ops.dropout``, ``activation.gelu``,
and ``conv``, ``norm_ops.batch_norm``, ``manipulation.flatten`` and
``reshape``, ``math.add`` and ``matmul``, ``activation.softmax`` and
``misc.dequantize_weight``, which have no kernel under them)."""
from .manipulation import flatten, reshape
from .math import add, matmul

__all__ = ["flatten", "reshape", "add", "matmul"]
