"""paddle_tpu_torch.ops: the hand-written kernels (``ops.kernels``) and the
ops of the ported paths that route to them or sit beside them
(``norm_ops.layer_norm``, ``random_ops.dropout``, ``activation.gelu``,
and ``conv``, ``norm_ops.batch_norm`` and ``manipulation.flatten``,
which have no kernel under them)."""
from .manipulation import flatten

__all__ = ["flatten"]
