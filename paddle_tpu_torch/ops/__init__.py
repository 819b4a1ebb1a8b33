"""paddle_tpu_torch.ops: the hand-written kernels (``ops.kernels``) and the
ops of the ported paths that route to them or sit beside them
(``norm_ops.layer_norm``, ``random_ops.dropout``, ``activation.gelu``)."""
