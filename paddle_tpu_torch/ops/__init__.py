"""paddle_tpu_torch.ops: the hand-written kernels (``ops.kernels``)."""
