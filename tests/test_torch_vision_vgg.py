"""paddle_tpu_torch's VGG-11 training step against the JAX package's
on the CPU (``torch_vision_parity``: the sizes, references and limits).
"""
from torch_vision_parity import jax_runs, parity_tests, port_once  # noqa: F401

(test_logits_match, test_every_gradient_matches,
 test_batch_norm_buffers_after_one_step,
 test_train_step_trajectory_matches) = parity_tests("vgg11")
