"""paddle_tpu_torch's VGG-11 training step against the JAX package's
on the CPU (``torch_vision_parity``: the sizes, references and limits).
"""
from torch_vision_parity import jax_runs, parity_tests, port_once  # noqa: F401

from torch_test_threads import torch_threads  # noqa: F401,E402

# VGG-11's few large ops run faster on every thread (torch_test_threads)
TORCH_THREADS = None

(test_logits_match, test_every_gradient_matches,
 test_batch_norm_buffers_after_one_step,
 test_train_step_trajectory_matches) = parity_tests("vgg11")
