"""paddle_tpu_torch's MobileNetV2 training step against the JAX package's
on the CPU (``torch_vision_parity``: the sizes, references and limits).
"""
import pytest

from torch_vision_parity import (jax_runs, one_torch_thread,  # noqa: F401
                                 parity_tests, port_once)

from torch_test_threads import torch_threads  # noqa: F401,E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


(test_logits_match, test_every_gradient_matches,
 test_batch_norm_buffers_after_one_step,
 test_train_step_trajectory_matches) = parity_tests("mobilenet_v2")
