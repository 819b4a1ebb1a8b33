"""paddle_tpu_torch.core: the dtype names (``dtype``), places
(``device``), ``Tensor``/``Parameter``/``to_tensor`` (``tensor``), the
grad modes and ``grad`` (``autograd``) and the global random state
(``random``)."""
from . import autograd, device, dtype, random, tensor
from .autograd import enable_grad, grad, is_grad_enabled, no_grad
from .random import default_generator, seed
from .tensor import Parameter, Tensor, to_tensor

__all__ = ["dtype", "device", "random", "tensor", "autograd", "Tensor",
           "Parameter", "to_tensor", "no_grad", "enable_grad",
           "is_grad_enabled", "grad", "seed", "default_generator"]
