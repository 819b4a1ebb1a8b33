"""paddle_tpu_torch.amp: the loss scalers and ``decorate`` at level O2.

The counterparts of ``paddle_tpu/amp/{__init__,grad_scaler}.py``.
``auto_cast`` (O1) and ``static_decorator`` are not ported: they hook
the JAX package's op dispatch, which the port does not have.
"""
import torch

from .._device import resolve_dtype
from ..optim.optimizer import Optimizer
from .grad_scaler import DynamicLossScaler, GradScaler, StaticLossScaler

__all__ = ["decorate", "StaticLossScaler", "DynamicLossScaler",
           "GradScaler"]


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate`` at level O2 (``paddle_tpu/amp/__init__.py``
    :20-54): cast each model's parameters and buffers to ``dtype`` (in
    place: the optimizers keep the same parameters) and turn on each
    optimizer's ``multi_precision``; unless ``master_weight`` is False,
    drop each optimizer's state so that float32 masters are made from the
    cast parameters at the next step. Returns the models (and the
    optimizers) nested as they were passed. Level O1 is ``auto_cast``'s,
    which is not ported: it raises."""
    if level == "O1":
        raise NotImplementedError("amp level O1 needs auto_cast, which "
                                  "paddle_tpu_torch does not port")
    if level != "O2":
        raise ValueError(f"level must be O1 or O2, got {level}")
    single_model = isinstance(models, torch.nn.Module)
    model_list = [models] if single_model else list(models or [])
    single_opt = isinstance(optimizers, Optimizer)
    opt_list = [optimizers] if single_opt else list(optimizers or [])
    for m in model_list:
        m.to(dtype=resolve_dtype(dtype))
    for o in opt_list:
        o._multi_precision = True
        if master_weight is not False:
            for name, _ in o._named_params:
                o._accumulators.pop(name, None)
    models_out = model_list[0] if single_model else model_list
    opts_out = opt_list[0] if single_opt else opt_list
    if optimizers is None:
        return models_out
    return models_out, opts_out
