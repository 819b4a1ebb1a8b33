"""paddle_tpu_torch.amp: automatic mixed precision.

The counterparts of ``paddle_tpu/amp/{__init__,autocast,lists,
grad_scaler,static_decorator}.py``: ``auto_cast`` (level O1, casting at
the registered ops by the white and black lists), ``decorate`` (level
O2: the model in the half type, float32 masters in the optimizer; O1
casts nothing), the loss scalers, and ``static_decorator.decorate``,
static-graph AMP (fluid's ``mixed_precision.decorate``).
"""
import torch

from .._device import resolve_dtype
from ..optim.optimizer import Optimizer
from .autocast import amp_guard, amp_state, auto_cast, cast_op_inputs
from .grad_scaler import DynamicLossScaler, GradScaler, StaticLossScaler
from .lists import BLACK_LIST, WHITE_LIST, AutoMixedPrecisionLists

__all__ = ["auto_cast", "amp_guard", "amp_state", "cast_op_inputs",
           "decorate", "AutoMixedPrecisionLists", "WHITE_LIST",
           "BLACK_LIST", "StaticLossScaler", "DynamicLossScaler",
           "GradScaler"]


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate`` (``paddle_tpu/amp/__init__.py``:20-54). At
    O2: cast each model's parameters and buffers to ``dtype`` (in place:
    the optimizers keep the same parameters) and turn on each optimizer's
    ``multi_precision``; unless ``master_weight`` is False, drop each
    optimizer's state so that float32 masters are made from the cast
    parameters at the next step. At O1 nothing is cast (``auto_cast``
    does the work). Returns the models (and the optimizers) nested as
    they were passed."""
    if level not in ("O1", "O2"):
        raise ValueError(f"level must be O1 or O2, got {level}")
    single_model = isinstance(models, torch.nn.Module)
    model_list = [models] if single_model else list(models or [])
    single_opt = isinstance(optimizers, Optimizer)
    opt_list = [optimizers] if single_opt else list(optimizers or [])
    if level == "O2":
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
