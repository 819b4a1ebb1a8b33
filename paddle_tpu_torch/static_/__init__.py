"""paddle_tpu_torch.static — static (Program/Executor) mode.

The counterpart of ``paddle_tpu/static_`` (ref: ``paddle.static`` /
fluid's graph mode, ``python/paddle/fluid/{framework,executor,compiler,
backward}.py``). While static mode is on, the port's registry ops and
the torch calls on a Program's Variables record into the default
Program (``program.ProgramRecorder``) instead of running;
``Executor.run`` replays the recorded program on the card, one CUDA
graph per cache key.

``ProgramTracer`` is the JAX package's name for the recorder
(``ProgramRecorder``), and ``create_parameter`` makes a parameter
Variable of the default main program. The JAX package's ``static.nn``
builders come from ``fluid.layers``, which is not ported (ROADMAP
Queue 1, item 10).
"""
from ..ops import _base
from .backward import append_backward, gradients  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .executor import CacheKey, Executor, build_optimize_ops  # noqa: F401
from .program import (  # noqa: F401
    Block, Operator, Program, ProgramRecorder, Scope, Variable, data,
    default_main_program, default_startup_program, global_scope,
    name_scope, program_guard, scope_guard)

__all__ = ["Variable", "Operator", "Block", "Program", "program_guard",
           "default_main_program", "default_startup_program", "data",
           "Scope", "global_scope", "scope_guard", "name_scope",
           "append_backward", "gradients", "CacheKey", "Executor",
           "build_optimize_ops", "CompiledProgram", "BuildStrategy",
           "ExecutionStrategy", "enable_static", "disable_static",
           "in_static_mode", "ProgramTracer", "create_parameter"]

ProgramTracer = ProgramRecorder


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """``paddle.static.create_parameter``: a parameter of ``shape`` and
    ``dtype``, named ``name`` (else by ``attr``, else generated), as
    ``nn.create_parameter`` makes it; a bias starts at zero. In static
    mode a persistable Variable of the default main program, its value
    in the global scope."""
    from ..nn.layers.common import create_parameter as _create
    from ..nn.param_attr import ParamAttr

    attr = ParamAttr._to_attr(attr)
    if name is not None and attr is not False:
        attr.name = name
    return _create(shape, attr, is_bias=is_bias,
                   default_initializer=default_initializer, dtype=dtype)


def enable_static():
    """Switch the process into static-graph mode (ref:
    ``paddle.enable_static``): record into the default main program."""
    if _base.RECORDER[0] is not None:
        return
    rec = ProgramRecorder()
    rec.__enter__()
    _base.RECORDER[0] = rec


def disable_static():
    rec = _base.RECORDER[0]
    if rec is not None:
        _base.RECORDER[0] = None
        rec.__exit__(None, None, None)


def in_static_mode():
    return _base.RECORDER[0] is not None
