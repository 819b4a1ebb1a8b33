"""paddle_tpu_torch.static — static (Program/Executor) mode.

The counterpart of ``paddle_tpu/static_`` (ref: ``paddle.static`` /
fluid's graph mode, ``python/paddle/fluid/{framework,executor,compiler,
backward}.py``). While static mode is on, the port's registry ops and
the torch calls on a Program's Variables record into the default
Program (``program.ProgramRecorder``) instead of running;
``Executor.run`` replays the recorded program on the card, one CUDA
graph per cache key.
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
           "in_static_mode"]


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
