"""paddle_tpu_torch.nn.layers: every class of the JAX package's
``nn/layers/{activation,common,conv,pooling,norm,loss,rnn,transformer}.py``."""
from . import activation as _activation, common as _common, conv as _conv
from . import loss as _loss, norm as _norm, pooling as _pooling
from . import rnn as _rnn, transformer as _transformer
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = sorted({n for m in (_activation, _common, _conv, _loss, _norm,
                              _pooling, _rnn, _transformer)
                  for n in m.__all__})
