"""paddle_tpu_torch.inference: the Predictor and the decode library.

The counterpart of ``paddle_tpu/inference``: ``Config``, ``Predictor``
and ``create_predictor`` (``predictor.py``: a saved inference bundle
replayed as one CUDA graph per feed signature), the fluid-era
``AnalysisConfig``/``AnalysisPredictor`` API with zero-copy tensors
(``analysis.py``), and the decode names (``decoder.py``):
``dynamic_decode``, ``BeamSearchDecoder``, ``beam_search``/
``beam_search_xla`` and ``greedy_search``.
"""
from .analysis import (AnalysisConfig, AnalysisPredictor, PaddleTensor,
                       ZeroCopyTensor, create_paddle_predictor)
from .decoder import (BeamSearchDecoder, Decoder, beam_search,
                      beam_search_xla, dynamic_decode, gather_beams,
                      greedy_search, tile_beam)
from .predictor import Config, Predictor, create_predictor

__all__ = ["Config", "Predictor", "create_predictor",
           "AnalysisConfig", "AnalysisPredictor", "PaddleTensor",
           "ZeroCopyTensor", "create_paddle_predictor",
           "Decoder", "BeamSearchDecoder", "dynamic_decode",
           "beam_search", "beam_search_xla", "greedy_search", "tile_beam",
           "gather_beams"]
