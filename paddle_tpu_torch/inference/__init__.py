"""paddle_tpu_torch.inference: the decode library.

The counterpart of ``paddle_tpu/inference``'s decode names
(``decoder.py``): ``dynamic_decode``, ``BeamSearchDecoder``,
``beam_search``/``beam_search_xla`` and ``greedy_search``. Not ported
yet: the predictor (``Config``, ``Predictor``, ``create_predictor``) and
the analysis API, which need ``framework/io.load_inference_model`` and
the static program.
"""
from .decoder import (BeamSearchDecoder, Decoder, beam_search,
                      beam_search_xla, dynamic_decode, gather_beams,
                      greedy_search, tile_beam)

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode",
           "beam_search", "beam_search_xla", "greedy_search", "tile_beam",
           "gather_beams"]
