"""paddle_tpu_torch.models.nlp: the GPT decoder LM (training path)."""
from .gpt import (GPT, GPTAttention, GPTBlock, GPTConfig, gpt_loss,
                  gpt_small, gpt_tiny)

__all__ = ["GPTConfig", "GPT", "GPTBlock", "GPTAttention", "gpt_loss",
           "gpt_tiny", "gpt_small"]
