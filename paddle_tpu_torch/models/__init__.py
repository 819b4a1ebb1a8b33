"""paddle_tpu_torch.models: the ported models (``nlp.gpt``)."""
