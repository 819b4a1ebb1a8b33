"""paddle_tpu_torch.models: the ported models (``nlp``: GPT, BERT, the
WMT Transformer; ``vision``: ResNet)."""
