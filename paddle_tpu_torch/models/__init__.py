"""paddle_tpu_torch.models: the ported models (``nlp``: GPT, BERT, the
WMT Transformer, the sentiment nets, word2vec; ``vision``: ResNet,
LeNet; ``rec``: the two-tower recommender and DeepFM)."""
