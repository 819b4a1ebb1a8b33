"""paddle_tpu_torch.models.nlp: the GPT decoder LM (training and
decoding), BERT (training), the WMT Transformer (translation and
beam-search decoding), the book's sentiment nets and word2vec."""
from .bert import (BertConfig, BertEmbeddings, BertForPretraining,
                   BertModel, bert_base, bert_pretrain_loss, bert_tiny)
from .gpt import (GPT, GPTAttention, GPTBlock, GPTConfig, gpt_loss,
                  gpt_small, gpt_tiny)
from .sentiment import ConvSentiment, StackedLSTMSentiment
from .transformer import WMTTransformer, position_encoding, wmt_loss
from .word2vec import NGramLM, SkipGram, skipgram_loss

__all__ = ["GPTConfig", "GPT", "GPTBlock", "GPTAttention", "gpt_loss",
           "gpt_tiny", "gpt_small", "BertConfig", "BertEmbeddings",
           "BertModel", "BertForPretraining", "bert_base", "bert_tiny",
           "bert_pretrain_loss", "WMTTransformer", "wmt_loss",
           "position_encoding", "ConvSentiment", "StackedLSTMSentiment",
           "NGramLM", "SkipGram", "skipgram_loss"]
