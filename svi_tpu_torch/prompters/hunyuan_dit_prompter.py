"""Hunyuan-DiT prompter, port of svi_tpu/prompters/hunyuan_dit_prompter.py:
the Chinese BERT CLIP-like encoder over 77 tokens and mT5 over 256, each
with its attention mask, for the DiT's learned-padding merge.

The two encoders are caller-supplied callables, as in the JAX package:
`bert_model(input_ids, attention_mask, clip_skip=...)` and
`t5_model(input_ids, attention_mask, clip_skip=...)` on torch CPU tensors
(transformers' BertModel / T5EncoderModel wrappers in the reference). The
BERT tokenizer defaults to the vendored WordPiece vocab
(`sp_tokenizer.default_bert_tokenizer`); the mT5 tokenizer is the caller's.
"""

from __future__ import annotations

import torch

from .base_prompter import BasePrompter


class HunyuanDiTPrompter(BasePrompter):
    """encode_prompt -> (text_emb, mask, text_emb_t5, mask_t5) numpy arrays."""

    def __init__(self, bert_model=None, bert_tokenizer=None, t5_model=None, t5_tokenizer=None):
        super().__init__()
        self.bert_model = bert_model
        self.bert_tokenizer = bert_tokenizer
        self.t5_model = t5_model
        self.t5_tokenizer = t5_tokenizer

    def fetch_models(self, bert_model=None, t5_model=None):
        self.bert_model = bert_model
        self.t5_model = t5_model

    def encode_prompt(self, prompt, clip_skip=1, clip_skip_2=1, positive=True):
        prompt = self.process_prompt(prompt, positive=positive)
        if self.bert_tokenizer is None:  # the vendored WordPiece vocab
            from .sp_tokenizer import default_bert_tokenizer

            self.bert_tokenizer = default_bert_tokenizer()
        with torch.no_grad():
            ti = self.bert_tokenizer(prompt, padding="max_length", max_length=77,
                                     truncation=True, return_tensors="pt")
            emb = self.bert_model(ti.input_ids, ti.attention_mask, clip_skip=clip_skip)
            t5i = self.t5_tokenizer(prompt, padding="max_length", max_length=256,
                                    truncation=True, return_tensors="pt")
            emb_t5 = self.t5_model(t5i.input_ids, t5i.attention_mask, clip_skip=clip_skip_2)
        return (emb.float().cpu().numpy(), ti.attention_mask.numpy(),
                emb_t5.float().cpu().numpy(), t5i.attention_mask.numpy())

    # the pipeline calls the wrapper directly
    __call__ = encode_prompt
