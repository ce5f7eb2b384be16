"""SDXL prompter, port of svi_tpu/prompters/sdxl_prompter.py: two CLIP
tokenizers (the second pads with "!", as bigG's does), prompts of any length
encoded in 77-token chunks by both text encoders, their hidden states
concatenated (768 + 1280 = 2048 wide) and the pooled embedding taken from
the first chunk. `clip_skip` / `clip_skip_2` pick each encoder's layer.
"""

from __future__ import annotations

import torch

from ..models import sdxl
from .base_prompter import tokenize_long_prompt


class SDXLPrompter:
    def __init__(self, tokenizer=None, tokenizer_2=None):
        self.tokenizer = tokenizer
        self.tokenizer_2 = tokenizer_2

    def _ensure_tokenizers(self):
        from .clip_tokenizer import ClipBpeTokenizer

        if self.tokenizer is None:
            self.tokenizer = ClipBpeTokenizer()
        if self.tokenizer_2 is None:
            self.tokenizer_2 = ClipBpeTokenizer(pad_token="!")

    @torch.no_grad()
    def encode_prompt(self, text_encoder, text_encoder_2, prompt, clip_skip=1, clip_skip_2=2):
        """-> (pooled (1, 1280), embeddings (1, n * 77, 2048))."""
        self._ensure_tokenizers()
        dev = text_encoder["token_embedding"].device
        ids = torch.from_numpy(tokenize_long_prompt(self.tokenizer, prompt)).to(dev)
        emb1 = sdxl.sdxl_text_encoder_forward(text_encoder, ids, clip_skip=clip_skip)
        ids2 = torch.from_numpy(tokenize_long_prompt(self.tokenizer_2, prompt)).to(dev)
        pooled, emb2 = sdxl.sdxl_text_encoder_2_forward(text_encoder_2, ids2,
                                                        clip_skip=clip_skip_2)
        n = min(emb1.shape[0], emb2.shape[0])
        emb = torch.cat([emb1[:n], emb2[:n]], -1)
        return pooled[0:1], emb.reshape(1, n * emb.shape[1], -1)
