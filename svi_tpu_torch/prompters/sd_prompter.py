"""SD 1.5 prompter, port of svi_tpu/prompters/sd_prompter.py: the CLIP
tokenizer, prompts of any length encoded in 77-token chunks and flattened
back to (1, n * 77, 768), textual-inversion pseudo-tokens, and the
BasePrompter chain.
"""

from __future__ import annotations

import torch

from ..models import sd
from . import textual_inversion as ti
from .base_prompter import BasePrompter, tokenize_long_prompt


class SDPrompter(BasePrompter):
    def __init__(self, tokenizer=None):
        super().__init__()
        self.tokenizer = tokenizer  # a ClipBpeTokenizer, or a transformers CLIPTokenizer
        self.textual_inversion_dict = {}
        self.keyword_dict = {}
        # (base token table, extended table): the extended one is rebuilt
        # when the encoder's table is another tensor
        self._extended = None

    def _ensure_tokenizer(self):
        if self.tokenizer is None:
            from .clip_tokenizer import ClipBpeTokenizer

            self.tokenizer = ClipBpeTokenizer()
        return self.tokenizer

    def load_textual_inversions(self, model_paths, embedding_dim=768):
        """Register each file's `<stem>_<i>` pseudo-tokens with the tokenizer;
        the encoder's token table is extended at encode time."""
        self.textual_inversion_dict = ti.load_textual_inversion_dict(model_paths, embedding_dim)
        tok = self._ensure_tokenizer()
        for tokens, _ in self.textual_inversion_dict.values():
            tok.add_tokens(tokens)
        self.keyword_dict = ti.keyword_replacements(self.textual_inversion_dict)
        self._extended = None

    def _token_table(self, text_encoder):
        base = text_encoder["token_embedding"]
        if not self.textual_inversion_dict:
            return base
        if self._extended is None or self._extended[0] is not base:
            self._extended = (base, ti.extend_token_embedding(base, self.textual_inversion_dict))
        return self._extended[1]

    @torch.no_grad()
    def encode_prompt(self, text_encoder, prompt: str, clip_skip: int = 1,
                      positive: bool = True) -> torch.Tensor:
        prompt = self.process_prompt(prompt, positive=positive)
        for keyword, replacement in self.keyword_dict.items():
            if keyword in prompt:
                prompt = prompt.replace(keyword, replacement)
        ids = tokenize_long_prompt(self._ensure_tokenizer(), prompt)
        ids = torch.from_numpy(ids).to(text_encoder["token_embedding"].device)
        emb = sd.sd_text_encoder_forward(text_encoder, ids, clip_skip=clip_skip,
                                         token_embedding=self._token_table(text_encoder))
        return emb.reshape(1, emb.shape[0] * emb.shape[1], -1)
