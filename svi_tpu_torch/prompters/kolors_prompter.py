"""Kolors prompter, port of svi_tpu/prompters/kolors_prompter.py: ChatGLM
tokenization to 256 left-padded tokens (`models.kolors.kolors_tokenize`,
the vendored BPE model by default) and ChatGLM3's encoding; the pooled
embedding is the last token's final pre-norm state, the prompt embedding the
hidden state `clip_skip_2` from the end."""

from __future__ import annotations

import torch

from ..models import kolors


class KolorsPrompter:
    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer

    def encode_prompt(self, chatglm_params, _unused, prompt, clip_skip=1, clip_skip_2=2,
                      max_length=256):
        """(pooled (1, 4096), prompt_emb (1, max_length, 4096)) on the
        encoder's device; the second argument (SDXL's second text encoder)
        and clip_skip are unused, as in the JAX package."""
        if self.tokenizer is None:
            from .sp_tokenizer import default_chatglm_tokenizer

            self.tokenizer = default_chatglm_tokenizer()
        ids, mask, pos = kolors.kolors_tokenize(prompt, self.tokenizer, max_length)
        dev = chatglm_params["word_embeddings"].device
        return kolors.kolors_encode_prompt(
            chatglm_params, *(torch.from_numpy(a).to(dev) for a in (ids, mask, pos)),
            clip_skip_2=clip_skip_2)
