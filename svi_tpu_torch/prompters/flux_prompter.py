"""FLUX prompter, port of svi_tpu/prompters/flux_prompter.py: CLIP-L's pooled
embedding (SD3's first text encoder) of a 77-token window and T5-XXL's
sequence embedding at `t5_sequence_length` tokens (512 by default)."""

from __future__ import annotations

import torch

from ..models import sd3
from .sd3_prompter import t5_states


class FluxPrompter:
    def __init__(self, tokenizer=None, t5_tokenizer=None):
        self.tokenizer = tokenizer
        self.t5_tokenizer = t5_tokenizer

    @torch.no_grad()
    def encode_prompt(self, te1_params, t5, prompt, t5_sequence_length=512):
        """(prompt_emb (1, t5_sequence_length, 4096), pooled (1, 768)); t5 is
        a (T5Encoder, cfg, tokenizer) triple."""
        if self.tokenizer is None:
            from .clip_tokenizer import ClipBpeTokenizer

            self.tokenizer = ClipBpeTokenizer()
        ids = self.tokenizer(prompt, return_tensors="np", padding="max_length", max_length=77,
                             truncation=True).input_ids
        pooled, _ = sd3.sd3_text_encoder_1_forward(
            te1_params, torch.from_numpy(ids).to(te1_params["token_embedding"].device))
        return t5_states(t5, prompt, t5_sequence_length), pooled
