"""CogVideoX prompter, port of svi_tpu/prompters/cog_prompter.py: T5 ids
padded to 226 tokens (the vendored spiece model in the HF fast pipeline
unless a tokenizer is given), encoded by the port's T5 encoder with no
attention mask, reshaped to (1, n * 226, dim); the refiner chain of
`BasePrompter` on the positive branch."""

from __future__ import annotations

import torch

from .base_prompter import BasePrompter
from .sd3_prompter import t5_states


class CogPrompter(BasePrompter):
    """`t5` is a (T5Encoder, cfg, tokenizer) triple (tokenizer None: the
    vendored T5 model)."""

    def __init__(self, t5=None):
        super().__init__()
        self.t5 = t5

    def fetch_models(self, t5=None):
        self.t5 = t5

    @torch.no_grad()
    def encode_prompt(self, prompt, positive=True, max_length=226, dtype=torch.bfloat16):
        prompt = self.process_prompt(prompt, positive=positive)
        return t5_states(self.t5, prompt, max_length).to(dtype)
