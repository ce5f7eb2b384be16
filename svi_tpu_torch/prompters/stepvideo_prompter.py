"""StepVideo prompter, port of svi_tpu/prompters/stepvideo_prompter.py: the
bilingual CLIP-BERT branch (77 tokens, 1024 wide) and the Step1 LLM branch
(320 tokens, 6144 wide); the LLM's mask is left-padded with ones over the
CLIP tokens.

`clip_encoder([prompt]) -> (B, 77, 1024)` and `tokenizer(str) -> list[int]`
(a sentencepiece processor's encode_as_ids) are the caller's callables, as
in the JAX package; the LLM branch is the port's `step1_encode` on the
device of `step1_params`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import stepvideo as sv


class StepVideoPrompter:
    """__call__ -> (clip_embeds, llm_embeds, mask): f32 numpy arrays and an
    int32 mask (B, 77 + 320)."""

    def __init__(self, clip_encoder=None, step1_params=None, tokenizer=None, num_heads=64,
                 num_groups=8, dtype=torch.bfloat16):
        self.clip_encoder = clip_encoder
        self.step1_params = step1_params
        self.tokenizer = tokenizer
        self.num_heads = num_heads
        self.num_groups = num_groups
        self.dtype = dtype

    @torch.no_grad()
    def __call__(self, prompt, max_length=320):
        clip_embeds = self.clip_encoder([prompt])
        if isinstance(clip_embeds, torch.Tensor):
            clip_embeds = clip_embeds.float().cpu().numpy()
        clip_embeds = np.asarray(clip_embeds)
        ids, mask = sv.step1_tokenize([prompt], self.tokenizer, max_length)
        llm_embeds = sv.step1_encode(self.step1_params, ids, self.num_heads, self.num_groups,
                                     dtype=self.dtype)
        full_mask = np.concatenate(
            [np.ones((mask.shape[0], clip_embeds.shape[1]), mask.dtype), mask], axis=1)
        return clip_embeds, llm_embeds.float().cpu().numpy(), full_mask
