"""Prompt utilities shared by the prompters, port of
svi_tpu/prompters/base_prompter.py: `tokenize_long_prompt` (tokenize
unbounded, then again padded to a multiple of the 77-token window) and
`BasePrompter` (the refiner / extender chain: each class named is built by
its `from_model_manager`, e.g. `prompt_refiners.BeautifulPrompt`,
`prompt_refiners.Translator`, `omost.OmostPromter`).
"""

from __future__ import annotations

import numpy as np


def tokenize_long_prompt(tokenizer, prompt: str, length: int = 77) -> np.ndarray:
    """(num_sentence, length) int64 ids: the prompt tokenized unbounded, its
    length rounded up to a multiple of `length`, then tokenized again padded
    to that length."""
    tokenizer.model_max_length = 99999999
    ids = tokenizer(prompt, return_tensors="np").input_ids
    max_length = (ids.shape[1] + length - 1) // length * length
    tokenizer.model_max_length = length
    ids = tokenizer(prompt, return_tensors="np", padding="max_length",
                    max_length=max_length, truncation=True).input_ids
    return ids.reshape(ids.shape[1] // length, length)


class BasePrompter:
    """Refiners map prompt -> prompt (the positive branch only), extenders a
    prompt dict -> an enriched dict (regional prompts)."""

    def __init__(self):
        self.refiners = []
        self.extenders = []

    def load_prompt_refiners(self, model_manager, refiner_classes=()):
        for refiner_class in refiner_classes:
            self.refiners.append(refiner_class.from_model_manager(model_manager))

    def load_prompt_extenders(self, model_manager, extender_classes=()):
        for extender_class in extender_classes:
            self.extenders.append(extender_class.from_model_manager(model_manager))

    def process_prompt(self, prompt, positive=True):
        if isinstance(prompt, list):
            return [self.process_prompt(p, positive=positive) for p in prompt]
        for refiner in self.refiners:
            prompt = refiner(prompt, positive=positive)
        return prompt

    def extend_prompt(self, prompt: str, positive=True):
        extended = dict(prompt=prompt)
        for extender in self.extenders:
            extended = extender(extended)
        return extended
