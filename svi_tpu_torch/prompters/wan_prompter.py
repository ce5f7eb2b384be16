"""Prompt processing for Wan (port of svi_tpu/prompters/wan_prompter.py).

The tokenizer is the port's sentencepiece engine (`sp_tokenizer`), loaded
from a local directory that holds `spiece.model` (google/umt5-xxl beside the
Wan checkpoints); the `transformers` branch of the JAX prompter is not
ported. Prompts are cleaned, tokenized, padded and truncated to 512 tokens,
and encoded by the umT5 encoder with the states past each prompt's length
zeroed.
"""

from __future__ import annotations

import html
import os
import re
from typing import Optional

import numpy as np
import torch

from .sp_tokenizer import T5SpTokenizer


def basic_clean(text: str) -> str:
    """ftfy.fix_text where ftfy is installed, then html unescape (twice)."""
    try:
        import ftfy
    except ImportError:
        pass
    else:
        text = ftfy.fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class WanPrompter:
    """Tokenize (pad / truncate to text_len) and encode prompts."""

    def __init__(self, tokenizer_path: Optional[str] = None, text_len: int = 512):
        self.text_len = text_len
        self.tokenizer = None
        self.text_encoder = None  # models.t5.T5Encoder
        if tokenizer_path is not None:
            self.fetch_tokenizer(tokenizer_path)

    def fetch_tokenizer(self, tokenizer_path: str):
        if not os.path.isfile(os.path.join(tokenizer_path, "spiece.model")):
            raise FileNotFoundError(
                f"no spiece.model in {tokenizer_path}: the port loads umT5's sentencepiece "
                "model only (the transformers tokenizer branch is not ported)")
        self.tokenizer = T5SpTokenizer(tokenizer_path)

    def fetch_models(self, text_encoder):
        self.text_encoder = text_encoder

    def tokenize(self, prompt: str) -> tuple[np.ndarray, np.ndarray]:
        """-> ids and attention mask, (1, text_len) int32 each."""
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer loaded: fetch_tokenizer(<dir with spiece.model>) "
                               "first, or pass prompt embeddings to the pipeline")
        prompt = whitespace_clean(basic_clean(prompt))
        enc = self.tokenizer([prompt], max_length=self.text_len)
        return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)

    def encode_prompt(self, prompt: str, positive: bool = True) -> torch.Tensor:
        """-> (1, text_len, dim) umT5 states, zero past the prompt's length, on
        the text encoder's device."""
        if self.text_encoder is None:
            raise RuntimeError("no text encoder: fetch_models(T5Encoder) first")
        ids, mask = self.tokenize(prompt)
        dev = next(self.text_encoder.parameters()).device
        return self.text_encoder.encode_prompt_states(torch.from_numpy(ids).to(dev),
                                                      torch.from_numpy(mask).to(dev))
