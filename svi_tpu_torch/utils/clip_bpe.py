"""open_clip's CLIP BPE tokenizer (`SimpleTokenizer`), port of
svi_tpu/utils/clip_bpe.py.

It shares the byte-level BPE core of `prompters.clip_tokenizer` (one
vocabulary, the same merges file and ids) and differs only at the edges, as
open_clip's tokenizer does: HTML entities unescaped twice and whitespace
collapsed before lowercasing (no NFC), the specials spelled
`<start_of_text>` / `<end_of_text>`, and a (B, 77) int32 array with the EOT
token kept in the last slot of a truncated prompt. Used by the CLIPScore and
HPSv2 metrics (`extensions/image_quality.py`).
"""

from __future__ import annotations

import html
import re

import numpy as np

from ..prompters.clip_tokenizer import ClipBpeTokenizer

SOT, EOT = "<start_of_text>", "<end_of_text>"


class SimpleTokenizer(ClipBpeTokenizer):
    """bpe_path: a gzip'd (or plain) merges list, by default the port's own
    `tokenizer_configs/clip_merges.txt.gz`."""

    def __init__(self, bpe_path: str | None = None, context_length: int = 77):
        super().__init__(merges_path=bpe_path)
        self.context_length = context_length
        self.sot, self.eot = self.bos_token_id, self.eos_token_id

    def encode(self, text: str) -> list:
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids = []
        for k, part in enumerate(re.split(f"({SOT}|{EOT})", text)):
            if k % 2:  # a special spelled out in the text
                ids.append(self.sot if part == SOT else self.eot)
                continue
            for token in self._findall(part):
                token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        """-> (B, context_length) int32: sot, the ids, eot, zero padding."""
        if isinstance(texts, str):
            texts = [texts]
        n = context_length or self.context_length
        out = np.zeros((len(texts), n), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > n:
                ids = ids[:n]
                ids[-1] = self.eot
            out[i, :len(ids)] = ids
        return out
