"""CLIP's byte-level BPE tokenizer, port of svi_tpu/prompters/clip_tokenizer.py.

transformers.CLIPTokenizer's behaviour without transformers or ftfy: NFC,
whitespace collapse and lowercase, the CLIP pre-tokenizer regex, byte-level
BPE with </w> word ends, bos 49406 / eos 49407, padding to max_length and
truncation that keeps the eos; `add_tokens` registers textual-inversion
pseudo-tokens that match verbatim. Every CLIP text tower of the SD families
shares this one vocabulary, derived from the gzip'd merges list
`svi_tpu_torch/tokenizer_configs/clip_merges.txt.gz` (256 bytes, 256 bytes
with </w>, the merges, the two specials).
"""

from __future__ import annotations

import gzip
import os
import unicodedata
from types import SimpleNamespace

import numpy as np
import torch

_MERGES_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tokenizer_configs", "clip_merges.txt.gz")

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"


def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    """transformers CLIPTokenizer's ftfy path (`whitespace_clean(fix_text(
    text)).lower()`); ftfy's fix_text on well-formed text is NFC."""
    text = unicodedata.normalize("NFC", text)
    return " ".join(text.split()).lower()


class ClipBpeTokenizer:
    """The transformers.CLIPTokenizer call surface that
    `base_prompter.tokenize_long_prompt` and the prompters use."""

    def __init__(self, merges_path: str | None = None,
                 pad_token: str = EOS, model_max_length: int = 77):
        self.model_max_length = model_max_length
        self.byte_encoder = _bytes_to_unicode()
        path = merges_path or _MERGES_PATH
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        chars = list(self.byte_encoder.values())
        vocab = chars + [c + "</w>" for c in chars]
        vocab += ["".join(m) for m in merges]
        vocab += [BOS, EOS]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self._cache = {BOS: BOS, EOS: EOS}
        self.bos_token_id = self.encoder[BOS]
        self.eos_token_id = self.encoder[EOS]
        self.unk_token_id = self.encoder[EOS]
        self.pad_token_id = self.encoder[pad_token] if pad_token in self.encoder \
            else self.encoder[pad_token + "</w>"]
        self.added_tokens: dict[str, int] = {}

    # -- vocabulary ---------------------------------------------------------

    def __len__(self):
        return len(self.encoder) + len(self.added_tokens)

    def add_tokens(self, tokens) -> int:
        """Register pseudo-tokens (textual inversion); they match verbatim
        (pre-BPE) like transformers AddedTokens."""
        if isinstance(tokens, str):
            tokens = [tokens]
        added = 0
        for t in tokens:
            if t not in self.added_tokens and t not in self.encoder:
                self.added_tokens[t] = len(self.encoder) + len(self.added_tokens)
                added += 1
        return added

    def convert_tokens_to_ids(self, tokens):
        single = isinstance(tokens, str)
        if single:
            tokens = [tokens]
        ids = [self.added_tokens.get(t, self.encoder.get(t, self.unk_token_id))
               for t in tokens]
        return ids[0] if single else ids

    # -- BPE ---------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def _findall(self, text: str):
        """The CLIP pre-tokenizer regex without the `regex` module:
        contractions | letter runs | single digit | other runs."""
        i, n = 0, len(text)
        contractions = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
        while i < n:
            ch = text[i]
            if ch.isspace():
                i += 1
                continue
            if ch == "'":
                low = text[i:i + 3].lower()
                hit = next((c for c in contractions
                            if low.startswith(c)), None)
                if hit is not None:
                    yield text[i:i + len(hit)]
                    i += len(hit)
                    continue
            if ch.isalpha():
                j = i
                while j < n and text[j].isalpha():
                    j += 1
                yield text[i:j]
                i = j
            elif ch.isnumeric():
                yield ch
                i += 1
            else:
                j = i
                while j < n and not (text[j].isspace() or text[j].isalpha()
                                     or text[j].isnumeric()):
                    j += 1
                yield text[i:j]
                i = j

    def tokenize_to_ids(self, text: str) -> list:
        """text -> BPE ids (no specials), with added-token splitting."""
        segments = [text]
        for tok, tid in self.added_tokens.items():
            nxt = []
            for seg in segments:
                if isinstance(seg, int):
                    nxt.append(seg)
                    continue
                parts = seg.split(tok)
                for k, p in enumerate(parts):
                    if k:
                        nxt.append(tid)
                    if p:
                        nxt.append(p)
            segments = nxt
        ids = []
        for seg in segments:
            if isinstance(seg, int):
                ids.append(seg)
                continue
            seg = _basic_clean(seg)
            for token in self._findall(seg):
                token = "".join(self.byte_encoder[b]
                                for b in token.encode("utf-8"))
                ids.extend(self.encoder.get(t, self.unk_token_id)
                           for t in self._bpe(token).split(" "))
        return ids

    # -- HF call surface ----------------------------------------------------

    def __call__(self, text, return_tensors="np", padding=None,
                 max_length=None, truncation=False):
        if isinstance(text, (list, tuple)):
            rows = [self._encode_one(t, padding, max_length, truncation)
                    for t in text]
            width = max(len(r) for r in rows)
            rows = [r + [self.pad_token_id] * (width - len(r)) for r in rows]
            ids = np.asarray(rows, np.int64)
        else:
            ids = np.asarray(
                [self._encode_one(text, padding, max_length, truncation)],
                np.int64)
        if return_tensors == "pt":
            return SimpleNamespace(input_ids=torch.from_numpy(ids))
        return SimpleNamespace(input_ids=ids)

    def _encode_one(self, text, padding, max_length, truncation):
        limit = max_length if max_length is not None else self.model_max_length
        ids = self.tokenize_to_ids(text)
        if truncation and len(ids) > limit - 2:
            ids = ids[: limit - 2]
        ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if padding in ("max_length", True) and len(ids) < limit:
            ids = ids + [self.pad_token_id] * (limit - len(ids))
        return ids
