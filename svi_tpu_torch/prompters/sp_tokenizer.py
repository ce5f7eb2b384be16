"""SentencePiece unigram tokenizer for umT5 prompts, in numpy and the standard library.

Port of the part of svi_tpu/prompters/sp_tokenizer.py that Wan's prompts use:
the `spiece.model` ModelProto parser (protobuf wire format, `utils.proto`),
sentencepiece's normalizer (the precompiled charsmap, a darts_clone
double-array trie over UTF-8 prefixes, and the whitespace rules), unigram
Viterbi segmentation (`SpModel`), and `T5SpTokenizer` in the slow
(sentencepiece) pipeline, which is what the reference's AutoTokenizer load of
google/umt5-xxl does. The BPE model, the HF fast pipeline, ChatGLM and
WordPiece serve other models and are not ported here.
"""

from __future__ import annotations

import json
import os
import struct
from typing import List, Optional

import numpy as np

from ..utils.proto import _iter_fields

_SPACE = "▁"  # LOWER ONE EIGHTH BLOCK, sentencepiece's escaped space
_UNK_PENALTY = 10.0  # unigram_model.cc kUnkPenalty

# SentencePiece.Type enum (sentencepiece_model.proto)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


# ---------------------------------------------------------------------------
# ModelProto parsing
# ---------------------------------------------------------------------------

class _Piece:
    __slots__ = ("piece", "score", "type")

    def __init__(self, piece, score, type_):
        self.piece, self.score, self.type = piece, score, type_


def _parse_piece(buf) -> _Piece:
    piece, score, type_ = "", 0.0, _NORMAL
    for fno, _wt, val in _iter_fields(buf):
        if fno == 1:
            piece = bytes(val).decode("utf-8")
        elif fno == 2:
            score = struct.unpack("<f", val)[0]
        elif fno == 3:
            type_ = val
    return _Piece(piece, score, type_)


class _NormalizerSpec:
    def __init__(self):
        self.precompiled_charsmap = b""
        self.add_dummy_prefix = True
        self.remove_extra_whitespaces = True
        self.escape_whitespaces = True


def _parse_normalizer_spec(buf) -> _NormalizerSpec:
    spec = _NormalizerSpec()
    for fno, _wt, val in _iter_fields(buf):
        if fno == 2:
            spec.precompiled_charsmap = bytes(val)
        elif fno == 3:
            spec.add_dummy_prefix = bool(val)
        elif fno == 4:
            spec.remove_extra_whitespaces = bool(val)
        elif fno == 5:
            spec.escape_whitespaces = bool(val)
    return spec


class _TrainerSpec:
    def __init__(self):
        self.model_type = 1  # UNIGRAM
        self.byte_fallback = False
        self.unk_id, self.bos_id, self.eos_id, self.pad_id = 0, 1, 2, -1


def _parse_trainer_spec(buf) -> _TrainerSpec:
    spec = _TrainerSpec()
    for fno, _wt, val in _iter_fields(buf):
        if fno == 3:
            spec.model_type = val
        elif fno == 35:
            spec.byte_fallback = bool(val)
        elif fno == 40:
            spec.unk_id = _sint32(val)
        elif fno == 41:
            spec.bos_id = _sint32(val)
        elif fno == 42:
            spec.eos_id = _sint32(val)
        elif fno == 43:
            spec.pad_id = _sint32(val)
    return spec


def _sint32(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# darts_clone double-array trie (precompiled charsmap + piece matching)
# ---------------------------------------------------------------------------

class _DoubleArray:
    """Read-only darts_clone trie: common-prefix search over byte keys."""

    def __init__(self, units: np.ndarray):
        self._units = units

    @staticmethod
    def _offset(u: int) -> int:
        return (u >> 10) << ((u & (1 << 9)) >> 6)

    def common_prefix_search(self, key, start: int = 0, limit: int = 2 ** 30):
        """Yield (value, match_length) for every trie entry that is a prefix
        of key[start:], shortest first (darts.h commonPrefixSearch)."""
        units = self._units
        u = int(units[0])
        node_pos = self._offset(u)
        end = min(len(key), start + limit)
        for i in range(start, end):
            c = key[i]
            node_pos ^= c
            u = int(units[node_pos])
            if (u & ((1 << 31) | 0xFF)) != c:  # unit.label() != c
                return
            node_pos ^= self._offset(u)
            if (u >> 8) & 1:  # has_leaf
                yield int(units[node_pos]) & 0x7FFFFFFF, i - start + 1


def _build_charsmap(blob: bytes):
    """precompiled_charsmap = uint32 LE trie size | trie units | string pool."""
    if not blob:
        return None, b""
    (trie_size,) = struct.unpack("<I", blob[:4])
    units = np.frombuffer(blob, dtype="<u4", offset=4, count=trie_size // 4)
    pool = blob[4 + trie_size:]
    return _DoubleArray(units), pool


# ---------------------------------------------------------------------------
# Normalizer (sentencepiece normalizer.cc)
# ---------------------------------------------------------------------------

def _utf8_char_len(b0: int) -> int:
    if b0 < 0x80:
        return 1
    if b0 < 0xC0:
        return 1  # stray continuation byte: consume one
    if b0 < 0xE0:
        return 2
    if b0 < 0xF0:
        return 3
    return 4


class _Normalizer:
    def __init__(self, spec: _NormalizerSpec):
        self.spec = spec
        self.trie, self.pool = _build_charsmap(spec.precompiled_charsmap)

    def _normalize_prefix(self, data: bytes, pos: int):
        """Longest charsmap match at data[pos:] -> (replacement bytes,
        consumed); falls back to one UTF-8 char unchanged."""
        best = None
        if self.trie is not None:
            for value, length in self.trie.common_prefix_search(data, pos):
                best = (value, length)  # common_prefix_search yields in
                # increasing length order -> last hit is the longest match
        if best is not None:
            value, length = best
            end = self.pool.index(b"\0", value)
            return self.pool[value:end], length
        n = _utf8_char_len(data[pos])
        return data[pos:pos + n], n

    def normalize(self, text: str) -> bytes:
        """Port of Normalizer::Normalize (normalizer.cc): charsmap replace,
        leading/trailing/repeated whitespace removal, dummy prefix, space
        escaping. Returns UTF-8 bytes."""
        data = text.encode("utf-8")
        pos = 0
        spec = self.spec
        # strip leading pieces that normalize to " "
        if spec.remove_extra_whitespaces:
            while pos < len(data):
                rep, n = self._normalize_prefix(data, pos)
                if rep != b" ":
                    break
                pos += n
        if pos == len(data):
            return b""
        space = _SPACE.encode("utf-8") if spec.escape_whitespaces else b" "
        out = bytearray()
        if spec.add_dummy_prefix:
            out += space
        is_prev_space = False
        while pos < len(data):
            rep, n = self._normalize_prefix(data, pos)
            pos += n
            start = 0
            while is_prev_space and rep[start:start + 1] == b" ":
                start += 1
            if start < len(rep):
                for b in rep[start:]:
                    if spec.escape_whitespaces and b == 0x20:
                        out += space
                    else:
                        out.append(b)
                is_prev_space = rep.endswith(b" ")
            if not spec.remove_extra_whitespaces:
                is_prev_space = False
        if spec.remove_extra_whitespaces:
            while out.endswith(space):
                del out[-len(space):]
        return bytes(out)


# ---------------------------------------------------------------------------
# Core model
# ---------------------------------------------------------------------------

class SpModel:
    """Parsed SentencePiece model: normalization + segmentation to raw ids."""

    def __init__(self, model_path: str):
        with open(model_path, "rb") as f:
            data = f.read()
        self.pieces: List[_Piece] = []
        trainer, norm_spec = _TrainerSpec(), _NormalizerSpec()
        for fno, _wt, val in _iter_fields(memoryview(data)):
            if fno == 1:
                self.pieces.append(_parse_piece(val))
            elif fno == 2:
                trainer = _parse_trainer_spec(val)
            elif fno == 3:
                norm_spec = _parse_normalizer_spec(val)
        if trainer.model_type != 1:
            raise NotImplementedError(
                f"{model_path}: sentencepiece model type {trainer.model_type}; only unigram "
                "(type 1, T5 / umT5) is ported (BPE serves ChatGLM, Slice F)")
        self.trainer = trainer
        self.normalizer = _Normalizer(norm_spec)
        self.piece_to_id = {p.piece: i for i, p in enumerate(self.pieces)}
        self.unk_id = trainer.unk_id
        for i, p in enumerate(self.pieces):  # authoritative over trainer_spec
            if p.type == _UNKNOWN:
                self.unk_id = i
        # matchable vocabulary (utf-8 byte keys): normal + user-defined only
        self._vocab = {}
        self._max_piece_len = 1
        min_score = 0.0
        for i, p in enumerate(self.pieces):
            if p.type in (_NORMAL, _USER_DEFINED):
                key = p.piece.encode("utf-8")
                self._vocab[key] = (i, p.score, p.type == _USER_DEFINED)
                self._max_piece_len = max(self._max_piece_len, len(key))
            if p.type == _NORMAL:
                min_score = min(min_score, p.score)
        self.min_score = min_score
        self._byte_id = None
        if trainer.byte_fallback:
            self._byte_id = [self.piece_to_id.get(f"<0x{b:02X}>") for b in range(256)]

    # -- segmentation ------------------------------------------------------

    def _matches_at(self, data: bytes, pos: int):
        """All vocab pieces starting at data[pos:] as (id, score, user, len)."""
        out = []
        end = min(len(data), pos + self._max_piece_len)
        for j in range(pos + 1, end + 1):
            hit = self._vocab.get(data[pos:j])
            if hit is not None:
                out.append((hit[0], hit[1], hit[2], j - pos))
        return out

    def _encode_unigram(self, data: bytes) -> List[int]:
        """Viterbi (unigram_model.cc Model::Encode): maximize summed piece
        log-probs; unknown chars cost min_score - 10.0; contiguous unknowns
        fuse into one unk token."""
        n = len(data)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back = [None] * (n + 1)  # (prev_pos, piece_id or None for unk-char)
        best[0] = 0.0
        unk_score = self.min_score - _UNK_PENALTY
        pos = 0
        while pos < n:
            if best[pos] == NEG:
                pos += 1
                continue
            base = best[pos]
            for pid, score, user, ln in self._matches_at(data, pos):
                s = base + score
                if s > best[pos + ln]:
                    best[pos + ln] = s
                    back[pos + ln] = (pos, pid)
            ln = _utf8_char_len(data[pos])
            ln = min(ln, n - pos)
            s = base + unk_score
            if s > best[pos + ln]:
                best[pos + ln] = s
                back[pos + ln] = (pos, None)
            pos += 1
        ids: List[int] = []
        pos = n
        rev = []
        while pos > 0:
            prev, pid = back[pos]
            rev.append((prev, pos, pid))
            pos = prev
        prev_unk = False
        for start, end, pid in reversed(rev):
            if pid is None:
                if self._byte_id is not None:
                    ids.extend(self._byte_id[b] for b in data[start:end])
                    prev_unk = False
                else:
                    if not prev_unk:  # fuse contiguous unknowns
                        ids.append(self.unk_id)
                    prev_unk = True
            else:
                ids.append(pid)
                prev_unk = False
        return ids

    def encode(self, text: str) -> List[int]:
        data = self.normalizer.normalize(text)
        return self._encode_unigram(data) if data else []


# ---------------------------------------------------------------------------
# T5 / umT5 front-end (transformers-compatible batches)
# ---------------------------------------------------------------------------

def _resolve_spiece(path: str) -> str:
    if os.path.isdir(path):
        for name in ("spiece.model", "tokenizer.model"):
            cand = os.path.join(path, name)
            if os.path.isfile(cand):
                return cand
        raise FileNotFoundError(f"no spiece.model/tokenizer.model in {path}")
    return path


class T5SpTokenizer:
    """transformers' slow T5Tokenizer batches (padding="max_length",
    truncation, special tokens): sentencepiece's own Normalize() then unigram
    segmentation."""

    def __init__(self, model_path: str):
        self.sp = SpModel(_resolve_spiece(model_path))
        self.eos_id = self.sp.trainer.eos_id
        self.pad_id = max(self.sp.trainer.pad_id, 0)
        self.unk_id = self.sp.unk_id
        # added tokens (T5 <extra_id_*>; umt5 has them inside the sp vocab)
        self.added: dict = {}
        if os.path.isdir(model_path):
            extra = os.path.join(model_path, "added_tokens.json")
            if os.path.isfile(extra):
                with open(extra) as f:
                    for tok, idx in json.load(f).items():
                        self.added[tok] = idx

    def _encode_one(self, text: str) -> List[int]:
        if not self.added:
            return self.sp.encode(text)
        # split on added tokens (longest first), tokenize the gaps
        ids: List[int] = []
        rest = text
        while rest:
            best = None
            for tok, idx in self.added.items():
                at = rest.find(tok)
                if at != -1 and (best is None or at < best[0]
                                 or (at == best[0] and len(tok) > len(best[1]))):
                    best = (at, tok, idx)
            if best is None:
                ids.extend(self.sp.encode(rest))
                break
            at, tok, idx = best
            if at:
                ids.extend(self.sp.encode(rest[:at]))
            ids.append(idx)
            rest = rest[at + len(tok):]
        return ids

    def __call__(self, text, max_length: Optional[int] = None) -> dict:
        """Text(s) -> ids with eos appended, truncated to max_length (eos kept
        last) and padded to it (to the longest without one), and the attention
        mask; int64 numpy, one row per text."""
        texts = [text] if isinstance(text, str) else list(text)
        seqs = []
        for t in texts:
            ids = self._encode_one(t) + [self.eos_id]
            if max_length is not None and len(ids) > max_length:
                ids = ids[:max_length]
                ids[-1] = self.eos_id
            seqs.append(ids)
        width = max_length or max((len(s) for s in seqs), default=0)
        input_ids = np.full((len(seqs), width), self.pad_id, np.int64)
        mask = np.zeros((len(seqs), width), np.int64)
        for r, s in enumerate(seqs):
            input_ids[r, :len(s)] = s
            mask[r, :len(s)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}
