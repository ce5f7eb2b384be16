"""SentencePiece tokenizers in numpy and the standard library, port of
svi_tpu/prompters/sp_tokenizer.py.

The `spiece.model` / `tokenizer.model` ModelProto parser (protobuf wire
format, `utils.proto`), sentencepiece's normalizer (the precompiled charsmap,
a darts_clone double-array trie over UTF-8 prefixes, and the whitespace
rules) and both segmentations of `SpModel`: unigram Viterbi (T5 / umT5) and
BPE, the highest-score pair merged first, ties to the leftmost, with byte
fallback (ChatGLM / Kolors).

Front-ends: `T5SpTokenizer`, transformers-compatible batches in the HF fast
pipeline (`fast_pipeline=True`: Precompiled -> Strip-right -> collapse
spaces -> Metaspace, what SD3's and FLUX's T5 prompters use) or
sentencepiece's own Normalize() (`fast_pipeline=False`, the reference's
AutoTokenizer load of google/umt5-xxl, Wan's prompter); and
`ChatGLMSpTokenizer`, the Kolors SPTokenizer interface (raw `encode`, the
special tokens appended after the vocabulary, pad = unk); and
`BertWordPieceTokenizer` (basic + WordPiece splitting on a vocab.txt, as
transformers' BertTokenizer), Hunyuan DiT's. The vendored models are under
`svi_tpu_torch/tokenizer_configs/` (`t5`, `kolors`, `hunyuan_dit`).
"""

from __future__ import annotations

import heapq
import json
import os
import struct
from typing import List, Optional, Sequence

import numpy as np

from ..utils.proto import _iter_fields


class Batch(dict):
    """Tokenizer output dict with attribute access (mirrors transformers'
    BatchEncoding enough for `enc.input_ids` / `enc["input_ids"]`)."""

    __getattr__ = dict.__getitem__


def _to_tensors(ids: np.ndarray, mask: np.ndarray, return_tensors: str) -> Batch:
    if return_tensors == "pt":
        import torch

        return Batch(input_ids=torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask))
    return Batch(input_ids=ids, attention_mask=mask)


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

    def _encode_bpe(self, data: bytes) -> List[int]:
        """bpe_model.cc Model::Encode: repeatedly merge the adjacent symbol
        pair forming the highest-score vocab piece (ties: leftmost)."""
        # initial symbols: utf-8 chars
        syms: List[bytes] = []
        pos = 0
        while pos < len(data):
            ln = min(_utf8_char_len(data[pos]), len(data) - pos)
            syms.append(data[pos:pos + ln])
            pos += ln
        nxt = list(range(1, len(syms))) + [-1]
        prv = [-1] + list(range(len(syms) - 1))
        alive = [True] * len(syms)

        heap = []  # (-score, left_index, serial, merged_bytes)
        serial = 0

        def push(i):
            nonlocal serial
            j = nxt[i]
            if j == -1:
                return
            merged = syms[i] + syms[j]
            hit = self._vocab.get(merged)
            if hit is not None:
                heapq.heappush(heap, (-hit[1], i, serial, merged))
                serial += 1

        for i in range(len(syms) - 1):
            push(i)
        while heap:
            _negs, i, _ser, merged = heapq.heappop(heap)
            j = nxt[i] if i < len(nxt) else -1
            if not (i < len(alive) and alive[i] and j != -1 and alive[j]
                    and syms[i] + syms[j] == merged):
                continue  # stale entry
            syms[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            push(i)
            if prv[i] != -1:
                push(prv[i])
        ids: List[int] = []
        i = 0
        while i != -1:
            if alive[i]:
                hit = self._vocab.get(syms[i])
                if hit is not None:
                    ids.append(hit[0])
                elif self._byte_id is not None:
                    ids.extend(self._byte_id[b] for b in syms[i])
                else:
                    ids.append(self.unk_id)
            i = nxt[i]
        return ids

    def encode(self, text: str) -> List[int]:
        data = self.normalizer.normalize(text)
        if not data:
            return []
        if self.trainer.model_type == 2:
            return self._encode_bpe(data)
        return self._encode_unigram(data)

    def encode_normalized(self, data: bytes) -> List[int]:
        """Segment pre-normalized bytes (used by the HF-fast pipeline)."""
        if not data:
            return []
        if self.trainer.model_type == 2:
            return self._encode_bpe(data)
        return self._encode_unigram(data)

    # -- decoding ----------------------------------------------------------

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i].piece

    def vocab_size(self) -> int:
        return len(self.pieces)

    def decode(self, ids: Sequence[int]) -> str:
        out = bytearray()
        pending_bytes = bytearray()
        for i in ids:
            p = self.pieces[i]
            if p.type == _BYTE:
                pending_bytes.append(int(p.piece[1:-1], 16))
                continue
            if pending_bytes:
                out += bytes(pending_bytes)
                pending_bytes.clear()
            if p.type in (_CONTROL, _UNKNOWN):
                continue
            out += p.piece.encode("utf-8")
        if pending_bytes:
            out += bytes(pending_bytes)
        text = out.decode("utf-8", errors="replace").replace(_SPACE, " ")
        return text[1:] if text.startswith(" ") else text


# ---------------------------------------------------------------------------
# T5 / umT5 front-end (transformers-compatible)
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
    """Drop-in for transformers T5Tokenizer(Fast) batches.

    fast_pipeline=True replays the HF fast chain (tokenizer.json:
    Precompiled -> Strip(right) -> Replace(' {2,}' -> U+2581) ->
    Metaspace(prepend always, split)); False replays sentencepiece's own
    Normalize() (slow-tokenizer semantics — what Wan's AutoTokenizer load of
    umt5-xxl produces, ref wan_video.py prompter path)."""

    def __init__(self, model_path: str, fast_pipeline: bool = True):
        model_file = _resolve_spiece(model_path)
        self.sp = SpModel(model_file)
        self.fast_pipeline = fast_pipeline
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

    def _segment(self, text: str) -> List[int]:
        sp = self.sp
        if not self.fast_pipeline:
            return sp.encode(text)
        norm = sp.normalizer
        data = text.encode("utf-8")
        out = bytearray()
        pos = 0
        while pos < len(data):  # Precompiled only (no whitespace rules)
            rep, n = norm._normalize_prefix(data, pos)
            out += rep
            pos += n
        buf = bytes(out).rstrip(b" ")  # Strip right
        # Replace ' {2,}' -> one U+2581, then Metaspace: ' ' -> U+2581 with
        # a prepended U+2581; segmentation never crosses a U+2581 boundary
        # (split=true), which the Viterbi reproduces by itself because no T5
        # piece contains an interior U+2581.
        sp_bytes = _SPACE.encode("utf-8")
        chunks = []
        i = 0
        while i < len(buf):
            if buf[i] == 0x20:
                j = i
                while j < len(buf) and buf[j] == 0x20:
                    j += 1
                chunks.append(sp_bytes)
                i = j
            else:
                chunks.append(buf[i:i + 1])
                i += 1
        body = b"".join(chunks)
        if not body:
            return []
        if not body.startswith(sp_bytes):  # Metaspace prepends only when the
            body = sp_bytes + body         # segment doesn't already lead with it
        return sp.encode_normalized(body)

    def _encode_one(self, text: str) -> List[int]:
        if not self.added:
            return self._segment(text)
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
                ids.extend(self._segment(rest))
                break
            at, tok, idx = best
            if at:
                ids.extend(self._segment(rest[:at]))
            ids.append(idx)
            rest = rest[at + len(tok):]
        return ids

    def __call__(self, text, max_length: Optional[int] = None,
                 padding: str = "max_length", truncation: bool = True,
                 add_special_tokens: bool = True, return_tensors: str = "np"):
        texts = [text] if isinstance(text, str) else list(text)
        seqs = []
        for t in texts:
            ids = self._encode_one(t)
            if add_special_tokens:
                ids = ids + [self.eos_id]
            if truncation and max_length is not None and len(ids) > max_length:
                ids = ids[:max_length]
                if add_special_tokens:
                    ids[-1] = self.eos_id
            seqs.append(ids)
        width = max_length if (padding == "max_length" and max_length) else \
            max(len(s) for s in seqs) if seqs else 0
        input_ids = np.full((len(seqs), width), self.pad_id, np.int64)
        mask = np.zeros((len(seqs), width), np.int64)
        for r, s in enumerate(seqs):
            input_ids[r, :len(s)] = s
            mask[r, :len(s)] = 1
        return _to_tensors(input_ids, mask, return_tensors)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        core = [int(i) for i in ids if int(i) < self.sp.vocab_size()]
        return self.sp.decode(core)


# ---------------------------------------------------------------------------
# ChatGLM / Kolors front-end
# ---------------------------------------------------------------------------

class ChatGLMSpTokenizer:
    """Kolors SPTokenizer interface (reference kolors_prompter.py:12-91):
    BPE encode, special tokens appended after the sp vocab in fixed order,
    pad = unk. Consumed by models.kolors.kolors_tokenize."""

    SPECIAL = ["[MASK]", "[gMASK]", "[sMASK]", "sop", "eop",
               "<|system|>", "<|user|>", "<|assistant|>", "<|observation|>"]

    def __init__(self, model_path: str):
        self.sp = SpModel(_resolve_spiece(model_path))
        self.n_words = self.sp.vocab_size()
        self.bos_id = self.sp.trainer.bos_id
        self.eos_id = self.sp.trainer.eos_id
        self.pad_id = self.sp.unk_id
        self.special_tokens = {}
        self.index_special_tokens = {}
        for tok in self.SPECIAL:
            self.special_tokens[tok] = self.n_words
            self.index_special_tokens[self.n_words] = tok
            self.n_words += 1

    def encode(self, s: str, bos: bool = False, eos: bool = False) -> List[int]:
        ids = self.sp.encode(s)
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text, buf = "", []
        for i in ids:
            if i in self.index_special_tokens:
                if buf:
                    text += self.sp.decode(buf)
                    buf = []
                text += self.index_special_tokens[i]
            else:
                buf.append(i)
        if buf:
            text += self.sp.decode(buf)
        return text


# ---------------------------------------------------------------------------
# BERT WordPiece (HunyuanDiT's Chinese CLIP-BERT)
# ---------------------------------------------------------------------------

class BertWordPieceTokenizer:
    """Minimal BertTokenizer (vocab.txt + basic + WordPiece), matching
    transformers' pure-python BertTokenizer on the Hunyuan DiT vocab
    (tokenizer_configs/hunyuan_dit)."""

    def __init__(self, vocab_path: str, do_lower_case: bool = True):
        if os.path.isdir(vocab_path):
            vocab_path = os.path.join(vocab_path, "vocab.txt")
        self.vocab = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.do_lower_case = do_lower_case
        for name in ("[PAD]", "[UNK]", "[CLS]", "[SEP]"):
            setattr(self, name[1:-1].lower() + "_id", self.vocab[name])

    @staticmethod
    def _is_punct(ch: str) -> bool:
        cp = ord(ch)
        if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
            return True
        import unicodedata
        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_chinese(ch: str) -> bool:
        cp = ord(ch)
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
                or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
                or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)

    def _basic(self, text: str) -> List[str]:
        import unicodedata
        out = []
        for ch in text:
            if self._is_chinese(ch):
                out.append(f" {ch} ")
            elif ch in ("\t", "\n", "\r") or unicodedata.category(ch) == "Zs":
                out.append(" ")
            elif unicodedata.category(ch) in ("Cc", "Cf") or ch == "\0" or ch == "�":
                continue
            else:
                out.append(ch)
        tokens = []
        for tok in "".join(out).split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            cur = []
            for ch in tok:
                if self._is_punct(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > 100:
            return ["[UNK]"]
        out, start = [], 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return ["[UNK]"]
            out.append(piece)
            start = end
        return out

    def __call__(self, text, max_length: int = 77, padding: str = "max_length",
                 truncation: bool = True, return_tensors: str = "np"):
        texts = [text] if isinstance(text, str) else list(text)
        seqs = []
        for t in texts:
            toks = []
            for w in self._basic(t):
                toks.extend(self._wordpiece(w))
            ids = [self.cls_id] + [self.vocab.get(p, self.unk_id) for p in toks]
            if truncation and len(ids) > max_length - 1:
                ids = ids[:max_length - 1]
            ids.append(self.sep_id)
            seqs.append(ids)
        width = max_length if padding == "max_length" else max(len(s) for s in seqs)
        input_ids = np.full((len(seqs), width), self.pad_id, np.int64)
        mask = np.zeros((len(seqs), width), np.int64)
        for r, s in enumerate(seqs):
            input_ids[r, :len(s)] = s
            mask[r, :len(s)] = 1
        return _to_tensors(input_ids, mask, return_tensors)


# ---------------------------------------------------------------------------
# Vendored assets
# ---------------------------------------------------------------------------

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tokenizer_configs")


def asset_path(name: str) -> str:
    """Path to a vendored tokenizer asset dir of the port: 't5', 'kolors',
    'hunyuan_dit'."""
    return os.path.join(_ASSET_DIR, name)


def default_t5_tokenizer(fast_pipeline: bool = True) -> T5SpTokenizer:
    return T5SpTokenizer(asset_path("t5"), fast_pipeline=fast_pipeline)


def default_chatglm_tokenizer() -> ChatGLMSpTokenizer:
    return ChatGLMSpTokenizer(asset_path("kolors"))


def default_bert_tokenizer() -> BertWordPieceTokenizer:
    return BertWordPieceTokenizer(asset_path("hunyuan_dit"))
