"""Textual-inversion embeddings for CLIP prompters, port of
svi_tpu/prompters/textual_inversion.py: the (K, D) embedding rows found in
each file, their `<stem>_<i>` pseudo-tokens, the token table extended by
them and the keyword replacements applied to prompts.
"""

from __future__ import annotations

import os

import torch


def search_for_embeddings(state_dict) -> list:
    """Every tensor anywhere in a (possibly nested) state dict."""
    found = []
    for value in state_dict.values():
        if isinstance(value, dict):
            found += search_for_embeddings(value)
        elif hasattr(value, "shape"):
            found.append(value)
    return found


def _load_nested_state_dict(path: str) -> dict:
    """A state dict with its nested sub-dicts kept (A1111 embedding files
    hold {'string_to_param': {'*': (K, D)}})."""
    if path.endswith(".safetensors"):
        from ..models.model_io import load_state_dict

        return load_state_dict(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd if isinstance(sd, dict) else {}


def load_textual_inversion_dict(model_paths, embedding_dim=768) -> dict:
    """{keyword: (pseudo_tokens, (K, embedding_dim) float32 CPU rows)}: the
    keyword is the file's stem, row i is the pseudo-token `<keyword>_<i>`."""
    out = {}
    for model_path in model_paths:
        keyword = os.path.splitext(os.path.basename(model_path))[0]
        for emb in search_for_embeddings(_load_nested_state_dict(model_path)):
            emb = torch.as_tensor(emb).detach().to("cpu", torch.float32)
            if emb.ndim == 2 and emb.shape[1] == embedding_dim:
                out[keyword] = ([f"{keyword}_{i}" for i in range(emb.shape[0])], emb)
    return out


def extend_token_embedding(token_embedding: torch.Tensor, textual_inversion_dict) -> torch.Tensor:
    """A new (V + sum K_i, D) table: every embedding's rows appended in the
    dict's order, on the table's device and in its dtype."""
    rows = [token_embedding] + [emb.to(token_embedding.device, token_embedding.dtype)
                                for _, emb in textual_inversion_dict.values()]
    return torch.cat(rows, dim=0)


def keyword_replacements(textual_inversion_dict) -> dict:
    """{keyword: ' tok_0 tok_1 ... '}, applied to prompts before tokenizing."""
    return {kw: " " + " ".join(tokens) + " "
            for kw, (tokens, _) in textual_inversion_dict.items()}
