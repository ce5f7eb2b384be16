"""SD3 / SD3.5 prompter, port of svi_tpu/prompters/sd3_prompter.py: one
77-token CLIP window for both CLIP encoders, their hidden states
concatenated (768 + 1280) and zero-padded to 4096, then the T5 sequence
appended on the token axis (zeros when no T5 is given); the pooled embedding
is both CLIP pooled outputs concatenated (2048)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import sd3, sdxl


def t5_states(t5, prompt, sequence_length) -> torch.Tensor:
    """T5's states of the prompt: t5 is a (T5Encoder, cfg, tokenizer) triple
    (the encoder carries its cfg; tokenizer None: the vendored T5 model in
    the HF fast pipeline), ids padded to sequence_length, no attention mask,
    as the JAX package runs it. Returns (1, n * sequence_length, dim)."""
    model, _cfg, tok = t5
    if tok is None:
        from .sp_tokenizer import default_t5_tokenizer

        tok = default_t5_tokenizer()
    tid = tok(prompt, return_tensors="np", padding="max_length", max_length=sequence_length,
              truncation=True).input_ids
    dev = model["token_embedding"].device
    ids = torch.from_numpy(tid).to(dev)
    emb = model(ids, torch.ones_like(ids))
    return emb.reshape(1, -1, emb.shape[-1])


class SD3Prompter:
    def __init__(self, tokenizer=None, t5_tokenizer=None):
        self.tokenizer = tokenizer
        self.t5_tokenizer = t5_tokenizer

    def _clip_ids(self, prompt, device):
        if self.tokenizer is None:
            from .clip_tokenizer import ClipBpeTokenizer

            self.tokenizer = ClipBpeTokenizer()
        ids = self.tokenizer(prompt, return_tensors="np", padding="max_length", max_length=77,
                             truncation=True).input_ids
        return torch.from_numpy(ids).to(device)

    @torch.no_grad()
    def encode_prompt(self, te1_params, te2_params, t5, prompt, t5_sequence_length=77):
        """(prompt_emb (1, 77 + t5_sequence_length, 4096), pooled (1, 2048));
        t5: None or a (T5Encoder, cfg, tokenizer) triple."""
        ids = self._clip_ids(prompt, te1_params["token_embedding"].device)
        pooled_1, emb_1 = sd3.sd3_text_encoder_1_forward(te1_params, ids)
        pooled_2, emb_2 = sdxl.sdxl_text_encoder_2_forward(te2_params, ids)
        clip_emb = torch.cat([emb_1, emb_2], -1)
        clip_emb = F.pad(clip_emb, (0, 4096 - clip_emb.shape[-1]))
        if t5 is None:
            emb_3 = torch.zeros((clip_emb.shape[0], t5_sequence_length, 4096),
                                dtype=clip_emb.dtype, device=clip_emb.device)
        else:
            emb_3 = t5_states(t5, prompt, t5_sequence_length).reshape(1, -1, 4096)
            emb_3 = emb_3.to(clip_emb.device, clip_emb.dtype)
        return torch.cat([clip_emb, emb_3], -2), torch.cat([pooled_1, pooled_2], -1)
