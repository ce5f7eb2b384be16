"""HunyuanVideo prompter, port of svi_tpu/prompters/hunyuan_video_prompter.py:
the llama3-chat templates with their fixed `crop_start` offsets, CLIP-L's
pooled embedding (`models.sd3.sd3_text_encoder_1_forward`, the port's
encoder), the LLM's hidden states padded to max_length + crop_start and
cropped past the template, and the image-to-video token surgery
(`crop_mllm_states`: the 576 image-embedding positions subsampled, the text
around the final assistant header re-joined).

The LLM is the caller's, as in the JAX package: `llm_forward(input_ids
(B, S) int, attention_mask (B, S), hidden_state_skip_layer,
pixel_values=...) -> (B, S, D)` hidden states (a transformers LLaMA / LLaVA
adapter), with its tokenizer `tokenizer_2`; nothing is downloaded. The crop
and assembly run in numpy on the host; the pooled CLIP embedding is a torch
tensor on the CLIP encoder's device.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

PROMPT_TEMPLATE_ENCODE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the image by "
    "detailing the color, shape, size, texture, quantity, text, spatial "
    "relationships of the objects and background:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")

PROMPT_TEMPLATE_ENCODE_VIDEO = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by "
    "detailing the following aspects: "
    "1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical "
    "movement changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the "
    "video:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")

PROMPT_TEMPLATE_ENCODE_I2V = (
    "<|start_header_id|>system<|end_header_id|>\n\n<image>\nDescribe the "
    "image by detailing the color, shape, size, texture, quantity, text, "
    "spatial relationships of the objects and background:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
    "<|start_header_id|>assistant<|end_header_id|>\n\n")

PROMPT_TEMPLATE_ENCODE_VIDEO_I2V = (
    "<|start_header_id|>system<|end_header_id|>\n\n<image>\nDescribe the "
    "video by detailing the following aspects according to the reference "
    "image: "
    "1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical "
    "movement changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the "
    "video:<|eot_id|>\n\n"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
    "<|start_header_id|>assistant<|end_header_id|>\n\n")

PROMPT_TEMPLATE = {
    "dit-llm-encode": {
        "template": PROMPT_TEMPLATE_ENCODE,
        "crop_start": 36,
    },
    "dit-llm-encode-video": {
        "template": PROMPT_TEMPLATE_ENCODE_VIDEO,
        "crop_start": 95,
    },
    "dit-llm-encode-i2v": {
        "template": PROMPT_TEMPLATE_ENCODE_I2V,
        "crop_start": 36,
        "image_emb_start": 5,
        "image_emb_end": 581,
        "image_emb_len": 576,
        "double_return_token_id": 271,
    },
    "dit-llm-encode-video-i2v": {
        "template": PROMPT_TEMPLATE_ENCODE_VIDEO_I2V,
        "crop_start": 103,
        "image_emb_start": 5,
        "image_emb_end": 581,
        "image_emb_len": 576,
        "double_return_token_id": 271,
    },
}

NEGATIVE_PROMPT = (
    "Aerial view, aerial view, overexposed, low quality, deformation, a "
    "poor composition, bad hands, bad teeth, bad eyes, bad limbs, "
    "distortion")


class _ClipTokenizerWithMask:
    """The port's CLIP BPE tokenizer with an attention mask (ones through the
    first end token), for `return_attention_mask=True` calls."""

    def __init__(self):
        from .clip_tokenizer import ClipBpeTokenizer

        self.tok = ClipBpeTokenizer()

    def __call__(self, text, return_tensors="np", padding=None, max_length=None,
                 truncation=False, return_attention_mask=False):
        ids = self.tok(text, return_tensors="np", padding=padding, max_length=max_length,
                       truncation=truncation).input_ids
        first_eos = (ids == self.tok.eos_token_id).argmax(axis=1)
        mask = (np.arange(ids.shape[1])[None] <= first_eos[:, None]).astype(np.int64)
        return SimpleNamespace(input_ids=ids, attention_mask=mask)


class HunyuanVideoPrompter:
    """clip_params: CLIP-L's text tower (`models.sd.sd_text_encoder_params_from_torch`)
    for the pooled branch; llm_forward and tokenizer_2: the caller's LLM and
    its tokenizer. Image-to-video templates are selected with `enable_i2v()`."""

    def __init__(self, tokenizer_1=None, tokenizer_2=None, clip_params=None, llm_forward=None):
        self.tokenizer_1 = tokenizer_1
        self.tokenizer_2 = tokenizer_2
        self.clip_params = clip_params
        self.llm_forward = llm_forward
        self.prompt_template = PROMPT_TEMPLATE["dit-llm-encode"]
        self.prompt_template_video = PROMPT_TEMPLATE["dit-llm-encode-video"]
        self.image_processor = None

    def enable_i2v(self, image_processor=None):
        """The image-to-video templates (the reference switches on its MLLM
        encoder class)."""
        self.prompt_template = PROMPT_TEMPLATE["dit-llm-encode-i2v"]
        self.prompt_template_video = PROMPT_TEMPLATE["dit-llm-encode-video-i2v"]
        self.image_processor = image_processor

    def _ensure_tokenizer_1(self):
        if self.tokenizer_1 is None:
            self.tokenizer_1 = _ClipTokenizerWithMask()

    def _ensure_tokenizer_2(self):
        if self.tokenizer_2 is None:
            raise ValueError("tokenizer_2 (the HunyuanVideo LLM's tokenizer) must be provided")

    def apply_text_to_template(self, text, template):
        assert isinstance(template, str)
        if isinstance(text, list):
            return [self.apply_text_to_template(t, template) for t in text]
        if isinstance(text, str):
            return template.format(text)
        raise TypeError(f"Unsupported prompt type: {type(text)}")

    @torch.no_grad()
    def encode_prompt_using_clip(self, prompt, max_length=77):
        """CLIP-L's pooled embedding (B, 768), keys masked by the tokenizer's
        attention mask."""
        from ..models import sd3

        self._ensure_tokenizer_1()
        tok = self.tokenizer_1(prompt, return_tensors="np", padding="max_length",
                               max_length=max_length, truncation=True,
                               return_attention_mask=True)
        pooled, _ = sd3.sd3_text_encoder_1_forward(self.clip_params, np.asarray(tok.input_ids),
                                                   extra_mask=np.asarray(tok.attention_mask))
        return pooled

    def encode_prompt_using_llm(self, prompt, max_length, crop_start, hidden_state_skip_layer=2,
                                use_attention_mask=True):
        self._ensure_tokenizer_2()
        max_length += crop_start
        inputs = self.tokenizer_2(prompt, return_tensors="np", padding="max_length",
                                  max_length=max_length, truncation=True)
        input_ids = np.asarray(inputs.input_ids)
        attention_mask = np.asarray(inputs.attention_mask)
        hidden = _host(self.llm_forward(input_ids, attention_mask, hidden_state_skip_layer))
        if crop_start > 0:
            hidden = hidden[:, crop_start:]
            attention_mask = attention_mask[:, crop_start:] if use_attention_mask else None
        return hidden, attention_mask

    def crop_mllm_states(self, input_ids, attention_mask, last_hidden_state, crop_start,
                         template=None, use_attention_mask=True, image_embed_interleave=4):
        """The image-to-video token surgery: the image-embedding positions and
        the text positions around the final assistant header sliced out, the
        image span subsampled, re-joined as [image | text]."""
        template = template or self.prompt_template_video
        img_len = template.get("image_emb_len", 576)
        image_crop_start = template.get("image_emb_start", 5)
        image_crop_end = template.get("image_emb_end", 581)
        dr_token = template.get("double_return_token_id", 271)

        text_crop_start = crop_start - 1 + img_len
        batch_idx, dr_idx = np.where(input_ids == dr_token)
        if dr_idx.shape[0] == 3:  # the prompt was too long: the final marker is cut
            dr_idx = np.concatenate([dr_idx, [input_ids.shape[-1]]])
            batch_idx = np.concatenate([batch_idx, [0]])
        dr_last = dr_idx.reshape(input_ids.shape[0], -1)[:, -1]
        assistant_crop_start = dr_last - 1 + img_len - 4
        assistant_crop_end = dr_last - 1 + img_len
        mask_crop_start = dr_last - 4
        mask_crop_end = dr_last

        text_h, text_m, img_h, img_m = [], [], [], []
        for i in range(input_ids.shape[0]):
            text_h.append(np.concatenate([
                last_hidden_state[i, text_crop_start:int(assistant_crop_start[i])],
                last_hidden_state[i, int(assistant_crop_end[i]):]]))
            text_m.append(np.concatenate([
                attention_mask[i, crop_start:int(mask_crop_start[i])],
                attention_mask[i, int(mask_crop_end[i]):]]) if use_attention_mask else None)
            img_h.append(last_hidden_state[i, image_crop_start:image_crop_end])
            img_m.append(np.ones(img_h[-1].shape[0], attention_mask.dtype)
                         if use_attention_mask else None)
        text_h = np.stack(text_h)
        text_m = np.stack(text_m)
        img_h = np.stack(img_h)[:, ::image_embed_interleave, :]
        img_m = np.stack(img_m)[:, ::image_embed_interleave]
        return np.concatenate([img_h, text_h], axis=1), np.concatenate([img_m, text_m], axis=1)

    def encode_prompt_using_mllm(self, prompt, images, max_length, crop_start,
                                 hidden_state_skip_layer=2, use_attention_mask=True,
                                 image_embed_interleave=4):
        """llm_forward receives the image processor's pixel_values as a kwarg."""
        self._ensure_tokenizer_2()
        pixel_values = None
        if self.image_processor is not None:
            pixel_values = np.asarray(
                self.image_processor(images, return_tensors="np")["pixel_values"])
        max_length += crop_start
        inputs = self.tokenizer_2(prompt, return_tensors="np", padding="max_length",
                                  max_length=max_length, truncation=True)
        input_ids = np.asarray(inputs.input_ids)
        attention_mask = np.asarray(inputs.attention_mask)
        hidden = _host(self.llm_forward(input_ids, attention_mask, hidden_state_skip_layer,
                                        pixel_values=pixel_values))
        return self.crop_mllm_states(input_ids, attention_mask, hidden, crop_start,
                                     use_attention_mask=use_attention_mask,
                                     image_embed_interleave=image_embed_interleave)

    def encode_prompt(self, prompt, images=None, positive=True, clip_sequence_length=77,
                      llm_sequence_length=256, data_type="video", use_template=True,
                      hidden_state_skip_layer=2, use_attention_mask=True,
                      image_embed_interleave=4):
        """-> (prompt_emb (B, S, D) numpy, pooled_prompt_emb (B, 768) tensor,
        attention_mask (B, S) numpy)."""
        if not positive and not prompt:
            prompt = NEGATIVE_PROMPT
        template = self.prompt_template_video if data_type == "video" else self.prompt_template
        prompt_formated = (self.apply_text_to_template(prompt, template["template"])
                           if use_template else prompt)
        crop_start = template.get("crop_start", 0)

        pooled = self.encode_prompt_using_clip(prompt, clip_sequence_length)
        if images is None:
            emb, mask = self.encode_prompt_using_llm(prompt_formated, llm_sequence_length,
                                                     crop_start, hidden_state_skip_layer,
                                                     use_attention_mask)
        else:
            emb, mask = self.encode_prompt_using_mllm(prompt_formated, images,
                                                      llm_sequence_length, crop_start,
                                                      hidden_state_skip_layer,
                                                      use_attention_mask, image_embed_interleave)
        return emb, pooled, mask


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)
