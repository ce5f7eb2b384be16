"""OmniGen prompter and collator, port of
svi_tpu/prompters/omnigen_prompter.py (host numpy): the instruction
template, the `<img><|image_k|></img>` splicing of reference-image tokens,
the image crop, and the separate-CFG collator's left-padded ids, block
attention masks and position ids.

The text tokenizer is the caller's callable. `crop_arr` takes an (H, W, 3)
uint8 array (or a PIL image, read through np.asarray) and reproduces
Pillow's BOX and BICUBIC resizes byte for byte in numpy
(`utils.image_process.resize_uint8`), so nothing here needs Pillow.
"""

from __future__ import annotations

import re

import numpy as np

from ..utils.image_process import resize_uint8

NEGATIVE_PROMPT = (
    "low quality, jpeg artifacts, ugly, duplicate, morbid, mutilated, extra "
    "fingers, mutated hands, poorly drawn hands, poorly drawn face, "
    "mutation, deformed, blurry, dehydrated, bad anatomy, bad proportions, "
    "extra limbs, cloned face, disfigured, gross proportions, malformed "
    "limbs, missing arms, missing legs, extra arms, extra legs, fused "
    "fingers, too many fingers.")


def crop_arr(pil_image, max_image_size):
    """An (H, W, 3) uint8 image (or a PIL image) halved by Pillow's BOX
    resize while its short side is at least twice max_image_size, bounded by
    a BICUBIC resize to max_image_size (or raised to a short side of 16),
    then center-cropped to multiples of 16: Pillow's bytes, in numpy."""
    arr = np.asarray(pil_image)
    while min(arr.shape[1], arr.shape[0]) >= 2 * max_image_size:
        arr = resize_uint8(arr, arr.shape[1] // 2, arr.shape[0] // 2, resample="box")
    if max(arr.shape[1], arr.shape[0]) > max_image_size:
        scale = max_image_size / max(arr.shape[1], arr.shape[0])
        arr = resize_uint8(arr, round(arr.shape[1] * scale), round(arr.shape[0] * scale))
    if min(arr.shape[1], arr.shape[0]) < 16:
        scale = 16 / min(arr.shape[1], arr.shape[0])
        arr = resize_uint8(arr, round(arr.shape[1] * scale), round(arr.shape[0] * scale))
    cy1 = (arr.shape[0] % 16) // 2
    cy2 = arr.shape[0] % 16 - cy1
    cx1 = (arr.shape[1] % 16) // 2
    cx2 = arr.shape[1] % 16 - cx1
    return arr[cy1:arr.shape[0] - cy2, cx1:arr.shape[1] - cx2]


def add_prefix_instruction(prompt):
    """The instruction template around the prompt."""
    return ("<|user|>\nGenerate an image according to the following "
            f"instructions\n{prompt}<|end|>\n<|assistant|>\n<|diffusion|>")


def process_multi_modal_prompt(text, input_images, tokenize):
    """`tokenize(str) -> list[int]`; input_images are (1, 3, h, w) arrays
    (preprocessed). Each `<|image_k|>` tag becomes h * w / 256 zero ids.
    Returns {input_ids (a list), pixel_values, image_sizes (the spans)}."""
    text = add_prefix_instruction(text)
    if not input_images:
        return {"input_ids": list(tokenize(text)), "pixel_values": None,
                "image_sizes": None}
    pattern = r"<\|image_\d+\|>"
    chunks = [list(tokenize(c)) for c in re.split(pattern, text)]
    for i in range(1, len(chunks)):
        if chunks[i] and chunks[i][0] == 1:
            chunks[i] = chunks[i][1:]
    image_tags = re.findall(pattern, text)
    image_ids = [int(s.split("|")[1].split("_")[-1]) for s in image_tags]
    unique = sorted(set(image_ids))
    assert unique == list(range(1, len(unique) + 1)), unique
    assert len(unique) == len(input_images)
    input_images = [input_images[x - 1] for x in image_ids]

    all_ids, spans = [], []
    for i, chunk in enumerate(chunks):
        all_ids.extend(chunk)
        if i != len(chunks) - 1:
            start = len(all_ids)
            size = (input_images[i].shape[-2] * input_images[i].shape[-1]
                    // 16 // 16)
            spans.append([start, start + size])
            all_ids.extend([0] * size)
    return {"input_ids": all_ids, "pixel_values": input_images,
            "image_sizes": spans}


def create_position(attention_mask, num_tokens_for_output_images):
    """Zero over the left pad, then 0 .. L + image tokens (the time token
    included)."""
    text_length = attention_mask.shape[-1]
    img_length = max(num_tokens_for_output_images)
    out = []
    for mask in attention_mask:
        temp_l = int(mask.sum())
        out.append([0] * (text_length - temp_l)
                   + list(range(temp_l + img_length + 1)))
    return np.asarray(out, np.int64)


def create_mask(attention_mask, num_tokens_for_output_images):
    """The per-sample block mask — causal over the text, full
    bidirectional over [time | image] tokens, pad rows all-ones/cols zero,
    overhang image columns zeroed."""
    extended, padding_images = [], []
    text_length = attention_mask.shape[-1]
    img_length = max(num_tokens_for_output_images)
    seq_len = text_length + img_length + 1
    for inx, mask in enumerate(attention_mask):
        temp_l = int(mask.sum())
        pad_l = text_length - temp_l
        m = np.tril(np.ones((temp_l + 1, temp_l + 1), np.float32))
        m = np.concatenate([m, np.zeros((temp_l + 1, img_length),
                                        np.float32)], axis=-1)
        m = np.concatenate(
            [m, np.ones((img_length, temp_l + img_length + 1), np.float32)],
            axis=0)
        if pad_l > 0:
            m = np.concatenate([np.zeros((temp_l + 1 + img_length, pad_l),
                                         np.float32), m], axis=-1)
            m = np.concatenate([np.ones((pad_l, seq_len), np.float32), m],
                               axis=0)
        pad_img = img_length - num_tokens_for_output_images[inx]
        if pad_img > 0:
            m[:, -pad_img:] = 0
            padding_images.append(np.zeros((1, pad_img), np.float32))
        else:
            padding_images.append(None)
        extended.append(m[None])
    return np.concatenate(extended, axis=0), padding_images


def adjust_attention_for_input_images(attention_mask, image_sizes):
    """Reference-image spans attend within themselves both ways."""
    for b_inx in image_sizes.keys():
        for start, end in image_sizes[b_inx]:
            attention_mask[b_inx][start:end, start:end] = 1
    return attention_mask


def pad_input_ids(input_ids, image_sizes, pad_token_id=2):
    """Left padding; the image spans shifted by the pad."""
    max_l = max(len(x) for x in input_ids)
    padded, mask = [], []
    for i, ids in enumerate(input_ids):
        pad_l = max_l - len(ids)
        padded.append([pad_token_id] * pad_l + list(ids))
        mask.append([0] * pad_l + [1] * len(ids))
        if i in image_sizes and pad_l:
            image_sizes[i] = [[x + pad_l for x in span]
                              for span in image_sizes[i]]
    return (np.asarray(padded, np.int64), np.asarray(mask, np.int64),
            image_sizes)


def process_mllm_input(mllm_inputs, target_img_size, pad_token_id=2):
    """The collator: padded ids, position ids, the block mask, the image
    spans."""
    num_img_tokens = [h * w // 16 // 16 for (h, w) in target_img_size]
    pixel_values, image_sizes = [], {}
    for b_inx, x in enumerate(mllm_inputs):
        if x["pixel_values"] is not None:
            pixel_values.extend(x["pixel_values"])
            image_sizes.setdefault(b_inx, []).extend(x["image_sizes"])
    input_ids = [x["input_ids"] for x in mllm_inputs]
    padded, attn1d, image_sizes = pad_input_ids(input_ids, image_sizes,
                                                pad_token_id)
    position_ids = create_position(attn1d, num_img_tokens)
    mask, padding_images = create_mask(attn1d, num_img_tokens)
    mask = adjust_attention_for_input_images(mask, image_sizes)
    return padded, position_ids, mask, padding_images, pixel_values, \
        image_sizes


class OmniGenPrompter:
    """The prompter with the separate-CFG collator. `tokenize` is a callable
    str -> list[int] (an HF tokenizer's .encode)."""

    def __init__(self, tokenize, max_image_size=1024):
        self.tokenize = tokenize
        self.max_image_size = max_image_size

    def process_image(self, image):
        arr = crop_arr(image, self.max_image_size)
        arr = arr.astype(np.float32) / 255.0
        arr = (arr - 0.5) / 0.5
        return arr.transpose(2, 0, 1)[None]  # (1, 3, H, W)

    def __call__(self, prompt, input_images=None, height=1024, width=1024,
                 negative_prompt=NEGATIVE_PROMPT, use_img_cfg=True):
        """The separate-CFG layout: a dict of per-branch lists [cond, uncond
        (, img_cond)]. input_images: (H, W, 3) uint8 arrays (or PIL images)."""
        if input_images is None:
            use_img_cfg = False
        if input_images:
            imgs = [self.process_image(x) for x in input_images]
        else:
            imgs = None
        mllm = process_multi_modal_prompt(prompt, imgs, self.tokenize)
        neg = process_multi_modal_prompt(negative_prompt, None, self.tokenize)
        branches = [mllm, neg]
        if use_img_cfg:
            img_prompt = " ".join(f"<img><|image_{i + 1}|></img>"
                                  for i in range(len(imgs))) if imgs else None
            branches.append(process_multi_modal_prompt(
                img_prompt, imgs, self.tokenize) if imgs else neg)

        out = {"input_ids": [], "attention_mask": [], "position_ids": [],
               "input_pixel_values": [], "input_image_sizes": []}
        for br in branches:
            padded, pos, mask, _, pix, sizes = process_mllm_input(
                [br], [[height, width]])
            out["input_ids"].append(padded)
            out["position_ids"].append(pos)
            out["attention_mask"].append(mask)
            out["input_pixel_values"].append(pix)
            out["input_image_sizes"].append(sizes)
        return out
