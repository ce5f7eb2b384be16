"""Omost region prompter, port of svi_tpu/prompters/omost.py: parse the
`Canvas` program an LLM writes into a background colour sketch, region
masks and prompts.

The vocabulary tables are svi_tpu's: the CSS colour names (Pillow's
`ImageColor` table plus 'navyblue', read at first use, so that importing
this module loads no Pillow), locations, offsets and areas on a 90 x 90
grid. `Canvas` is the DSL (global and local descriptions, rectangle layout,
furthest-first compositing at 0.7 new / 0.3 old); `OmostPromter` chats the
program out of an LLM, injected as `chat_fn(conversation) -> str` or built
by `from_model_manager` with `transformers` (imported there) from a local
checkpoint. Everything after the generation is numpy.
"""

from __future__ import annotations

import difflib
import functools
import re

import numpy as np


@functools.lru_cache(maxsize=None)
def _css_colors() -> dict:
    from PIL import ImageColor

    colors = {name: ImageColor.getrgb(value)
              for name, value in ImageColor.colormap.items()}
    colors["navyblue"] = (0, 0, 128)  # not a CSS3 name, but in the vocabulary
    return colors


def __getattr__(name):
    # `valid_colors`, svi_tpu's module-level table, built at first use
    if name == "valid_colors":
        return _css_colors()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# 90x90 canvas grid anchors
valid_locations = {
    "in the center": (45, 45), "on the left": (15, 45),
    "on the right": (75, 45), "on the top": (45, 15),
    "on the bottom": (45, 75), "on the top-left": (15, 15),
    "on the top-right": (75, 15), "on the bottom-left": (15, 75),
    "on the bottom-right": (75, 75),
}

valid_offsets = {
    "no offset": (0, 0), "slightly to the left": (-10, 0),
    "slightly to the right": (10, 0), "slightly to the upper": (0, -10),
    "slightly to the lower": (0, 10), "slightly to the upper-left": (-10, -10),
    "slightly to the upper-right": (10, -10),
    "slightly to the lower-left": (-10, 10),
    "slightly to the lower-right": (10, 10),
}

valid_areas = {
    "a small square area": (50, 50), "a small vertical area": (40, 60),
    "a small horizontal area": (60, 40),
    "a medium-sized square area": (60, 60),
    "a medium-sized vertical area": (50, 80),
    "a medium-sized horizontal area": (80, 50),
    "a large square area": (70, 70), "a large vertical area": (60, 90),
    "a large horizontal area": (90, 60),
}


def safe_str(x: str) -> str:
    return x.strip(",. ") + "."


def closest_name(input_str: str, options: dict) -> str:
    """Fuzzy-correct a vocabulary key."""
    input_str = input_str.lower()
    match = difflib.get_close_matches(input_str, list(options), n=1, cutoff=0.5)
    if not match:
        raise ValueError(f"The value [{input_str}] is not valid!")
    if match[0] != input_str:
        print(f"Automatically corrected [{input_str}] -> [{match[0]}].")
    return match[0]


class Canvas:
    """The DSL object the LLM's generated Python manipulates."""

    @staticmethod
    def from_bot_response(response: str) -> "Canvas":
        matched = re.search(r"```python\n(.*?)\n```", response, re.DOTALL)
        if not matched:
            raise ValueError("Response does not contain codes!")
        code = matched.group(1)
        if "canvas = Canvas()" not in code:
            raise ValueError("Code block must include valid canvas var!")
        scope = {"Canvas": Canvas}
        exec(code, {}, scope)
        canvas = scope.get("canvas")
        if not isinstance(canvas, Canvas):
            raise ValueError("Code block must produce valid canvas var!")
        return canvas

    def __init__(self):
        self.components = []
        self.color = None
        self.record_tags = True
        self.prefixes = []
        self.suffixes = []

    def set_global_description(self, description, detailed_descriptions, tags,
                               HTML_web_color_name):
        color_name = closest_name(HTML_web_color_name, _css_colors())
        self.color = np.array([[_css_colors()[color_name]]], dtype=np.uint8)
        self.prefixes = [safe_str(description)]
        suffixes = list(detailed_descriptions)
        if self.record_tags:
            suffixes = suffixes + [tags]
        self.suffixes = [safe_str(x) for x in suffixes]

    def add_local_description(self, location, offset, area, distance_to_viewer,
                              description, detailed_descriptions, tags,
                              atmosphere, style, quality_meta,
                              HTML_web_color_name):
        if not (isinstance(distance_to_viewer, (int, float))
                and distance_to_viewer > 0):
            raise ValueError(
                f"The distance_to_viewer for [{description}] is not positive "
                "float number!")
        location = closest_name(location, valid_locations)
        offset = closest_name(offset, valid_offsets)
        area = closest_name(area, valid_areas)
        color_name = closest_name(HTML_web_color_name, _css_colors())

        xb, yb = valid_locations[location]
        xo, yo = valid_offsets[offset]
        w, h = valid_areas[area]
        # the rect is (row_lo, row_hi, col_lo, col_hi): both row bounds use
        # the y anchor, both column bounds the x anchor
        rect = (yb + yo - h // 2, yb + yo + h // 2,
                xb + xo - w // 2, xb + xo + w // 2)
        rect = [max(0, min(90, v)) for v in rect]

        suffixes = list(detailed_descriptions)
        if self.record_tags:
            suffixes = suffixes + [tags, atmosphere, style, quality_meta]

        self.components.append(dict(
            rect=rect,
            distance_to_viewer=distance_to_viewer,
            color=np.array([[_css_colors()[color_name]]], dtype=np.uint8),
            prefixes=[safe_str(x) for x in self.prefixes + [description]],
            suffixes=[safe_str(x) for x in suffixes],
            location=location,
        ))

    def process(self) -> dict:
        """Furthest-first composite sketch + full/region condition masks."""
        self.components = sorted(self.components,
                                 key=lambda c: c["distance_to_viewer"],
                                 reverse=True)
        sketch = np.zeros((90, 90, 3), np.float32) + self.color
        for comp in self.components:
            a, b, c, d = comp["rect"]
            sketch[a:b, c:d] = 0.7 * comp["color"] + 0.3 * sketch[a:b, c:d]
        sketch = sketch.clip(0, 255).astype(np.uint8)

        conditions = [dict(mask=np.ones((90, 90), np.float32),
                           prefixes=self.prefixes, suffixes=self.suffixes,
                           location="full")]
        for comp in self.components:
            a, b, c, d = comp["rect"]
            mask = np.zeros((90, 90), np.float32)
            mask[a:b, c:d] = 1.0
            conditions.append(dict(mask=mask, prefixes=comp["prefixes"],
                                   suffixes=comp["suffixes"],
                                   location=comp["location"]))
        return dict(initial_latent=sketch, bag_of_conditions=conditions)


# The system prompt handed to the canvas-composing LLM
OMOST_SYSTEM_TEMPLATE = r'''You are a helpful AI assistant to compose images using the below python class `Canvas`:
            ```python
            class Canvas:
                def set_global_description(self, description: str, detailed_descriptions: list[str], tags: str, HTML_web_color_name: str):
                    pass

                def add_local_description(self, location: str, offset: str, area: str, distance_to_viewer: float, description: str, detailed_descriptions: list[str], tags: str, atmosphere: str, style: str, quality_meta: str, HTML_web_color_name: str):
                    assert location in ["in the center", "on the left", "on the right", "on the top", "on the bottom", "on the top-left", "on the top-right", "on the bottom-left", "on the bottom-right"]
                    assert offset in ["no offset", "slightly to the left", "slightly to the right", "slightly to the upper", "slightly to the lower", "slightly to the upper-left", "slightly to the upper-right", "slightly to the lower-left", "slightly to the lower-right"]
                    assert area in ["a small square area", "a small vertical area", "a small horizontal area", "a medium-sized square area", "a medium-sized vertical area", "a medium-sized horizontal area", "a large square area", "a large vertical area", "a large horizontal area"]
                    assert distance_to_viewer > 0
                    pass
            ```'''


def canvas_to_prompt_dict(canvas: Canvas, prompt_dict: dict) -> dict:
    """The global prompt, the per-region prompts and the PIL region masks of
    a processed canvas, merged into prompt_dict."""
    from PIL import Image

    out = canvas.process()
    prompts = [" ".join(c["prefixes"] + c["suffixes"][:2])
               for c in out["bag_of_conditions"]]
    out["prompt"] = prompts[0]
    out["prompts"] = prompts[1:]
    masks = []
    for cond in out["bag_of_conditions"]:
        mask = cond["mask"].copy()
        mask[mask > 0.5] = 255
        masks.append(Image.fromarray(
            np.stack([mask] * 3, axis=-1).astype("uint8")))
    out["masks"] = masks
    prompt_dict.update(out)
    return prompt_dict


class OmostPromter:
    """Prompt extender (svi_tpu's class-name spelling is kept).
    `chat_fn(conversation) -> str` runs the LLM; conversation is
    [{'role', 'content'}, ...] chat messages."""

    def __init__(self, chat_fn=None, template=OMOST_SYSTEM_TEMPLATE):
        self.chat_fn = chat_fn
        self.template = template

    @staticmethod
    def from_model_manager(model_manager):
        """fetch_model('omost_prompt') must yield a causal-LM checkpoint
        path; transformers loads it from there (local files only)."""
        from transformers import AutoModelForCausalLM, AutoTokenizer

        _, model_path = model_manager.fetch_model("omost_prompt",
                                                  require_model_path=True)
        tokenizer = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
        model = AutoModelForCausalLM.from_pretrained(model_path, local_files_only=True).eval()

        def chat_fn(conversation):
            import torch

            input_ids = tokenizer.apply_chat_template(
                conversation, return_tensors="pt", add_generation_prompt=True)
            with torch.no_grad():
                output = model.generate(
                    input_ids=input_ids, do_sample=True,
                    attention_mask=torch.ones_like(input_ids),
                    pad_token_id=tokenizer.eos_token_id)
            return tokenizer.decode(output[0, input_ids.shape[1]:],
                                    skip_special_tokens=True)

        return OmostPromter(chat_fn=chat_fn)

    def __call__(self, prompt_dict: dict) -> dict:
        conversation = [{"role": "system", "content": self.template},
                        {"role": "user", "content": prompt_dict["prompt"]}]
        response = self.chat_fn(conversation)
        canvas = Canvas.from_bot_response(response)
        out = canvas_to_prompt_dict(canvas, prompt_dict)
        print("Your prompt is extended by Omost:\n")
        for i, (comp, pmt) in enumerate(zip(out["bag_of_conditions"],
                                            [out["prompt"]] + out["prompts"])):
            print(f"Component {i + 1} - Location : {comp['location']}\n"
                  f"Prompt:{pmt}\n")
        return out
