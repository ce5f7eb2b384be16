"""LLM prompt extension for video generation, port of
svi_tpu/utils/prompt_extend.py: `PromptExpander` (the system prompt chosen
by language, vision input and multiple images; the seed; the `PromptOutput`
envelope), `DashScopePromptExpander` (the DashScope API, gated on the
dashscope package exactly as in svi_tpu) and `QwenPromptExpander` (a local
Qwen2.5 / Qwen2.5-VL model through `transformers`, imported and loaded at
first use from local files only).

The system prompts are svi_tpu's concise texts of the same intent; the
official texts can be given with `system_prompt=` or loaded from a JSON
file by `load_system_prompts`. An LLM rewriting a prompt is host-side
preprocessing, not part of the generation on the card.
"""

from __future__ import annotations

import json
import random
import sys
from dataclasses import dataclass
from typing import Optional


# Concise same-intent defaults (see module docstring), indexed by
# zh + (is_vl << 1) + (multi_img << 2).
LM_ZH_SYS_PROMPT = (
    "你是Prompt优化师。把用户输入改写为更完整、更具表现力的视频生成Prompt，"
    "不改变原意：补全主体特征、画面风格、空间关系、镜头景别，强调运动信息与"
    "运镜，输出中文，80-100字，保留引号/书名号内原文。直接输出改写结果。"
)
LM_EN_SYS_PROMPT = (
    "You are a prompt engineer. Rewrite the user's input into a complete, "
    "expressive video-generation prompt without changing its meaning: add "
    "subject details, visual style, spatial relations and shot scale, "
    "emphasize motion and camera moves, ~80-100 words in English, keep "
    "quoted text verbatim. Output only the rewritten prompt."
)
VL_ZH_SYS_PROMPT = (
    "你是Prompt优化师。结合用户提供的图像内容与输入Prompt，改写为更完整、"
    "更具表现力的视频生成Prompt，不改变原意；描述图像中的主体、风格与构图，"
    "补充自然的运动属性。输出中文，直接给出改写结果。"
)
VL_EN_SYS_PROMPT = (
    "You are a prompt engineer. Using the provided image and the user's "
    "prompt, write a complete, expressive video-generation prompt without "
    "changing the intent; describe the image's subject, style and "
    "composition and add natural motion. Output English text only."
)
VL_ZH_MULTI_SYS_PROMPT = VL_ZH_SYS_PROMPT + " 多张图像需综合全部画面内容。"
VL_EN_MULTI_SYS_PROMPT = VL_EN_SYS_PROMPT + " Consider ALL provided images."

SYSTEM_PROMPT_TYPES = {
    0: LM_EN_SYS_PROMPT,
    1: LM_ZH_SYS_PROMPT,
    2: VL_EN_SYS_PROMPT,
    3: VL_ZH_SYS_PROMPT,
    6: VL_EN_MULTI_SYS_PROMPT,
    7: VL_ZH_MULTI_SYS_PROMPT,
}


def load_system_prompts(path: str) -> None:
    """Load official system-prompt texts from a JSON file mapping the
    SYSTEM_PROMPT_TYPES indices (as strings) to prompt texts."""
    with open(path, "r", encoding="utf-8") as f:
        for k, v in json.load(f).items():
            SYSTEM_PROMPT_TYPES[int(k)] = v


@dataclass
class PromptOutput:
    """The result of an expansion."""

    status: bool
    prompt: str
    seed: int
    system_prompt: str
    message: str

    def add_custom_field(self, key: str, value) -> None:
        self.__setattr__(key, value)


class PromptExpander:
    """Dispatch base: picks the system prompt and the seed, then calls
    `extend` or `extend_with_img`."""

    def __init__(self, model_name, is_vl=False, device=0, **kwargs):
        self.model_name = model_name
        self.is_vl = is_vl
        self.device = device

    def extend_with_img(self, prompt, system_prompt, image=None, seed=-1,
                        *args, **kwargs):
        raise NotImplementedError

    def extend(self, prompt, system_prompt, seed=-1, *args, **kwargs):
        raise NotImplementedError

    def decide_system_prompt(self, tar_lang="zh", multi_images_input=False):
        zh = tar_lang == "zh"
        self.is_vl |= multi_images_input
        task_type = zh + (self.is_vl << 1) + (multi_images_input << 2)
        return SYSTEM_PROMPT_TYPES[task_type]

    def __call__(self, prompt, system_prompt=None, tar_lang="zh", image=None,
                 seed=-1, *args, **kwargs):
        if system_prompt is None:
            system_prompt = self.decide_system_prompt(
                tar_lang=tar_lang,
                multi_images_input=isinstance(image, (list, tuple)) and len(image) > 1,
            )
        if seed < 0:
            seed = random.randint(0, sys.maxsize)
        if image is not None and self.is_vl:
            return self.extend_with_img(prompt, system_prompt, image=image,
                                        seed=seed, *args, **kwargs)
        if not self.is_vl:
            return self.extend(prompt, system_prompt, seed, *args, **kwargs)
        raise NotImplementedError


class DashScopePromptExpander(PromptExpander):
    """Cloud expander over the DashScope API; gated on the dashscope package
    and an API key."""

    def __init__(self, api_key=None, model_name=None, is_vl=False,
                 retry_times=4, **kwargs):
        model_name = model_name or ("qwen-plus" if not is_vl else "qwen-vl-max")
        super().__init__(model_name, is_vl, **kwargs)
        self.retry_times = retry_times
        try:
            import dashscope
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "DashScopePromptExpander needs the dashscope package"
            ) from e
        self._dashscope = dashscope
        if api_key is not None:
            dashscope.api_key = api_key

    def extend(self, prompt, system_prompt, seed=-1, *args, **kwargs):
        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": prompt},
        ]
        exception = None
        for _ in range(self.retry_times):
            try:
                response = self._dashscope.Generation.call(
                    self.model_name, messages=messages, seed=seed,
                    result_format="message",
                )
                if response.status_code == 200:
                    expanded = response.output.choices[0].message.content
                    return PromptOutput(
                        status=True, prompt=expanded, seed=seed,
                        system_prompt=system_prompt,
                        message=json.dumps(response, ensure_ascii=False),
                    )
            except Exception as e:  # pragma: no cover - network path
                exception = e
        return PromptOutput(status=False, prompt=prompt, seed=seed,
                            system_prompt=system_prompt, message=str(exception))


class QwenPromptExpander(PromptExpander):
    """Local Qwen2.5(-VL) expander via transformers; the model loads at first
    use, so construction works without weights."""

    model_dict = {
        "QwenVL2.5_3B": "Qwen/Qwen2.5-VL-3B-Instruct",
        "QwenVL2.5_7B": "Qwen/Qwen2.5-VL-7B-Instruct",
        "Qwen2.5_3B": "Qwen/Qwen2.5-3B-Instruct",
        "Qwen2.5_7B": "Qwen/Qwen2.5-7B-Instruct",
        "Qwen2.5_14B": "Qwen/Qwen2.5-14B-Instruct",
    }

    def __init__(self, model_name=None, device=0, is_vl=False, **kwargs):
        if model_name is None:
            model_name = "Qwen2.5_14B" if not is_vl else "QwenVL2.5_7B"
        super().__init__(model_name, is_vl, device, **kwargs)
        import os

        if (not os.path.exists(self.model_name)) and self.model_name in self.model_dict:
            self.model_name = self.model_dict[self.model_name]
        self.model = None
        self.tokenizer = None

    def _load(self):
        if self.model is not None:
            return
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.model = AutoModelForCausalLM.from_pretrained(
            self.model_name, torch_dtype="auto", device_map="cpu", local_files_only=True
        )
        self.tokenizer = AutoTokenizer.from_pretrained(self.model_name, local_files_only=True)

    def extend(self, prompt, system_prompt, seed=-1, *args, **kwargs):
        self._load()
        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": prompt},
        ]
        text = self.tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )
        inputs = self.tokenizer([text], return_tensors="pt")
        generated = self.model.generate(**inputs, max_new_tokens=512)
        generated = [out[len(inp):] for inp, out in zip(inputs.input_ids, generated)]
        expanded = self.tokenizer.batch_decode(generated, skip_special_tokens=True)[0]
        return PromptOutput(
            status=True, prompt=expanded, seed=seed, system_prompt=system_prompt,
            message=json.dumps({"content": expanded}, ensure_ascii=False),
        )

    def _load_vl(self):
        if self.model is not None:
            return
        from transformers import AutoProcessor, AutoModelForVision2Seq

        self.processor = AutoProcessor.from_pretrained(self.model_name, local_files_only=True)
        self.model = AutoModelForVision2Seq.from_pretrained(
            self.model_name, torch_dtype="auto", device_map="cpu", local_files_only=True)

    def extend_with_img(self, prompt, system_prompt, image=None, seed=-1,
                        *args, **kwargs):
        """The Qwen2.5-VL path: the chat template and `qwen_vl.process_vision_info`
        through the processor."""
        import json as _json

        from .qwen_vl import process_vision_info

        self._load_vl()
        if not isinstance(image, (list, tuple)):
            image = [image]
        messages = [
            {"role": "system",
             "content": [{"type": "text", "text": system_prompt}]},
            {"role": "user",
             "content": [{"type": "text", "text": prompt},
                         *[{"type": "image", "image": im} for im in image]]},
        ]
        text = self.processor.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        image_inputs, video_inputs = process_vision_info(messages)
        inputs = self.processor(text=[text], images=image_inputs,
                                videos=video_inputs, padding=True,
                                return_tensors="pt")
        generated = self.model.generate(**inputs, max_new_tokens=512)
        trimmed = [out[len(inp):]
                   for inp, out in zip(inputs.input_ids, generated)]
        expanded = self.processor.batch_decode(
            trimmed, skip_special_tokens=True,
            clean_up_tokenization_spaces=False)[0]
        return PromptOutput(
            status=True, prompt=expanded, seed=seed,
            system_prompt=system_prompt,
            message=_json.dumps({"content": expanded}, ensure_ascii=False),
        )
