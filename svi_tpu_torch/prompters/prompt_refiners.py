"""Prompt refiners, port of svi_tpu/prompters/prompt_refiners.py:
`BeautifulPrompt` (a causal LM's completion appended to the raw prompt, the
v1 / v2 template chosen by the checkpoint's path), `QwenPrompt` (a chat
model rewrites the prompt under a fixed system prompt) and `Translator`
(seq2seq translation of positive and negative prompts).

The generators are host tooling, injected as `generate_fn(text) -> str`,
`chat_fn(messages) -> str` and `translate_fn(text) -> str`, so the prompt
assembly runs without checkpoints. `from_model_manager` builds them with
`transformers` (imported there, not at the top) from the local path the
ModelManager recorded; nothing is downloaded.
"""

from __future__ import annotations

# the template of the v1 BeautifulPrompt checkpoint
BEAUTIFUL_PROMPT_TEMPLATE_V1 = (
    "Instruction: Give a simple description of the image to generate a "
    "drawing prompt.\nInput: {raw_prompt}\nOutput:")

# the template of the v2 checkpoint
BEAUTIFUL_PROMPT_TEMPLATE_V2 = (
    "Converts a simple image description into a prompt. Prompts are formatted"
    " as multiple related tags separated by commas, plus you can use () to "
    "increase the weight, [] to decrease the weight, or use a number to "
    "specify the weight. You should add appropriate words to make the images "
    "described in the prompt more aesthetically pleasing, but make sure "
    "there is a correlation between the input and output.\n"
    "### Input: {raw_prompt}\n### Output:")

# the system prompt of the Qwen refiner checkpoint
QWEN_SYSTEM_PROMPT = """You are an English image describer. Here are some example image styles:\n\n1. Extreme close-up: Clear focus on a single object with a blurred background, highlighted under natural sunlight.\n2. Vintage: A photograph of a historical scene, using techniques such as Daguerreotype or cyanotype.\n3. Anime: A stylized cartoon image, emphasizing hyper-realistic portraits and luminous brushwork.\n4. Candid: A natural, unposed shot capturing spontaneous moments, often with cinematic qualities.\n5. Landscape: A photorealistic image of natural scenery, such as a sunrise over the sea.\n6. Design: Colorful and detailed illustrations, often in the style of 2D game art or botanical illustrations.\n7. Urban: An ultrarealistic scene in a modern setting, possibly a cityscape viewed from indoors.\n\nYour task is to translate a given Chinese image description into a concise and precise English description. Ensure that the imagery is vivid and descriptive, and include stylistic elements to enrich the description.\nPlease note the following points:\n\n1. Capture the essence and mood of the Chinese description without including direct phrases or words from the examples provided.\n2. You should add appropriate words to make the images described in the prompt more aesthetically pleasing. If the Chinese description does not specify a style, you need to add some stylistic descriptions based on the essence of the Chinese text.\n3. The generated English description should not exceed 200 words.\n\n"""


def beautiful_prompt_template_for(model_path: str) -> str:
    """v2 checkpoints (path ends with 'v2') use the tag-style template."""
    return (BEAUTIFUL_PROMPT_TEMPLATE_V2 if model_path.endswith("v2")
            else BEAUTIFUL_PROMPT_TEMPLATE_V1)


def _causal_generate_fn(model_path, max_new_tokens, sample_kwargs=None):
    """Build a `generate_fn(text) -> completion` over a local causal LM."""
    from transformers import AutoModelForCausalLM, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
    model = AutoModelForCausalLM.from_pretrained(model_path, local_files_only=True).eval()

    def generate_fn(text):
        import torch

        input_ids = tokenizer.encode(text, return_tensors="pt")
        with torch.no_grad():
            out = model.generate(input_ids, max_new_tokens=max_new_tokens,
                                 **(sample_kwargs or {}))
        return tokenizer.batch_decode(out[:, input_ids.shape[1]:],
                                      skip_special_tokens=True)[0]

    return generate_fn


class BeautifulPrompt:
    """Refines the positive prompt only: the raw prompt, ', ', then the LM's
    completion."""

    def __init__(self, generate_fn=None, template=BEAUTIFUL_PROMPT_TEMPLATE_V1):
        self.generate_fn = generate_fn
        self.template = template

    @staticmethod
    def from_model_manager(model_manager):
        _, model_path = model_manager.fetch_model("beautiful_prompt",
                                                  require_model_path=True)
        template = beautiful_prompt_template_for(model_path)
        generate_fn = _causal_generate_fn(
            model_path, max_new_tokens=384,
            sample_kwargs=dict(do_sample=True, temperature=0.9, top_k=50,
                               top_p=0.95, repetition_penalty=1.1,
                               num_return_sequences=1))
        return BeautifulPrompt(generate_fn=generate_fn, template=template)

    def __call__(self, raw_prompt, positive=True, **kwargs):
        if not positive:
            return raw_prompt
        completion = self.generate_fn(
            self.template.format(raw_prompt=raw_prompt))
        prompt = raw_prompt + ", " + completion.strip()
        print(f"Your prompt is refined by BeautifulPrompt: {prompt}")
        return prompt


class QwenPrompt:
    """The system prompt and the raw (Chinese) prompt as a chat; the model's
    reply replaces the positive prompt."""

    def __init__(self, chat_fn=None, system_prompt=QWEN_SYSTEM_PROMPT):
        self.chat_fn = chat_fn
        self.system_prompt = system_prompt

    @staticmethod
    def from_model_manager(model_manager):
        from transformers import AutoModelForCausalLM, AutoTokenizer

        _, model_path = model_manager.fetch_model("qwen_prompt",
                                                  require_model_path=True)
        tokenizer = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
        model = AutoModelForCausalLM.from_pretrained(model_path, local_files_only=True).eval()

        def chat_fn(messages):
            import torch

            text = tokenizer.apply_chat_template(messages, tokenize=False,
                                                 add_generation_prompt=True)
            inputs = tokenizer([text], return_tensors="pt")
            with torch.no_grad():
                out = model.generate(inputs.input_ids, max_new_tokens=512)
            return tokenizer.batch_decode(out[:, inputs.input_ids.shape[1]:],
                                          skip_special_tokens=True)[0]

        return QwenPrompt(chat_fn=chat_fn)

    def __call__(self, raw_prompt, positive=True, **kwargs):
        if not positive:
            return raw_prompt
        prompt = self.chat_fn([
            {"role": "system", "content": self.system_prompt},
            {"role": "user", "content": raw_prompt},
        ])
        print(f"Your prompt is refined by Qwen: {prompt}")
        return prompt


class Translator:
    """Seq2seq translation of both the positive and the negative prompt."""

    def __init__(self, translate_fn=None):
        self.translate_fn = translate_fn

    @staticmethod
    def from_model_manager(model_manager):
        from transformers import AutoModelForSeq2SeqLM, AutoTokenizer

        _, model_path = model_manager.fetch_model("translator",
                                                  require_model_path=True)
        tokenizer = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
        model = AutoModelForSeq2SeqLM.from_pretrained(model_path, local_files_only=True).eval()

        def translate_fn(text):
            import torch

            input_ids = tokenizer.encode(text, return_tensors="pt")
            with torch.no_grad():
                out = model.generate(input_ids)
            return tokenizer.batch_decode(out, skip_special_tokens=True)[0]

        return Translator(translate_fn=translate_fn)

    def __call__(self, prompt, **kwargs):
        prompt = self.translate_fn(prompt)
        print(f"Your prompt is translated: {prompt}")
        return prompt
