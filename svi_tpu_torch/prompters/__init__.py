"""Prompt processing of the port: each family's prompter, the tokenizers,
and the prompt tools (refiners, translators, Omost). svi_tpu's exports,
imported at first access."""

from .._exports import lazy_exports

_EXPORTS = {
    "BasePrompter": "base_prompter",
    "tokenize_long_prompt": "base_prompter",
    "CogPrompter": "cog_prompter",
    "FluxPrompter": "flux_prompter",
    "HunyuanDiTPrompter": "hunyuan_dit_prompter",
    "HunyuanVideoPrompter": "hunyuan_video_prompter",
    "KolorsPrompter": "kolors_prompter",
    "OmniGenPrompter": "omnigen_prompter",
    "OmostPromter": "omost",
    "BeautifulPrompt": "prompt_refiners",
    "QwenPrompt": "prompt_refiners",
    "Translator": "prompt_refiners",
    "SD3Prompter": "sd3_prompter",
    "SDPrompter": "sd_prompter",
    "SDXLPrompter": "sdxl_prompter",
    "StepVideoPrompter": "stepvideo_prompter",
    "WanPrompter": "wan_prompter",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
