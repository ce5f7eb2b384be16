"""Prompt-stream files (port of svi_tpu/utils/prompt_files.py).

A prompt.txt holds a `prompts = [...]` list literal, which is parsed with
`ast.literal_eval` (never executed), or one prompt per line, `#` lines
skipped."""

from __future__ import annotations

import ast
import os

DEFAULT_PROMPT = "Default prompt: the subject is moving naturally"


def load_prompts_from_file(prompt_file_path: str) -> list[str]:
    if not os.path.exists(prompt_file_path):
        return [DEFAULT_PROMPT]
    try:
        with open(prompt_file_path, "r", encoding="utf-8") as f:
            content = f.read()
        if "prompts = [" in content:
            start = content.find("prompts = [")
            lit = content[start + len("prompts = "):]
            # the list literal ends at its matching closing bracket
            depth = 0
            for i, ch in enumerate(lit):
                if ch == "[":
                    depth += 1
                elif ch == "]":
                    depth -= 1
                    if depth == 0:
                        lit = lit[:i + 1]
                        break
            prompts = ast.literal_eval(lit)
            if isinstance(prompts, list) and prompts:
                return [str(p) for p in prompts]
        lines = [ln.strip() for ln in content.split("\n")
                 if ln.strip() and not ln.strip().startswith("#")]
        return lines if lines else [DEFAULT_PROMPT]
    except (OSError, UnicodeDecodeError, ValueError, TypeError, SyntaxError):
        return [DEFAULT_PROMPT]
