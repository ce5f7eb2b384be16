"""Prompt processing of the port: the umT5 sentencepiece tokenizer and Wan's
prompter."""
