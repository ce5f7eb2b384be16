"""Command-line drivers of the port (`python -m svi_tpu_torch.scripts.<name>`)."""
