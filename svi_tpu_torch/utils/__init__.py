"""Host utilities of the port: safetensors files, prompt files, reference
images, video output."""
