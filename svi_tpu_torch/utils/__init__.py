"""Host utilities of the port: safetensors files, prompt files, reference
images, pose and audio inputs, video input and output."""
