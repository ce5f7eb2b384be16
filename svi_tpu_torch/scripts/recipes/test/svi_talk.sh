#!/bin/bash
# SVI-Talk inference: audio-driven talking head (ref scripts/test/svi_talk.sh).
# Requires the multitalk side weights in --dit_root and a local wav2vec2 dir.
# The port's recipe (PyTorch on the card): the flags of scripts/test/svi_talk.sh,
# run from the repository's root. Where Pillow or a video reader is missing,
# give the images and the pose video as .npy and add --save_format npy.
python -m svi_tpu_torch.scripts.test_svi_talk \
  --output videos/svi_talk/ \
  --dit_root ./weights/Wan2.1-I2V-14B-480P/ \
  --ref_pad_num -1 \
  --num_clips 50 \
  --num_motion_frames 1 \
  --ref_image_path data/toy_test/talk/obama.png \
  --audio_path data/toy_test/talk/obama_5min.wav \
  --extra_module_root weights/Stable-Video-Infinity/version-1.0/svi-talk.safetensors
