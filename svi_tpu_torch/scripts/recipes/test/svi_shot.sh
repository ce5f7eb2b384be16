#!/bin/bash
# SVI-Shot inference: single motion frame, full reference padding (ref
# scripts/test/svi_shot.sh). Same flags as the reference driver; weights are
# the official Wan2.1-I2V-14B-480P checkpoint dir + the SVI LoRA module.
# The port's recipe (PyTorch on the card): the flags of scripts/test/svi_shot.sh,
# run from the repository's root. Where Pillow or a video reader is missing,
# give the images and the pose video as .npy and add --save_format npy.
python -m svi_tpu_torch.scripts.test_svi \
  --output videos/svi_shot/ \
  --dit_root ./weights/Wan2.1-I2V-14B-480P/ \
  --ref_pad_num -1 \
  --cfg_scale_text 5.0 \
  --num_motion_frames 1 \
  --ref_image_path data/toy_test/shot/frame.jpg \
  --prompt_path data/toy_test/shot/prompt.txt \
  --use_first_prompt_only \
  --extra_module_root weights/Stable-Video-Infinity/version-1.0/svi-shot.safetensors
