#!/bin/bash
# SVI-Dance inference: pose-conditioned animation (ref scripts/test/svi_dance.sh).
# The port's recipe (PyTorch on the card): the flags of scripts/test/svi_dance.sh,
# run from the repository's root. Where Pillow or a video reader is missing,
# give the images and the pose video as .npy and add --save_format npy.
python -m svi_tpu_torch.scripts.test_svi_dance \
  --output videos/svi_dance \
  --dit_root ./weights/Wan2.1-I2V-14B-480P/ \
  --cfg_scale_text 2.0 \
  --ref_pad_num -1 \
  --num_clips 10 \
  --num_steps 50 \
  --num_motion_frames 1 \
  --image_path data/toy_test/dance/image.png \
  --pose_path data/toy_test/dance/pose.mp4 \
  --extra_module_root weights/Stable-Video-Infinity/version-1.0/svi-dance.safetensors
