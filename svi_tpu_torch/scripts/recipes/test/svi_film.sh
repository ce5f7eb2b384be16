#!/bin/bash
# SVI-Film inference: 5 motion frames, no reference padding (ref
# scripts/test/svi_film.sh).
# The port's recipe (PyTorch on the card): the flags of scripts/test/svi_film.sh,
# run from the repository's root. Where Pillow or a video reader is missing,
# give the images and the pose video as .npy and add --save_format npy.
python -m svi_tpu_torch.scripts.test_svi \
  --output videos/svi_film/ \
  --dit_root ./weights/Wan2.1-I2V-14B-480P/ \
  --ref_pad_num 0 \
  --cfg_scale_text 5.0 \
  --num_motion_frames 5 \
  --ref_image_path data/toy_test/film/frame.jpg \
  --prompt_path data/toy_test/film/prompt.txt \
  --extra_module_root weights/Stable-Video-Infinity/version-1.0/svi-film-opt-10212025.safetensors
