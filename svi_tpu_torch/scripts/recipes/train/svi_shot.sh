#!/bin/bash
# Error-Recycling LoRA training, SVI-Shot config (ref scripts/train/svi_shot.sh;
# same hyperparameters). --training_strategy data_parallel trains on one card;
# sp and dataxsp raise in the port until it has its multi-card path.
# The port's recipe (PyTorch on the card): the flags of scripts/train/svi_shot.sh,
# run from the repository's root.
W=./weights/Wan2.1-I2V-14B-480P
python -m svi_tpu_torch.scripts.train_svi \
  --learning_rate 1e-4 \
  --lora_rank 128 \
  --lora_alpha 128 \
  --dataset_path data/toy_train/svi-film-shot/ \
  --dit_path "$W" \
  --vae_path "$W/Wan2.1_VAE.pth" \
  --text_encoder_path "$W/models_t5_umt5-xxl-enc-bf16.pth" \
  --image_encoder_path "$W/models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth" \
  --max_epochs 10 \
  --train_architecture lora \
  --use_gradient_checkpointing \
  --training_strategy data_parallel \
  --output_path "./experiments/train/svi-shot" \
  --use_error_recycling \
  --error_buffer_k 500 \
  --y_error_num 3 \
  --num_motion_frames 1 \
  --buffer_warmup_iter 50 \
  --buffer_replacement_strategy l2_batch \
  --y_error_sample_from_all_grids \
  --num_grids 50 \
  --ref_pad_num -1 \
  --noise_prob 0.01 \
  --y_prob 0.9 \
  --latent_prob 0.9 \
  --clean_prob 0.2 \
  --clean_buffer_update_prob 0.1 \
  --exp_prefix train-svi-shot
