#!/bin/bash
# SVI-Dance training: trainable dwpose_embedding conv stack on top of the shot
# recipe, warm-started from the UniAnimate LoRA (ref scripts/train/svi_dance.sh).
# The port's recipe (PyTorch on the card): the flags of scripts/train/svi_dance.sh,
# run from the repository's root.
W=./weights/Wan2.1-I2V-14B-480P
python -m svi_tpu_torch.scripts.train_svi_dance \
  --learning_rate 1e-4 \
  --lora_rank 128 \
  --lora_alpha 128 \
  --dataset_path data/toy_train/svi-dance/preprocessed/ \
  --dit_path "$W" \
  --vae_path "$W/Wan2.1_VAE.pth" \
  --text_encoder_path "$W/models_t5_umt5-xxl-enc-bf16.pth" \
  --image_encoder_path "$W/models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth" \
  --pretrained_lora_path ./weights/UniAnimate-DiT/UniAnimate-Wan2.1-14B-Lora-12000.ckpt \
  --max_epochs 20 \
  --train_architecture lora \
  --use_gradient_checkpointing \
  --training_strategy data_parallel \
  --output_path "./experiments/train/svi-dance/" \
  --use_error_recycling \
  --error_buffer_k 500 \
  --y_error_num 1 \
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
  --exp_prefix svi-dance
