"""Enhanced DDIM scheduler, port of svi_tpu/schedulers/ddim.py (the SD 1.5
family's sampler): scaled-linear or linear betas, optional zero-terminal-SNR
rescale, epsilon or v-prediction, timesteps spaced over 999 ... 0.

The tables are built in numpy as the JAX package builds them, so timesteps
and alphas are the same numbers; `step`, `add_noise`, `return_to_timestep`
and `training_target` take torch tensors (or numpy arrays) on any device and
weigh them with Python floats.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _scalar(timestep) -> float:
    if isinstance(timestep, torch.Tensor):
        return float(timestep.reshape(-1)[0].item())
    return float(np.asarray(timestep).reshape(-1)[0])


class EnhancedDDIMScheduler:
    def __init__(self, num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
                 beta_schedule="scaled_linear", prediction_type="epsilon",
                 rescale_zero_terminal_snr=False):
        self.num_train_timesteps = num_train_timesteps
        self.beta_schedule = beta_schedule
        if beta_schedule == "scaled_linear":
            betas = np.square(np.linspace(math.sqrt(beta_start), math.sqrt(beta_end),
                                          num_train_timesteps, dtype=np.float32))
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
        else:
            raise NotImplementedError(f"{beta_schedule} is not implemented")
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        if rescale_zero_terminal_snr:
            alphas_cumprod = self._rescale_zero_terminal_snr(alphas_cumprod)
        self.alphas_cumprod = alphas_cumprod.tolist()
        self.set_timesteps(10)
        self.prediction_type = prediction_type

    @staticmethod
    def _rescale_zero_terminal_snr(alphas_cumprod):
        """Shift and scale sqrt(alpha_bar) so that the last timestep has zero SNR."""
        s = np.sqrt(alphas_cumprod)
        s0, sT = s[0].copy(), s[-1].copy()
        s = s - sT
        s = s * s0 / (s0 - sT)
        return np.square(s)

    def set_timesteps(self, num_inference_steps, denoising_strength=1.0, **kwargs):
        """`timesteps`: a float32 numpy array, from round(1000 * strength) - 1
        down to 0 in equal steps, rounded."""
        max_timestep = max(round(self.num_train_timesteps * denoising_strength) - 1, 0)
        num_inference_steps = min(num_inference_steps, max_timestep + 1)
        if num_inference_steps == 1:
            self.timesteps = np.array([max_timestep], np.float32)
        else:
            step_length = max_timestep / (num_inference_steps - 1)
            self.timesteps = np.array(
                [round(max_timestep - i * step_length) for i in range(num_inference_steps)],
                np.float32)

    def _denoise(self, model_output, sample, a_t, a_prev):
        if self.prediction_type == "epsilon":
            weight_e = math.sqrt(1 - a_prev) - math.sqrt(a_prev * (1 - a_t) / a_t)
            weight_x = math.sqrt(a_prev / a_t)
        elif self.prediction_type == "v_prediction":
            weight_e = -math.sqrt(a_prev * (1 - a_t)) + math.sqrt(a_t * (1 - a_prev))
            weight_x = math.sqrt(a_t * a_prev) + math.sqrt((1 - a_t) * (1 - a_prev))
        else:
            raise NotImplementedError(f"{self.prediction_type} is not implemented")
        return sample * weight_x + model_output * weight_e

    def step(self, model_output, timestep, sample, to_final=False):
        t = _scalar(timestep)
        a_t = self.alphas_cumprod[int(t)]
        timestep_id = int(np.argmin(np.abs(self.timesteps - t)))
        if to_final or timestep_id + 1 >= len(self.timesteps):
            a_prev = 1.0
        else:
            a_prev = self.alphas_cumprod[int(self.timesteps[timestep_id + 1])]
        return self._denoise(model_output, sample, a_t, a_prev)

    def return_to_timestep(self, timestep, sample, sample_stabilized):
        a_t = self.alphas_cumprod[int(_scalar(timestep))]
        return (sample - math.sqrt(a_t) * sample_stabilized) / math.sqrt(1 - a_t)

    def add_noise(self, original_samples, noise, timestep):
        a_t = self.alphas_cumprod[int(_scalar(timestep))]
        return math.sqrt(a_t) * original_samples + math.sqrt(1 - a_t) * noise

    def training_target(self, sample, noise, timestep):
        if self.prediction_type == "epsilon":
            return noise
        a_t = self.alphas_cumprod[int(_scalar(timestep))]
        return math.sqrt(a_t) * noise - math.sqrt(1 - a_t) * sample

    def training_weight(self, timestep):
        return 1.0
