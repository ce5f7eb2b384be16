"""Rectified-flow ("flow match") scheduler, port of svi_tpu/schedulers/flow_match.py:
the schedule table of training (`make_schedule`) and the inference scheduler.

The SVI pipeline uses it with shift=5, sigma_min=0.0, extra_one_step=True and
num_train_timesteps=1000. The sigma table is computed in float64 on the host
and stored as float32 CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """Sigma/timestep table; f32 CPU tensors."""

    sigmas: torch.Tensor  # (num_steps,)
    timesteps: torch.Tensor  # (num_steps,) = sigmas * num_train_timesteps
    num_train_timesteps: int = 1000
    training_weights: Optional[torch.Tensor] = None  # set when built with training=True


def make_schedule(num_inference_steps: int, shift: float = 3.0,
                  sigma_min: float = 0.003 / 1.002, denoising_strength: float = 1.0,
                  extra_one_step: bool = False, num_train_timesteps: int = 1000,
                  training: bool = False) -> FlowMatchSchedule:
    """The sigma table (port of `make_schedule`), computed in float64 and
    stored as float32: sigma' = shift * sigma / (1 + (shift - 1) * sigma).
    With training=True, the Gaussian bell of the training weights, evaluated
    (as the reference does) on the timestep values against
    num_inference_steps / 2."""
    sigma_start = sigma_min + (1.0 - sigma_min) * denoising_strength
    if extra_one_step:
        sigmas = np.linspace(sigma_start, sigma_min, num_inference_steps + 1,
                             dtype=np.float64)[:-1]
    else:
        sigmas = np.linspace(sigma_start, sigma_min, num_inference_steps, dtype=np.float64)
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    timesteps = sigmas * num_train_timesteps
    weights = None
    if training:
        y = np.exp(-2 * ((timesteps - num_inference_steps / 2) / num_inference_steps) ** 2)
        y_shifted = y - y.min()
        weights = torch.from_numpy(
            (y_shifted * (num_inference_steps / y_shifted.sum())).astype(np.float32))
    return FlowMatchSchedule(
        sigmas=torch.from_numpy(sigmas.astype(np.float32)),
        timesteps=torch.from_numpy(timesteps.astype(np.float32)),
        num_train_timesteps=num_train_timesteps, training_weights=weights)


class FlowMatchScheduler:
    def __init__(self, num_inference_steps=100, num_train_timesteps=1000, shift=3.0,
                 sigma_min=0.003 / 1.002, extra_one_step=False):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.sigma_min = sigma_min
        self.extra_one_step = extra_one_step
        self.set_timesteps(num_inference_steps)

    def set_timesteps(self, num_inference_steps=100, denoising_strength=1.0, shift=None):
        """The `make_schedule` table for this scheduler's settings."""
        if shift is not None:
            self.shift = shift
        table = make_schedule(num_inference_steps, shift=self.shift, sigma_min=self.sigma_min,
                              denoising_strength=denoising_strength,
                              extra_one_step=self.extra_one_step,
                              num_train_timesteps=self.num_train_timesteps)
        self.sigmas, self.timesteps = table.sigmas, table.timesteps

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor, timestep) -> torch.Tensor:
        """Interpolate toward noise at sigma(t), t resolved to the nearest entry."""
        tid = int(torch.argmin((self.timesteps - float(timestep)).abs()))
        sigma = self.sigmas[tid].to(original_samples.device)  # f32, as in the JAX package
        out = (1 - sigma) * original_samples.float() + sigma * noise.float()
        return out.to(original_samples.dtype)
