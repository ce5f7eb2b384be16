"""Continuous ODE (Karras-sigma) scheduler, port of
svi_tpu/schedulers/continuous_ode.py: the rho-warped sigma ramp from
sigma_max to sigma_min, the EDM-preconditioned Euler step, timesteps =
0.25 * log(sigma). `SVDVideoPipeline` is its only user.

The tables are built in numpy as the JAX package builds them, so sigmas and
timesteps are the same float32 numbers; `step`, `add_noise` and the training
functions take torch tensors (or numpy arrays) on any device and weigh them
with Python floats.
"""

from __future__ import annotations

import math

import numpy as np

from .ddim import _scalar


class ContinuousODEScheduler:
    def __init__(self, num_inference_steps=100, sigma_max=700.0, sigma_min=0.002, rho=7.0):
        self.sigma_max = sigma_max
        self.sigma_min = sigma_min
        self.rho = rho
        self.set_timesteps(num_inference_steps)

    def set_timesteps(self, num_inference_steps=100, denoising_strength=1.0, **kwargs):
        ramp = np.linspace(1 - denoising_strength, 1, num_inference_steps, dtype=np.float64)
        min_inv_rho = self.sigma_min ** (1 / self.rho)
        max_inv_rho = self.sigma_max ** (1 / self.rho)
        self.sigmas = np.power(max_inv_rho + ramp * (min_inv_rho - max_inv_rho),
                               self.rho).astype(np.float32)
        self.timesteps = (np.log(self.sigmas) * 0.25).astype(np.float32)

    def _tid(self, timestep) -> int:
        return int(np.argmin(np.abs(self.timesteps - _scalar(timestep))))

    def _sigma(self, timestep) -> float:
        return float(self.sigmas[self._tid(timestep)])

    def step(self, model_output, timestep, sample, to_final=False):
        tid = self._tid(timestep)
        sigma = float(self.sigmas[tid])
        sample = sample * math.sqrt(sigma * sigma + 1)
        estimated = (-sigma / math.sqrt(sigma * sigma + 1)) * model_output \
            + sample / (sigma * sigma + 1)
        if to_final or tid + 1 >= len(self.timesteps):
            return estimated
        sigma_ = float(self.sigmas[tid + 1])
        derivative = (sample - estimated) / sigma
        prev = sample + derivative * (sigma_ - sigma)
        return prev / math.sqrt(sigma_ * sigma_ + 1)

    def return_to_timestep(self, timestep, sample, sample_stabilized):
        return None  # unsupported, as in the JAX package and the reference

    def add_noise(self, original_samples, noise, timestep):
        sigma = self._sigma(timestep)
        return (original_samples + noise * sigma) / math.sqrt(sigma * sigma + 1)

    def training_target(self, sample, noise, timestep):
        sigma = self._sigma(timestep)
        root = math.sqrt(sigma * sigma + 1)
        return (-root / sigma + 1 / (root * sigma)) * sample + noise / root

    def training_weight(self, timestep):
        sigma = self._sigma(timestep)
        return float(math.sqrt(1 + sigma * sigma) / sigma)
