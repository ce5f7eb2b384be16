"""Rectified-flow ("flow match") scheduler, port of svi_tpu/schedulers/flow_match.py:
the schedule table (`make_schedule`), the functions on it (`step`,
`add_noise`, `return_to_timestep`, the training target and weight) and the
stateful `FlowMatchScheduler`.

The SVI pipeline uses it with shift=5, sigma_min=0.0, extra_one_step=True and
num_train_timesteps=1000; SD3 and FLUX with shift=3. `inverse_timesteps`
runs the table from low to high noise, `reverse_sigmas` uses 1 - sigma
(OmniGen, StepVideo). The sigma table is computed in float64 on the host and
stored as float32 CPU tensors; a step computes in f32 on the sample's device.
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

    def __len__(self) -> int:
        return int(self.sigmas.shape[0])


def make_schedule(num_inference_steps: int, shift: float = 3.0, sigma_max: float = 1.0,
                  sigma_min: float = 0.003 / 1.002, denoising_strength: float = 1.0,
                  inverse_timesteps: bool = False, extra_one_step: bool = False,
                  reverse_sigmas: bool = False, num_train_timesteps: int = 1000,
                  training: bool = False) -> FlowMatchSchedule:
    """The sigma table (port of `make_schedule`), computed in float64 and
    stored as float32: sigma' = shift * sigma / (1 + (shift - 1) * sigma).
    With training=True, the Gaussian bell of the training weights, evaluated
    (as the reference does) on the timestep values against
    num_inference_steps / 2."""
    sigma_start = sigma_min + (sigma_max - sigma_min) * denoising_strength
    if extra_one_step:
        sigmas = np.linspace(sigma_start, sigma_min, num_inference_steps + 1,
                             dtype=np.float64)[:-1]
    else:
        sigmas = np.linspace(sigma_start, sigma_min, num_inference_steps, dtype=np.float64)
    if inverse_timesteps:
        sigmas = sigmas[::-1].copy()
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    if reverse_sigmas:
        sigmas = 1 - sigmas
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


def timestep_id(schedule: FlowMatchSchedule, timestep) -> int:
    """The nearest schedule entry to a continuous timestep (argmin |t_i - t|)."""
    t = torch.as_tensor(timestep, dtype=torch.float32).reshape(()).cpu()
    return int(torch.argmin((schedule.timesteps - t).abs()))


def _tid(schedule, timestep, by_index: bool) -> int:
    return int(timestep) if by_index else timestep_id(schedule, timestep)


def step(schedule: FlowMatchSchedule, model_output: torch.Tensor, timestep,
         sample: torch.Tensor, to_final: bool = False, self_corr: bool = False,
         inverse_timesteps: bool = False, reverse_sigmas: bool = False,
         by_index: bool = False) -> torch.Tensor:
    """One Euler step of the rectified-flow ODE, in f32, cast back to the
    sample's dtype. by_index: `timestep` is an index into the table. Past the
    last entry (or to_final) the next sigma is 1 with inverse_timesteps,
    reverse_sigmas or self_corr, else 0."""
    tid = _tid(schedule, timestep, by_index)
    sigma = float(schedule.sigmas[tid])
    final_sigma = 1.0 if (inverse_timesteps or reverse_sigmas or self_corr) else 0.0
    if to_final or tid + 1 >= len(schedule):
        sigma_next = final_sigma
    else:
        sigma_next = float(schedule.sigmas[tid + 1])
    delta = torch.tensor(sigma_next, dtype=torch.float32) - torch.tensor(sigma,
                                                                         dtype=torch.float32)
    model_output = torch.as_tensor(model_output)
    sample = torch.as_tensor(sample)
    out = sample.float() + model_output.to(sample.device).float() * delta.to(sample.device)
    return out.to(sample.dtype)


def return_to_timestep(schedule: FlowMatchSchedule, timestep, sample: torch.Tensor,
                       sample_stabilized: torch.Tensor, by_index: bool = False) -> torch.Tensor:
    """Invert one step: the velocity that maps sample to sample_stabilized."""
    sigma = schedule.sigmas[_tid(schedule, timestep, by_index)]
    return (sample - sample_stabilized) / sigma.to(sample.device)


def add_noise(schedule: FlowMatchSchedule, original_samples: torch.Tensor,
              noise: torch.Tensor, timestep, by_index: bool = False) -> torch.Tensor:
    """Interpolate toward noise at sigma(t), in f32, cast back."""
    sigma = schedule.sigmas[_tid(schedule, timestep, by_index)].to(original_samples.device)
    out = (1 - sigma) * original_samples.float() + sigma * noise.to(
        original_samples.device).float()
    return out.to(original_samples.dtype)


def training_target(sample: torch.Tensor, noise: torch.Tensor, timestep=None) -> torch.Tensor:
    """The rectified-flow velocity target."""
    return noise - sample


def training_weight(schedule: FlowMatchSchedule, timestep) -> torch.Tensor:
    """The per-timestep Gaussian loss weight (a table built with training=True)."""
    assert schedule.training_weights is not None, "build schedule with training=True"
    return schedule.training_weights[timestep_id(schedule, timestep)]


class FlowMatchScheduler:
    """The stateful scheduler of the pipelines: `set_timesteps` builds the
    table, the methods call the functions above on it."""

    def __init__(self, num_inference_steps=100, num_train_timesteps=1000, shift=3.0,
                 sigma_max=1.0, sigma_min=0.003 / 1.002, inverse_timesteps=False,
                 extra_one_step=False, reverse_sigmas=False):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.sigma_max = sigma_max
        self.sigma_min = sigma_min
        self.inverse_timesteps = inverse_timesteps
        self.extra_one_step = extra_one_step
        self.reverse_sigmas = reverse_sigmas
        self.set_timesteps(num_inference_steps)

    def set_timesteps(self, num_inference_steps=100, denoising_strength=1.0, training=False,
                      shift=None):
        """The `make_schedule` table for this scheduler's settings."""
        if shift is not None:
            self.shift = shift
        self.schedule = make_schedule(
            num_inference_steps, shift=self.shift, sigma_max=self.sigma_max,
            sigma_min=self.sigma_min, denoising_strength=denoising_strength,
            inverse_timesteps=self.inverse_timesteps, extra_one_step=self.extra_one_step,
            reverse_sigmas=self.reverse_sigmas, num_train_timesteps=self.num_train_timesteps,
            training=training)

    @property
    def sigmas(self) -> torch.Tensor:
        return self.schedule.sigmas

    @property
    def timesteps(self) -> torch.Tensor:
        return self.schedule.timesteps

    @property
    def linear_timesteps_weights(self):
        return self.schedule.training_weights

    def step(self, model_output, timestep, sample, to_final=False, **kwargs):
        return step(self.schedule, model_output, timestep, sample, to_final=to_final,
                    self_corr=kwargs.get("self_corr", False),
                    inverse_timesteps=self.inverse_timesteps,
                    reverse_sigmas=self.reverse_sigmas)

    def return_to_timestep(self, timestep, sample, sample_stabilized):
        return return_to_timestep(self.schedule, timestep, sample, sample_stabilized)

    def add_noise(self, original_samples, noise, timestep):
        return add_noise(self.schedule, original_samples, noise, timestep)

    def training_target(self, sample, noise, timestep=None):
        return training_target(sample, noise, timestep)

    def training_weight(self, timestep):
        return training_weight(self.schedule, timestep)
