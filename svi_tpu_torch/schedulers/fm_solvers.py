"""Flow-matching multistep solvers, UniPC and DPM-Solver++, port of
svi_tpu/schedulers/fm_solvers.py (rectified flow: alpha_t = 1 - sigma,
sigma_t = sigma, lambda = log(alpha) - log(sigma); the flow prediction
becomes x0 = sample - sigma * v).

The schedule and the solvers' coefficients are host scalars computed in
numpy exactly as the JAX package computes them: sigmas stored as float32
after a float64 shift, timesteps int64, the UniPC coefficient vectors and
their linear solves in float64. Samples and model outputs are torch tensors
on any device; each update multiplies them by those scalars (as Python
floats) on the sample's device, so the trajectory never leaves it.

UniPC's bh1 / bh2 predictor-corrector up to order 3; DPM-Solver++ midpoint /
heun, orders 1-3; the ancestral sde-dpmsolver++ (orders 1-2, per-step noise
from `variance_noise` or a numpy Generator or seed, drawn on the host as
svi_tpu draws it). The plain dpmsolver / sde-dpmsolver types raise
NotImplementedError, as in svi_tpu.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _flow_sigmas(num_train_timesteps: int, shift: float) -> np.ndarray:
    alphas = np.linspace(1, 1 / num_train_timesteps, num_train_timesteps)[::-1].copy()
    sigmas = 1.0 - alphas
    return (shift * sigmas / (1 + (shift - 1) * sigmas)).astype(np.float32)


def _time_shift(mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


def _like(arr, sample: torch.Tensor) -> torch.Tensor:
    """A host array (noise, a sigma column) as a tensor beside the sample."""
    return torch.as_tensor(np.asarray(arr), dtype=torch.float32).to(sample.device)


class _FlowMultistepBase:
    """The schedule and the multistep bookkeeping shared by both solvers."""

    def __init__(self, num_train_timesteps=1000, solver_order=2, shift=1.0,
                 use_dynamic_shifting=False, final_sigmas_type="zero"):
        self.num_train_timesteps = num_train_timesteps
        self.solver_order = solver_order
        self.shift = shift
        self.use_dynamic_shifting = use_dynamic_shifting
        self.final_sigmas_type = final_sigmas_type
        sigmas = _flow_sigmas(num_train_timesteps, 1.0 if use_dynamic_shifting else shift)
        self.sigmas = sigmas
        self.timesteps = sigmas * num_train_timesteps
        self.sigma_min = float(sigmas[-1])
        self.sigma_max = float(sigmas[0])
        self.num_inference_steps = None
        self._reset_state()

    def _reset_state(self):
        self.model_outputs = [None] * self.solver_order
        self.timestep_list = [None] * self.solver_order
        self.lower_order_nums = 0
        self.last_sample = None
        self._step_index = None
        self._begin_index = None
        # the numpy generator an int seed makes for sde-dpmsolver++, made once
        # a trajectory so that each step draws new noise
        self._gen = None
        self._gen_seed = object()

    @property
    def step_index(self):
        return self._step_index

    @property
    def begin_index(self):
        return self._begin_index

    def set_begin_index(self, begin_index: int = 0):
        self._begin_index = begin_index

    def set_timesteps(self, num_inference_steps=None, device=None, sigmas=None, mu=None,
                      shift=None):
        if self.use_dynamic_shifting and mu is None:
            raise ValueError("use_dynamic_shifting needs `mu`")
        if sigmas is None:
            sigmas = np.linspace(self.sigma_max, self.sigma_min,
                                 num_inference_steps + 1).copy()[:-1]
        sigmas = np.asarray(sigmas, np.float64)
        if self.use_dynamic_shifting:
            sigmas = _time_shift(mu, 1.0, sigmas)
        else:
            s = self.shift if shift is None else shift
            sigmas = s * sigmas / (1 + (s - 1) * sigmas)
        if self.final_sigmas_type == "zero":
            sigma_last = 0.0
        else:
            raise ValueError(f"final_sigmas_type {self.final_sigmas_type!r}")
        self.timesteps = (sigmas * self.num_train_timesteps).astype(np.int64)
        self.sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        self.num_inference_steps = len(self.timesteps)
        self._reset_state()

    @staticmethod
    def _alpha_sigma(sigma):
        return 1 - sigma, sigma

    def _lambda(self, sigma):
        alpha_t, sigma_t = self._alpha_sigma(sigma)
        return np.log(alpha_t) - np.log(sigma_t)

    def index_for_timestep(self, timestep, schedule_timesteps=None):
        st = self.timesteps if schedule_timesteps is None else schedule_timesteps
        indices = np.nonzero(st == int(timestep))[0]
        pos = 1 if len(indices) > 1 else 0
        return int(indices[pos])

    def _init_step_index(self, timestep):
        if self._begin_index is None:
            self._step_index = self.index_for_timestep(timestep)
        else:
            self._step_index = self._begin_index

    def convert_model_output(self, model_output, sample):
        """Flow prediction -> x0."""
        sigma_t = self.sigmas[self.step_index]
        return sample - float(sigma_t) * model_output

    def add_noise(self, original_samples, noise, timesteps):
        idx = [self.index_for_timestep(t) for t in np.atleast_1d(np.asarray(timesteps))]
        sigma = self.sigmas[idx].reshape((-1,) + (1,) * (original_samples.ndim - 1))
        alpha_t, sigma_t = self._alpha_sigma(sigma)
        return (_like(alpha_t, original_samples) * original_samples
                + _like(sigma_t, original_samples) * noise.to(original_samples.device))

    def scale_model_input(self, sample, *args, **kwargs):
        return sample

    def __len__(self):
        return self.num_train_timesteps


class FlowUniPCMultistepScheduler(_FlowMultistepBase):
    """UniPC predictor-corrector for flow matching: predict_x0 with the B(h)
    update family (bh1: B(h) = h; bh2: B(h) = e^h - 1)."""

    def __init__(self, num_train_timesteps=1000, solver_order=2, shift=1.0,
                 use_dynamic_shifting=False, solver_type="bh2", lower_order_final=True,
                 disable_corrector=(), final_sigmas_type="zero"):
        if solver_type in ("midpoint", "heun", "logrho"):
            solver_type = "bh2"
        assert solver_type in ("bh1", "bh2"), solver_type
        super().__init__(num_train_timesteps, solver_order, shift, use_dynamic_shifting,
                         final_sigmas_type)
        self.solver_type = solver_type
        self.lower_order_final = lower_order_final
        self.disable_corrector = list(disable_corrector)
        self.this_order = None

    def _uni_coeffs(self, order, hh):
        """h * phi_1, B(h) and the b vector shared by UniP and UniC."""
        h_phi_1 = np.expm1(hh)
        B_h = hh if self.solver_type == "bh1" else np.expm1(hh)
        h_phi_k = h_phi_1 / hh - 1
        b = []
        factorial_i = 1
        for i in range(1, order + 1):
            b.append(h_phi_k * factorial_i / B_h)
            factorial_i *= i + 1
            h_phi_k = h_phi_k / hh - 1 / factorial_i
        return h_phi_1, B_h, np.asarray(b, np.float64)

    def _rks_D1s(self, order, h, s0_index_offset):
        """The history's lambda ratios and scaled differences. s0_index_offset:
        0 for UniP (anchored at step_index), 1 for UniC (at step_index - 1)."""
        lambda_s0 = self._lambda(self.sigmas[self.step_index - s0_index_offset])
        m0 = self.model_outputs[-1]
        rks, D1s = [], []
        for i in range(1, order):
            si = self.step_index - s0_index_offset - i
            mi = self.model_outputs[-(i + 1)]
            rk = (self._lambda(self.sigmas[si]) - lambda_s0) / h
            rks.append(float(rk))
            D1s.append((mi - m0) / float(rk))
        rks.append(1.0)
        return np.asarray(rks, np.float64), D1s

    def multistep_uni_p_bh_update(self, sample, order):
        """The predictor (predict_x0)."""
        m0 = self.model_outputs[-1]
        sigma_t = self.sigmas[self.step_index + 1]
        sigma_s0 = self.sigmas[self.step_index]
        alpha_t, sigma_t_ = self._alpha_sigma(sigma_t)
        h = self._lambda(sigma_t) - self._lambda(sigma_s0)
        hh = -h
        rks, D1s = self._rks_D1s(order, h, 0)
        h_phi_1, B_h, b = self._uni_coeffs(order, hh)
        x_t_ = float(sigma_t_ / sigma_s0) * sample - float(alpha_t * h_phi_1) * m0
        if D1s:
            if order == 2:
                rhos_p = np.asarray([0.5])
            else:
                R = np.stack([rks ** (i - 1) for i in range(1, order + 1)])
                rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
            pred_res = sum(float(r) * d for r, d in zip(rhos_p, D1s))
        else:
            pred_res = 0
        return x_t_ - float(alpha_t * B_h) * pred_res

    def multistep_uni_c_bh_update(self, this_model_output, last_sample, this_sample, order):
        """The corrector (predict_x0)."""
        m0 = self.model_outputs[-1]
        sigma_t = self.sigmas[self.step_index]
        sigma_s0 = self.sigmas[self.step_index - 1]
        alpha_t, sigma_t_ = self._alpha_sigma(sigma_t)
        h = self._lambda(sigma_t) - self._lambda(sigma_s0)
        hh = -h
        rks, D1s = self._rks_D1s(order, h, 1)
        h_phi_1, B_h, b = self._uni_coeffs(order, hh)
        if order == 1:
            rhos_c = np.asarray([0.5])
        else:
            R = np.stack([rks ** (i - 1) for i in range(1, order + 1)])
            rhos_c = np.linalg.solve(R, b)
        x_t_ = float(sigma_t_ / sigma_s0) * last_sample - float(alpha_t * h_phi_1) * m0
        corr_res = sum(float(r) * d for r, d in zip(rhos_c[:-1], D1s)) if D1s else 0
        D1_t = this_model_output - m0
        return x_t_ - float(alpha_t * B_h) * (corr_res + float(rhos_c[-1]) * D1_t)

    def step(self, model_output, timestep, sample, return_dict=False, generator=None):
        """One predictor-corrector step; returns the previous sample."""
        if self.num_inference_steps is None:
            raise ValueError("run set_timesteps first")
        if self.step_index is None:
            self._init_step_index(timestep)

        use_corrector = (self.step_index > 0
                         and self.step_index - 1 not in self.disable_corrector
                         and self.last_sample is not None)
        model_output_convert = self.convert_model_output(model_output, sample)
        if use_corrector:
            sample = self.multistep_uni_c_bh_update(
                this_model_output=model_output_convert, last_sample=self.last_sample,
                this_sample=sample, order=self.this_order)
        self.model_outputs = self.model_outputs[1:] + [model_output_convert]
        self.timestep_list = self.timestep_list[1:] + [timestep]

        if self.lower_order_final:
            this_order = min(self.solver_order, len(self.timesteps) - self.step_index)
        else:
            this_order = self.solver_order
        self.this_order = min(this_order, self.lower_order_nums + 1)

        self.last_sample = sample
        prev_sample = self.multistep_uni_p_bh_update(sample=sample, order=self.this_order)
        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        self._step_index += 1
        return prev_sample


class FlowDPMSolverMultistepScheduler(_FlowMultistepBase):
    """DPM-Solver++ multistep for flow matching: the deterministic
    `dpmsolver++` and the ancestral `sde-dpmsolver++`; midpoint / heun,
    orders 1-3 (the sde variant is defined for orders 1-2; order 3 takes the
    deterministic update, as svi_tpu's step does)."""

    def __init__(self, num_train_timesteps=1000, solver_order=2, shift=1.0,
                 use_dynamic_shifting=False, algorithm_type="dpmsolver++",
                 solver_type="midpoint", lower_order_final=True, euler_at_final=False,
                 final_sigmas_type="zero"):
        if algorithm_type not in ("dpmsolver++", "sde-dpmsolver++"):
            raise NotImplementedError("algorithm_type must be dpmsolver++ or sde-dpmsolver++")
        assert solver_type in ("midpoint", "heun")
        super().__init__(num_train_timesteps, solver_order, shift, use_dynamic_shifting,
                         final_sigmas_type)
        self.algorithm_type = algorithm_type
        self.solver_type = solver_type
        self.lower_order_final = lower_order_final
        self.euler_at_final = euler_at_final

    def dpm_solver_first_order_update(self, model_output, sample, noise=None):
        sigma_t, sigma_s = self.sigmas[self.step_index + 1], self.sigmas[self.step_index]
        alpha_t, sigma_t_ = self._alpha_sigma(sigma_t)
        h = self._lambda(sigma_t) - self._lambda(sigma_s)
        if self.algorithm_type == "sde-dpmsolver++":
            assert noise is not None
            return (float(sigma_t_ / sigma_s * np.exp(-h)) * sample
                    + float(alpha_t * -np.expm1(-2.0 * h)) * model_output
                    + float(sigma_t_ * np.sqrt(-np.expm1(-2.0 * h))) * noise)
        return float(sigma_t_ / sigma_s) * sample - float(alpha_t * np.expm1(-h)) * model_output

    def multistep_dpm_solver_second_order_update(self, sample, noise=None):
        """Midpoint / heun."""
        sigma_t = self.sigmas[self.step_index + 1]
        sigma_s0 = self.sigmas[self.step_index]
        sigma_s1 = self.sigmas[self.step_index - 1]
        alpha_t, sigma_t_ = self._alpha_sigma(sigma_t)
        l_t, l_s0, l_s1 = (self._lambda(s) for s in (sigma_t, sigma_s0, sigma_s1))
        m0, m1 = self.model_outputs[-1], self.model_outputs[-2]
        h, h_0 = l_t - l_s0, l_s0 - l_s1
        r0 = h_0 / h
        D0, D1 = m0, float(1.0 / r0) * (m0 - m1)
        if self.algorithm_type == "sde-dpmsolver++":
            assert noise is not None
            base = (float(sigma_t_ / sigma_s0 * np.exp(-h)) * sample
                    + float(alpha_t * -np.expm1(-2.0 * h)) * D0)
            if self.solver_type == "midpoint":
                base = base + float(0.5 * (alpha_t * -np.expm1(-2.0 * h))) * D1
            else:
                base = base + float(alpha_t * (-np.expm1(-2.0 * h) / (-2.0 * h) + 1.0)) * D1
            return base + float(sigma_t_ * np.sqrt(-np.expm1(-2.0 * h))) * noise
        if self.solver_type == "midpoint":
            return (float(sigma_t_ / sigma_s0) * sample
                    - float(alpha_t * np.expm1(-h)) * D0
                    - float(0.5 * (alpha_t * np.expm1(-h))) * D1)
        return (float(sigma_t_ / sigma_s0) * sample
                - float(alpha_t * np.expm1(-h)) * D0
                + float(alpha_t * (np.expm1(-h) / h + 1.0)) * D1)

    def multistep_dpm_solver_third_order_update(self, sample):
        sigma_t = self.sigmas[self.step_index + 1]
        sigma_s0 = self.sigmas[self.step_index]
        sigma_s1 = self.sigmas[self.step_index - 1]
        sigma_s2 = self.sigmas[self.step_index - 2]
        alpha_t, sigma_t_ = self._alpha_sigma(sigma_t)
        l_t, l_s0, l_s1, l_s2 = (self._lambda(s)
                                 for s in (sigma_t, sigma_s0, sigma_s1, sigma_s2))
        m0, m1, m2 = self.model_outputs[-1], self.model_outputs[-2], self.model_outputs[-3]
        h, h_0, h_1 = l_t - l_s0, l_s0 - l_s1, l_s1 - l_s2
        r0, r1 = h_0 / h, h_1 / h
        D0 = m0
        D1_0, D1_1 = float(1.0 / r0) * (m0 - m1), float(1.0 / r1) * (m1 - m2)
        D1 = D1_0 + float(r0 / (r0 + r1)) * (D1_0 - D1_1)
        D2 = float(1.0 / (r0 + r1)) * (D1_0 - D1_1)
        return (float(sigma_t_ / sigma_s0) * sample
                - float(alpha_t * np.expm1(-h)) * D0
                + float(alpha_t * (np.expm1(-h) / h + 1.0)) * D1
                - float(alpha_t * ((np.expm1(-h) + h) / h ** 2 - 0.5)) * D2)

    def step(self, model_output, timestep, sample, return_dict=False, generator=None,
             variance_noise=None):
        """For sde-dpmsolver++ the step's noise is `variance_noise` (a tensor
        or an array), else a draw of `generator` (a numpy Generator, or an
        int seed whose generator is made once a trajectory)."""
        if self.num_inference_steps is None:
            raise ValueError("run set_timesteps first")
        if self.step_index is None:
            self._init_step_index(timestep)

        lower_order_final = (self.step_index == len(self.timesteps) - 1) and (
            self.euler_at_final
            or (self.lower_order_final and len(self.timesteps) < 15)
            or self.final_sigmas_type == "zero")
        lower_order_second = ((self.step_index == len(self.timesteps) - 2)
                              and self.lower_order_final and len(self.timesteps) < 15)

        model_output = self.convert_model_output(model_output, sample)
        self.model_outputs = self.model_outputs[1:] + [model_output]

        noise = None
        if self.algorithm_type == "sde-dpmsolver++":
            if variance_noise is not None:
                noise = torch.as_tensor(variance_noise).to(sample.device, torch.float32)
            else:
                if not isinstance(generator, np.random.Generator):
                    if self._gen_seed != generator:
                        self._gen = np.random.default_rng(generator)
                        self._gen_seed = generator
                    generator = self._gen
                noise = _like(generator.standard_normal(tuple(sample.shape)).astype(np.float32),
                              sample)

        if self.solver_order == 1 or self.lower_order_nums < 1 or lower_order_final:
            prev_sample = self.dpm_solver_first_order_update(model_output, sample, noise=noise)
        elif self.solver_order == 2 or self.lower_order_nums < 2 or lower_order_second:
            prev_sample = self.multistep_dpm_solver_second_order_update(sample, noise=noise)
        else:
            prev_sample = self.multistep_dpm_solver_third_order_update(sample)

        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        self._step_index += 1
        return prev_sample


def get_sampling_sigmas(sampling_steps: int, shift: float) -> np.ndarray:
    sigma = np.linspace(1, 0, sampling_steps + 1)[:sampling_steps]
    return (shift * sigma / (1 + (shift - 1) * sigma))


def retrieve_timesteps(scheduler, num_inference_steps=None, device=None, timesteps=None,
                       sigmas=None, **kwargs):
    """set_timesteps from either sigmas or a step count; returns (timesteps, n)."""
    if timesteps is not None and sigmas is not None:
        raise ValueError("pass only one of `timesteps` or `sigmas`")
    if sigmas is not None:
        scheduler.set_timesteps(sigmas=sigmas, device=device, **kwargs)
    else:
        scheduler.set_timesteps(num_inference_steps, device=device, **kwargs)
    return scheduler.timesteps, len(scheduler.timesteps)
