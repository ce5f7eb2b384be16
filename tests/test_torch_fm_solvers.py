"""UniPC and DPM-Solver++ in the port (svi_tpu_torch.schedulers.fm_solvers)
against svi_tpu's on the CPU: the cases of tests/test_fm_solvers.py's
parametrisations, each trajectory of the port (torch tensors) against
svi_tpu's (numpy arrays) from the same seeded sample and the same stand-in
model, the schedules equal.

Tolerance: each step's sample within 1e-6 of the trajectory's largest
magnitude. Both sides compute the coefficients as the same float32 / float64
numpy scalars and take the same float32 products; what remains is the order
of a few float32 sums.
"""

import numpy as np
import pytest
import torch

from svi_tpu.schedulers import fm_solvers as jfm
from svi_tpu_torch.schedulers import fm_solvers as tfm

REL = 1e-6
SHAPE = (1, 4, 2, 3, 3)


def _fake_model(sample, i):
    """A model output depending on the sample and the step, on either side."""
    return 0.3 * sample + float(np.float32(0.1 * np.sin(i + 1)))


def _trajectories(make, steps, shift, noises=None, generator=None):
    """(svi_tpu's, the port's) samples after each step."""
    out = []
    for mod, wrap in ((jfm, np.asarray), (tfm, torch.from_numpy)):
        sched = make(mod)
        sched.set_timesteps(steps, shift=shift)
        sample = wrap(np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32))
        traj = []
        for i, t in enumerate(sched.timesteps):
            kw = {}
            if noises is not None:
                kw["variance_noise"] = wrap(noises[i])
            if generator is not None:
                kw["generator"] = generator
            sample = sched.step(_fake_model(sample, i), t, sample, **kw)
            traj.append(np.asarray(sample, np.float32).copy())
        out.append(traj)
    return out


def _close(want, got):
    """Step by step within REL of the largest magnitude; NaN where svi_tpu
    has NaN (bh1's last step: B(h) = h is infinite at sigma 0, times a zero
    correction)."""
    assert len(want) == len(got)
    scale = max(np.nanmax(np.abs(w)) for w in want)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"step {i}")
        ok = ~np.isnan(w)
        assert np.abs(w[ok] - g[ok]).max(initial=0.0) <= REL * scale, f"step {i}"


@pytest.mark.parametrize("order,solver_type,steps", [
    (2, "bh2", 10), (2, "bh1", 10), (3, "bh2", 20), (1, "bh2", 6),
])
def test_unipc_trajectory_matches_svi_tpu(order, solver_type, steps):
    _close(*_trajectories(lambda m: m.FlowUniPCMultistepScheduler(
        solver_order=order, solver_type=solver_type), steps, shift=5.0))


def test_unipc_disable_corrector_and_timesteps_match_svi_tpu():
    want, got = _trajectories(lambda m: m.FlowUniPCMultistepScheduler(disable_corrector=[0]),
                              8, shift=3.0)
    _close(want, got)
    a, b = jfm.FlowUniPCMultistepScheduler(), tfm.FlowUniPCMultistepScheduler()
    a.set_timesteps(8, shift=3.0)
    b.set_timesteps(8, shift=3.0)
    np.testing.assert_array_equal(b.sigmas, a.sigmas)
    np.testing.assert_array_equal(b.timesteps, a.timesteps)


@pytest.mark.parametrize("order,solver_type,steps", [
    (2, "midpoint", 10), (2, "heun", 10), (3, "midpoint", 20), (1, "midpoint", 6),
])
def test_dpm_trajectory_matches_svi_tpu(order, solver_type, steps):
    _close(*_trajectories(lambda m: m.FlowDPMSolverMultistepScheduler(
        solver_order=order, solver_type=solver_type), steps, shift=5.0))


def test_add_noise_and_sampling_sigmas_match_svi_tpu():
    a, b = jfm.FlowUniPCMultistepScheduler(), tfm.FlowUniPCMultistepScheduler()
    a.set_timesteps(10, shift=5.0)
    b.set_timesteps(10, shift=5.0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    n = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    t = np.asarray(a.timesteps[:2])
    want = np.asarray(a.add_noise(x, n, t))
    got = b.add_noise(torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(t))
    assert np.abs(got.numpy() - want).max() <= REL * np.abs(want).max()
    np.testing.assert_array_equal(tfm.get_sampling_sigmas(12, 4.0),
                                  jfm.get_sampling_sigmas(12, 4.0))
    for mod, s in ((jfm, a), (tfm, b)):
        ts, n_steps = mod.retrieve_timesteps(s, sigmas=[0.9, 0.5, 0.2], shift=2.0)
        assert n_steps == 3
    np.testing.assert_array_equal(b.timesteps, a.timesteps)


@pytest.mark.parametrize("order,solver_type,steps", [
    (1, "midpoint", 8), (2, "midpoint", 10), (2, "heun", 10),
])
def test_dpm_sde_trajectory_matches_svi_tpu(order, solver_type, steps):
    """sde-dpmsolver++ with the same per-step variance_noise on both sides."""
    nrng = np.random.default_rng(1)
    noises = [nrng.standard_normal(SHAPE).astype(np.float32) for _ in range(steps)]
    _close(*_trajectories(lambda m: m.FlowDPMSolverMultistepScheduler(
        solver_order=order, solver_type=solver_type, algorithm_type="sde-dpmsolver++"),
        steps, shift=5.0, noises=noises))


def test_dpm_sde_int_seed_draws_as_svi_tpu():
    """An int seed makes one numpy generator a trajectory in both packages:
    the same noise each step, new noise at every step."""
    want, got = _trajectories(lambda m: m.FlowDPMSolverMultistepScheduler(
        solver_order=2, algorithm_type="sde-dpmsolver++"), 6, shift=5.0, generator=7)
    _close(want, got)
    deltas = [b - a for a, b in zip(got, got[1:])]
    assert not np.allclose(deltas[0], deltas[1])


def test_plain_dpmsolver_raises_as_svi_tpu():
    for mod in (jfm, tfm):
        with pytest.raises(NotImplementedError):
            mod.FlowDPMSolverMultistepScheduler(algorithm_type="dpmsolver")
