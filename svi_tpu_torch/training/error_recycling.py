"""Error-Recycling replay buffers (behavioral ref: train_svi.py:684-938).

The port's own copy of svi_tpu/training/error_recycling.py, unchanged but for
this docstring: the same host RNG calls in the same order, so
the same seed banks and samples the same errors as the JAX package.

The model's own one-step prediction errors are banked into timestep-binned
buffers (bins = nearest entry of a num_grids-step inference schedule) and
re-injected into future training inputs. Buffers are host-side numpy ring
stores (the reference keeps them on CPU too, :779); they never reach the card.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from ..schedulers.flow_match import make_schedule


class ErrorBuffers:
    """latent-error and y-error buffers with grid lookup, replacement
    strategies (random/fifo/l2_batch/l2_similarity) and modulated sampling."""

    def __init__(
        self,
        num_grids: int = 40,
        buffer_size: int = 500,
        replacement_strategy: str = "random",
        error_modulate_factor: float = 0.2,
        shift: float = 5.0,
        y_error_sample_from_all_grids: bool = False,
        y_error_sample_range: Optional[tuple[int, int]] = None,
        rng: Optional[random.Random] = None,
    ):
        # grid centers = num_grids-step inference schedule (ref :693)
        sched = make_schedule(num_grids, shift=shift, sigma_min=0.0, extra_one_step=True)
        self.grid_timesteps = np.asarray(sched.timesteps, np.float32)
        self.num_grids = num_grids
        self.buffer_size = buffer_size
        self.strategy = replacement_strategy
        self.error_modulate_factor = error_modulate_factor
        self.y_from_all_grids = y_error_sample_from_all_grids
        self.y_sample_range = y_error_sample_range
        self.latent_error_buffer = {i: [] for i in range(num_grids)}
        self.y_error_buffer = {i: [] for i in range(num_grids)}
        self.rng = rng or random.Random()

    # -- grid ----------------------------------------------------------------

    def grid_index(self, timestep: float) -> int:
        """argmin |schedule - t| (ref _get_timestep_grid :727-750)."""
        t = float(np.clip(float(timestep), 0, 999))
        idx = int(np.argmin(np.abs(self.grid_timesteps - t)))
        return min(idx, self.num_grids - 1)

    # -- add -----------------------------------------------------------------

    def _add(self, store: dict, error: np.ndarray, timestep: float):
        gi = self.grid_index(timestep)
        buf = store[gi]
        err = np.asarray(error, np.float32)
        if len(buf) < self.buffer_size:
            buf.append(err)
            return
        if self.strategy == "random":
            buf[self.rng.randint(0, len(buf) - 1)] = err
        elif self.strategy == "fifo":
            buf.pop(0)
            buf.append(err)
        elif self.strategy in ("l2_batch", "l2_similarity"):
            stack = np.stack([b.reshape(-1) for b in buf])
            d = np.linalg.norm(stack - err.reshape(-1)[None], axis=1)
            buf[int(np.argmin(d))] = err
        else:
            raise ValueError(self.strategy)

    def add_latent_error(self, error, timestep):
        self._add(self.latent_error_buffer, error, timestep)

    def add_y_error(self, error, timestep):
        self._add(self.y_error_buffer, error, timestep)

    # -- query ---------------------------------------------------------------

    def has_latent_data(self, timestep) -> bool:
        return len(self.latent_error_buffer[self.grid_index(timestep)]) > 0

    def has_y_data(self, timestep) -> bool:
        if self.y_sample_range is not None:
            s, e = self.y_sample_range
            return any(
                len(self.y_error_buffer[g]) > 0
                for g in range(s, min(e + 1, self.num_grids))
            )
        if self.y_from_all_grids:
            return any(len(b) > 0 for b in self.y_error_buffer.values())
        return len(self.y_error_buffer[self.grid_index(timestep)]) > 0

    def _modulate(self, sample: np.ndarray) -> np.ndarray:
        lo = 1.0 - self.error_modulate_factor
        hi = 1.0 + self.error_modulate_factor
        return sample * self.rng.uniform(lo, hi)

    def sample_noise_error(self, shape, timestep) -> np.ndarray:
        """From latent_error_buffer at the timestep's grid (ref :856-874)."""
        buf = self.latent_error_buffer[self.grid_index(timestep)]
        if not buf:
            return np.zeros(shape, np.float32)
        return self._modulate(self.rng.choice(buf))

    def sample_latent_error(self, shape, timestep) -> np.ndarray:
        """From y_error_buffer at the timestep's grid (ref :876-893 — yes, the
        reference samples LATENT corruption from the y buffer)."""
        buf = self.y_error_buffer[self.grid_index(timestep)]
        if not buf:
            return np.zeros(shape, np.float32)
        return self._modulate(self.rng.choice(buf))

    def sample_y_error(self, shape, timestep) -> np.ndarray:
        """y corruption: current grid, all grids, or a custom range
        (ref :895-938)."""
        if self.y_sample_range is not None:
            s, e = self.y_sample_range
            pool = [
                x for g in range(s, min(e + 1, self.num_grids))
                for x in self.y_error_buffer[g]
            ]
        elif self.y_from_all_grids:
            pool = [x for b in self.y_error_buffer.values() for x in b]
        else:
            pool = self.y_error_buffer[self.grid_index(timestep)]
        if not pool:
            return np.zeros(shape, np.float32)
        return self._modulate(self.rng.choice(pool))

    # -- stats ---------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "latent_total": sum(len(b) for b in self.latent_error_buffer.values()),
            "y_total": sum(len(b) for b in self.y_error_buffer.values()),
            "latent_per_grid": {k: len(v) for k, v in self.latent_error_buffer.items() if v},
            "y_per_grid": {k: len(v) for k, v in self.y_error_buffer.items() if v},
        }
