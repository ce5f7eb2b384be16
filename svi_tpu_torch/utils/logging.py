"""Training observability (port of svi_tpu/utils/logging.py).

  * MetricsLogger: an append-only metrics.jsonl (step, wall time and the
    step's scalars, one JSON object a line) beside the run's args.json.
  * profile_trace: a torch.profiler context around one region (a train
    step) that writes a Chrome trace into the directory given (the
    drivers' --profile_dir); a no-op without one.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


class MetricsLogger:
    """Append-only JSONL metrics stream (one object per call)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self.path = path
        self._t0 = time.time()
        self._fh = open(path, "a", buffering=1)

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "wall_time": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def close(self):
        self._fh.close()


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """torch.profiler over the region (CPU activity, and CUDA where a card
    is present), written as `trace.json` (Chrome trace format) into log_dir;
    no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
