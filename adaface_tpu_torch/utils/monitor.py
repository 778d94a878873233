"""Training monitors and logging.

Counterpart of `adaface_tpu/utils/monitor.py`: `RollingStats` (windowed
means), `MetricsLogger` (CSV rows per step with a console echo; the card's
machine has no wandb, so there is no mirror) and `ProfilerHook`, a
`torch.profiler` trace of a step range in place of `jax.profiler`.
"""

from __future__ import annotations

import collections
import csv
import os
import time
from typing import Iterable


class RollingStats:
    """Windowed running mean of one or more series."""

    def __init__(self, names: Iterable[str] = ("value",), window: int = 200):
        self.window = window
        self.buffers = {n: collections.deque(maxlen=window) for n in names}

    def update(self, name: str = "value", value: float = 0.0):
        if name not in self.buffers:
            self.buffers[name] = collections.deque(maxlen=self.window)
        self.buffers[name].append(float(value))

    def mean(self, name: str = "value") -> float:
        buf = self.buffers.get(name)
        return sum(buf) / len(buf) if buf else float("nan")

    def reset(self, name: str | None = None):
        for n in ([name] if name else list(self.buffers)):
            self.buffers[n].clear()


class MetricsLogger:
    """CSV metrics logger with console echo every `echo_every` steps; a
    resumed run appends under the file's existing header."""

    def __init__(self, log_dir: str, filename: str = "metrics.csv", echo_every: int = 50,
                 echo: bool = True, write: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self.echo_every = echo_every if echo else 0
        self.write = write
        self._fieldnames: list[str] | None = None
        self._t0 = time.time()

    def log_dict(self, step: int, metrics: dict):
        if not self.write:
            return
        row = {"step": step, "wall_time": round(time.time() - self._t0, 2)}
        row.update({k: float(v) for k, v in metrics.items()})
        exists = os.path.exists(self.path) and os.path.getsize(self.path) > 0
        write_header = self._fieldnames is None and not exists
        if self._fieldnames is None:
            if exists:
                with open(self.path) as f:
                    self._fieldnames = f.readline().strip().split(",")
            else:
                self._fieldnames = list(row.keys())
        for k in row:
            if k not in self._fieldnames:
                self._fieldnames.append(k)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)
        if self.echo_every and step % self.echo_every == 0:
            brief = " ".join(f"{k}={v:.4g}" for k, v in list(row.items())[2:8])
            print(f"[step {step}] {brief}", flush=True)


class ProfilerHook:
    """A `torch.profiler` trace (CPU and CUDA activities) over steps
    [start_step, start_step + num_steps), exported as a Chrome trace under
    `<log_dir>/profile/`."""

    def __init__(self, log_dir: str, start_step: int = 10, num_steps: int = 5):
        self.log_dir = os.path.join(log_dir, "profile")
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None

    def maybe_start_stop(self, step: int):
        import torch

        if step == self.start_step and self._prof is None:
            os.makedirs(self.log_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        elif step >= self.stop_step and self._prof is not None:
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(
                os.path.join(self.log_dir, f"steps_{self.start_step}_{self.stop_step}.json"))
            self._prof = None
