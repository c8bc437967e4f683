"""Tracing and profiling helpers: the counterpart of
``agp_tpu/utils/profiling.py``.

``trace`` records a ``torch.profiler`` trace of the host and the CUDA
device and writes it as a Chrome trace (viewable in Perfetto or
chrome://tracing); ``PhaseTimer`` times named phases, each ended by a
synchronisation of the device its result lives on.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

from .tensors import map_leaves


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the host and the CUDA device (when there is one)
    around the block and write it to ``logdir/trace.json``:
    ``with trace("/tmp/trace"): step(...)``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _synchronize(result):
    """Wait for the CUDA devices that ``result``'s tensors live on (the
    counterpart of ``jax.block_until_ready``)."""
    devices = set()
    map_leaves(lambda t: devices.add(t.device), result)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class PhaseTimer:
    """Named phase timing, each phase ended by a synchronisation of its
    result's device: ``with timer.phase("step") as out: out["result"] = ...``."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        out = {}
        yield out
        if "result" in out:
            _synchronize(out["result"])
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self):
        return dict(sorted(self.times.items(), key=lambda kv: -kv[1]))
