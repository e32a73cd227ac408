"""Profiling hooks: ``torch.profiler`` traces and simple timers.

Port of ``ln3diff_tpu/utils/profiling.py`` (``trace`` :19, ``annotate``
:29, ``timed`` :34, ``benchmark_fn`` :44, ``profile_dataloading`` :59),
the counterpart of the reference's profiling surface
(``logger.profile_kv``, ``misc.profiled_function`` →
``torch.autograd.profiler.record_function`` and its dataloader
throughput harness).  ``jax.profiler``'s xplane traces become
``torch.profiler`` Chrome traces (CPU activity, and CUDA activity when a
card is present), viewable in Perfetto or ``chrome://tracing``; the
timers feed the KV logger.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from . import logger


def _sync():
    """Wait for the card's queued work (nothing to wait for without one)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the enclosed block; on exit the Chrome trace is written under
    ``logdir`` and its path set as the yielded profiler's
    ``trace_path``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_path = os.path.join(
            logdir, f'trace-{os.getpid()}-{time.time_ns()}.pt.trace.json')
        prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """A named range in the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(name: str, sync: bool = False):
    """Host wall time of the block into the KV logger as ``time_{name}``
    (reference ``profile_kv``); ``sync`` waits for the card before each
    reading, so that the time covers the block's device work."""
    if sync:
        _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _sync()
        logger.logkv_mean(f'time_{name}', time.perf_counter() - t0)


def benchmark_fn(fn, *args, warmup: int = 1, iters: int = 5) -> float:
    """Least wall seconds per call over ``iters`` calls after ``warmup``;
    each call is drained with ``torch.cuda.synchronize``."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return min(times)


def profile_dataloading(data_iter, num_batches: int = 50) -> dict:
    """Dataloader throughput (reference ``scripts/profile_dataloading.py``)."""
    t0 = time.perf_counter()
    n = 0
    for _ in range(num_batches):
        next(data_iter)
        n += 1
    wall = time.perf_counter() - t0
    return {'batches_per_sec': n / wall, 'sec_per_batch': wall / n}
