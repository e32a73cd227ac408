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
    ``logdir`` and its path set as the yielded profiler's ``trace_path``.

    The profiler first runs a warm-up step that it discards
    (``torch.profiler.schedule(warmup=1)``), with one small kernel
    launched on the card in it, and records from the next step on: a
    trace that records from its start loses kernels at the start on the
    card.  It waits for the card before it starts, before it records and
    before it stops, so that the trace holds the kernels of the block and
    no others."""
    os.makedirs(logdir, exist_ok=True)
    on_card = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(logdir,
                        f'trace-{os.getpid()}-{time.time_ns()}.pt.trace.json')
    prof = torch.profiler.profile(
        activities=activities,
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                         repeat=1),
        on_trace_ready=lambda p: p.export_chrome_trace(path))
    _sync()
    prof.start()
    if on_card:
        torch.ones(1, device='cuda').add_(1)
        torch.cuda.synchronize()
    prof.step()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        prof.trace_path = path


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
