"""Preemption-safe training: latch SIGTERM, stop at the next step
boundary, checkpoint, exit cleanly.

Port of ``ln3diff_tpu/training/preemption.py`` (``PreemptionGuard`` :52)
on one process.  A preemptible machine receives SIGTERM shortly before
eviction; with the guard a run loses at most the step in flight::

    with PreemptionGuard() as guard:
        while step < total_steps:
            trainer.run_loop(data, num_steps=n, step_offset=step,
                             guard=guard)
            ckpt.save(trainer.state.step, trainer.state)
            if guard.preempted:
                break

The multi-process agreement of the JAX guard (an OR of the local flags
across hosts every ``check_interval`` polls, latched) waits for the
port's parallel layer (``ROADMAP.md`` §1 item 3); here every poll reads
the local flag.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Context manager that latches SIGTERM into a flag polled by the
    training loops.  A Python handler installed before it is chained
    (called after the latch); the default and ignore actions are not,
    since the point is to finish the step.  The previous handler comes
    back on exit."""

    def __init__(self):
        self._signal = threading.Event()
        self._previous = None

    def _handler(self, signum, frame):
        self._signal.set()
        prev = self._previous
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL,
                                           signal.default_int_handler):
            prev(signum, frame)

    def __enter__(self) -> 'PreemptionGuard':
        self._previous = signal.signal(signal.SIGTERM, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        signal.signal(signal.SIGTERM, self._previous)
        self._previous = None
        return None

    @property
    def preempted(self) -> bool:
        return self._signal.is_set()

    def should_stop(self) -> bool:
        """Poll once per training step."""
        return self.preempted
