"""Preemption-safe training: latch SIGTERM, stop at the next step
boundary, checkpoint, exit cleanly.

Port of ``ln3diff_tpu/training/preemption.py`` (``PreemptionGuard`` :52).
A preemptible machine receives SIGTERM shortly before eviction; with the
guard a run loses at most the step in flight::

    with PreemptionGuard() as guard:
        while step < total_steps:
            trainer.run_loop(data, num_steps=n, step_offset=step,
                             guard=guard)
            ckpt.save(trainer.state.step, trainer.state)
            if guard.preempted:
                break

Several processes (a ``torch.distributed`` group) must stop at the same
step, or the ones still running wait forever in their next collective.
So, as in JAX (:100-125), every ``check_interval``-th poll ORs the local
flags of all ranks (an all-reduce of one int), at the same poll on every
rank; a True result is latched, and ``preempted`` reads the latch.  One
process reads its local flag at every poll.
"""

from __future__ import annotations

import signal
import threading

import torch
import torch.distributed as dist


class PreemptionGuard:
    """Context manager that latches SIGTERM into a flag polled by the
    training loops.  A Python handler installed before it is chained
    (called after the latch); the default and ignore actions are not,
    since the point is to finish the step.  The previous handler comes
    back on exit."""

    def __init__(self, check_interval: int = 10):
        self.check_interval = max(1, int(check_interval))
        self._signal = threading.Event()
        self._previous = None
        self._calls = 0
        self._stopped = False   # the ranks' agreed stop (latched)

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

    @staticmethod
    def _world() -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    @property
    def local_signal(self) -> bool:
        """This process's own flag, for logging only: branch on
        ``preempted`` / ``should_stop``."""
        return self._signal.is_set()

    @property
    def preempted(self) -> bool:
        """The stop flag, the same on every rank: one process reads its
        signal; several read the latch of the last agreeing poll."""
        if self._world() == 1:
            return self._signal.is_set()
        return self._stopped

    def should_stop(self) -> bool:
        """Poll once per training step: one process reads its flag;
        several OR the ranks' flags every ``check_interval`` polls (the
        same polls on every rank) and latch a True."""
        self._calls += 1
        if self._world() == 1:
            return self.preempted
        if self._stopped:
            return True
        if self._calls % self.check_interval:
            return False
        # the flag on the process group's device (CUDA under NCCL)
        device = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
        flag = torch.tensor([int(self._signal.is_set())], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self._stopped = bool(flag.item())
        return self._stopped
