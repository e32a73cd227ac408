"""Streaming training statistics (count, mean, std per name).

Port of ``ln3diff_tpu/utils/training_stats.py`` (``StatsCollector`` :23,
``report`` :83, ``report0`` :87, ``default_collector`` :91; reference
``utils/torch_utils/training_stats.py``): per-name running (count, sum,
sum of squares) moments in float64 on the host.  Across the ranks of a
``torch.distributed`` group, ``report0`` reports on rank 0 only and
``sync`` sums the moments of every rank (JAX :41-53).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist


def _as_numpy(value) -> np.ndarray:
    if torch.is_tensor(value):
        value = value.detach().cpu().double().numpy()
    return np.asarray(value, np.float64).reshape(-1)


class StatsCollector:
    def __init__(self):
        self._moments: 'OrderedDict[str, np.ndarray]' = OrderedDict()

    def report(self, name: str, value) -> None:
        value = _as_numpy(value)
        if value.size == 0:
            return
        m = np.array([value.size, value.sum(), np.square(value).sum()],
                     np.float64)
        if name in self._moments:
            self._moments[name] += m
        else:
            self._moments[name] = m

    def report0(self, name: str, value) -> None:
        """Report on rank 0 only (rank-gated stats)."""
        if not dist.is_initialized() or dist.get_rank() == 0:
            self.report(name, value)

    def sync(self) -> None:
        """Sum the moments over the ranks: every rank ends with the same
        ones, over the union of the names the ranks reported (a no-op on
        one process)."""
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, list(self._moments))
        names = sorted(set().union(*every))
        if not names:
            return
        device = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
        zero = np.zeros(3, np.float64)
        stacked = torch.from_numpy(np.stack(
            [self._moments.get(n, zero) for n in names])).to(device)
        dist.all_reduce(stacked)
        summed = stacked.cpu().numpy()
        for i, n in enumerate(names):
            self._moments[n] = summed[i]

    def mean(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float('nan')
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float('nan')
        mean = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mean**2, 0.0)))

    def as_dict(self) -> dict:
        return {n: {'num': int(m[0]), 'mean': self.mean(n),
                    'std': self.std(n)} for n, m in self._moments.items()}

    def reset(self) -> None:
        self._moments.clear()


_default = StatsCollector()


def report(name, value):
    _default.report(name, value)


def report0(name, value):
    _default.report0(name, value)


def default_collector() -> StatsCollector:
    return _default
