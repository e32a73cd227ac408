"""Training metrics logger: ``logkv`` / ``logkv_mean`` / ``dumpkvs``.

Port of ``ln3diff_tpu/utils/logger.py``, the API of the reference's
OpenAI-baselines logger (``guided_diffusion/logger.py`` — ``logkv:212``,
``logkv_mean:230``, ``profile_kv:299``, ``configure:447``): one
``MetricLogger`` with sink functions (stdout table, csv, jsonl,
tensorboard) and running means kept as (sum, count) pairs.  The
tensorboard sink writes through ``torch.utils.tensorboard`` and imports it
only when that sink is asked for; a missing ``tensorboard`` package
raises there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Callable, Optional

DEBUG, INFO, WARN, ERROR, DISABLED = 10, 20, 30, 40, 50

Sink = Callable[[dict], None]


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f'{v:<10.5g}'
    return str(v)


def stdout_sink(stream=None) -> Sink:
    """Render each dump as an aligned two-column table."""
    stream = stream or sys.stdout

    def sink(kvs: dict):
        if not kvs:
            return
        rows = [(str(k), _fmt_value(v)) for k, v in sorted(kvs.items())]
        kw = max(len(k) for k, _ in rows)
        vw = max(len(v) for _, v in rows)
        rule = '-' * (kw + vw + 7)
        lines = [rule]
        for k, v in rows:
            lines.append(f'| {k:<{kw}} | {v:<{vw}} |')
        lines.append(rule)
        stream.write('\n'.join(lines) + '\n')
        stream.flush()

    return sink


def jsonl_sink(path: str) -> Sink:
    fh = open(path, 'at')

    def sink(kvs: dict):
        fh.write(json.dumps({k: float(v) if hasattr(v, '__float__') else v
                             for k, v in kvs.items()}) + '\n')
        fh.flush()

    return sink


def csv_sink(path: str) -> Sink:
    """Append one row per dump; the file is rewritten ONLY when new
    columns appear (header change) — appends otherwise, so a long run is
    O(rows) I/O with O(1) retained memory."""
    state = {'keys': [], 'n_rows': 0}

    def sink(kvs: dict):
        new = [k for k in kvs if k not in state['keys']]
        if new:
            state['keys'] += sorted(new)
            # patch the header: re-read the rows written so far (disk is
            # the only copy), pad, rewrite once per new-column event
            rows = []
            if state['n_rows']:
                with open(path, 'rt') as fh:
                    lines = fh.read().splitlines()[1:]
                rows = [ln.split(',') for ln in lines]
            with open(path, 'wt') as fh:
                fh.write(','.join(state['keys']) + '\n')
                for r in rows:
                    r += [''] * (len(state['keys']) - len(r))
                    fh.write(','.join(r) + '\n')
        with open(path, 'at') as fh:
            fh.write(','.join(str(kvs.get(k, ''))
                              for k in state['keys']) + '\n')
        state['n_rows'] += 1

    return sink


def tensorboard_sink(log_dir: str) -> Sink:
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError('the tensorboard log format needs the '
                          '"tensorboard" package') from e
    writer = SummaryWriter(log_dir)
    step_box = [0]

    def sink(kvs: dict):
        step = int(kvs.get('step', step_box[0]))
        for k, v in kvs.items():
            try:
                writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass
        writer.flush()
        step_box[0] = step + 1

    return sink


_SINK_FACTORIES = {
    'stdout': lambda d, sfx: stdout_sink(),
    'log': lambda d, sfx: stdout_sink(open(
        os.path.join(d, f'log{sfx}.txt'), 'at')),
    'json': lambda d, sfx: jsonl_sink(os.path.join(
        d, f'progress{sfx}.json')),
    'csv': lambda d, sfx: csv_sink(os.path.join(d, f'progress{sfx}.csv')),
    'tensorboard': lambda d, sfx: tensorboard_sink(
        os.path.join(d, f'tb{sfx}')),
}


@dataclasses.dataclass
class MetricLogger:
    """Accumulates key→value pairs between ``dumpkvs`` calls."""
    dir: Optional[str] = None
    sinks: tuple = ()
    level: int = INFO

    def __post_init__(self):
        self._pending: dict = {}
        self._means: dict = {}      # key -> [sum, count]

    # -- kv accumulation ---------------------------------------------------

    def logkv(self, key, val):
        self._pending[key] = val

    def logkv_mean(self, key, val):
        s, n = self._means.get(key, (0.0, 0))
        self._means[key] = (s + float(val), n + 1)

    def logkv_sum(self, key, val):
        """Accumulate a TOTAL between dumps (reference ``profile_kv``
        semantics: name2val[name] += dt)."""
        self._pending[key] = self._pending.get(key, 0.0) + float(val)

    def dumpkvs(self) -> dict:
        out = dict(self._pending)
        out.update({k: s / n for k, (s, n) in self._means.items() if n})
        if self.level < DISABLED:
            for sink in self.sinks:
                sink(out)
        self._pending.clear()
        self._means.clear()
        return out

    # -- plain messages ----------------------------------------------------

    def log(self, *args, level=INFO):
        if level >= self.level:
            print(*args, file=sys.stderr, flush=True)
            if self.dir:
                # plain messages also land in the run dir (reference
                # 'log' format writer)
                with open(os.path.join(self.dir, 'log.txt'), 'at') as fh:
                    print(*args, file=fh)

    def set_level(self, level):
        self.level = level

    def close(self):
        self.sinks = ()


_DEFAULT = MetricLogger(sinks=(stdout_sink(),))
_CURRENT = _DEFAULT


def configure(dir: Optional[str] = None, format_strs=None,
              log_suffix: str = '') -> MetricLogger:
    """Install a logger writing to ``dir`` with the given sink names
    (default: stdout + csv + jsonl when a dir is given)."""
    global _CURRENT
    if dir is None:
        dir = os.environ.get('LN3DIFF_LOGDIR') or os.path.join(
            tempfile.gettempdir(), time.strftime('ln3diff-%Y%m%d-%H%M%S'))
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        env = os.environ.get('LN3DIFF_LOG_FORMAT')
        format_strs = env.split(',') if env else ['stdout', 'csv', 'json']
    sinks = tuple(_SINK_FACTORIES[f](dir, log_suffix) for f in format_strs)
    _CURRENT = MetricLogger(dir=dir, sinks=sinks)
    _CURRENT.log(f'logging to {dir}')
    return _CURRENT


def get_current() -> MetricLogger:
    return _CURRENT


def get_dir() -> Optional[str]:
    return _CURRENT.dir


# -- module-level convenience (the API the trainers use) --------------------

def logkv(key, val):
    _CURRENT.logkv(key, val)


def logkv_mean(key, val):
    _CURRENT.logkv_mean(key, val)


def logkvs(d: dict):
    for k, v in d.items():
        _CURRENT.logkv(k, v)


def log_loss_dict(d: dict, prefix: str = ''):
    """Mean-accumulate a metrics dict (reference ``log_loss_dict``)."""
    for k, v in d.items():
        _CURRENT.logkv_mean(prefix + k, v)


def dumpkvs() -> dict:
    return _CURRENT.dumpkvs()


def log(*args, **kwargs):
    _CURRENT.log(*args, **kwargs)


# -- lightweight profiling scopes ------------------------------------------

@contextlib.contextmanager
def profile_kv(scopename: str):
    """Accumulate TOTAL wall-time under ``wait_<scope>`` per dump window
    (reference semantics)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        # total wall time in the scope per dump window (reference
        # ``guided_diffusion/logger.py:299`` accumulates, not averages)
        _CURRENT.logkv_sum('wait_' + scopename, time.perf_counter() - t0)


def profile(n: str):
    def decorator(func):
        def wrapper(*args, **kwargs):
            with profile_kv(n):
                return func(*args, **kwargs)
        return wrapper
    return decorator
