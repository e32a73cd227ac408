"""Device-op profiler: a ``torch.profiler`` trace of a callable and its
per-kernel table (time, count, name, long name).

Port of ``scripts/scripts_lib/profile_device.py`` (``parse_trace_dir``
:32, ``profile_fn`` :60, ``_cli`` :83).  JAX's table lists the XLA
fusions of an xplane trace; this one lists the device kernels of the
Chrome trace that ``torch.profiler`` writes with CUDA activity (the
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events), one row per
kernel: its total µs, its launches, its function name and, as the long
name, its full (template) name.  On a process without a card the rows are
the CPU ops (``cpu_op`` events), the long name their input shapes.

    from ln3diff_tpu_torch.scripts.profile_device import profile_fn
    rows = profile_fn(lambda: model(x, t, ctx), iters=20)

    python -m ln3diff_tpu_torch.scripts.profile_device --what dit
    python -m ln3diff_tpu_torch.scripts.profile_device --what int8

The CLI profiles a DiT-L/2 denoise step (the t23d preset, random weights,
bf16, batch 2 over a 77-token context); ``--what int8`` serves it as JAX's
``int8`` does: tanh GELU, then ``quantize_dit``.  ``torch.profiler`` at
times records no CUDA activity, and an empty table would pass for a
result: :func:`profile_fn` raises when a trace of work on the card holds
no kernel event.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import tempfile
import time
from typing import Optional

import torch

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


def kernel_function_name(name: str) -> str:
    """A kernel's function name: its (demangled) name without the return
    type, the template arguments and the parameter list."""
    depth, out = 0, []
    for ch in name:
        if ch in '<(':
            depth += 1
        elif ch in '>)':
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    words = ''.join(out).split()
    # '(anonymous namespace)::f' leaves '::f'
    return words[-1].lstrip(':') if words else name


def _load(path: str) -> list:
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
        data = json.load(f)
    return data.get('traceEvents', []) if isinstance(data, dict) else data


def parse_trace(events: list, top: int = 25, device: bool = True) -> list:
    """The per-op table of Chrome trace ``events`` → ``[(total_us, count,
    name, long_name)]``, longest first, at most ``top`` rows.  ``device``:
    one row per device kernel (``DEVICE_CATEGORIES``) by its full name —
    ``name`` a kernel's function name (a copy's or set's full name),
    ``long_name`` the full name; else one row
    per CPU op (``cpu_op``) — ``long_name`` its first input shapes."""
    tot = collections.Counter()
    cnt = collections.Counter()
    names, long_names = {}, {}
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        cat = e.get('cat', '')
        if device and cat in DEVICE_CATEGORIES:
            key = e['name']
            names.setdefault(key, kernel_function_name(key)
                             if cat == 'kernel' else key)
            long_names.setdefault(key, key)
        elif not device and cat == 'cpu_op':
            key = e['name']
            names.setdefault(key, key)
            long_names.setdefault(key, str(e.get('args', {}).get(
                'Input Dims', '')))
        else:
            continue
        tot[key] += e['dur']
        cnt[key] += 1
    return [(tot[k], cnt[k], names[k], long_names[k])
            for k, _ in tot.most_common(top)]


def parse_trace_dir(trace_dir: str, top: int = 25,
                    device: bool = True) -> list:
    """:func:`parse_trace` of the newest ``*.json`` / ``*.json.gz`` trace
    under ``trace_dir`` (searched recursively); [] when there is none."""
    paths = [p for pat in ('*.json', '*.json.gz') for p in glob.glob(
        os.path.join(trace_dir, '**', pat), recursive=True)]
    if not paths:
        return []
    return parse_trace(_load(max(paths, key=os.path.getmtime)), top, device)


def _sync(device: torch.device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def profile_fn(fn, iters: int = 20, top: int = 25,
               trace_dir: Optional[str] = None, quiet: bool = False,
               device=None) -> list:
    """Call ``fn`` once outside the trace (warm-up), then ``iters`` times
    under ``torch.profiler`` (CPU activity, and CUDA activity on a card),
    synchronise, and return and print the op table (:func:`parse_trace`).
    One more call runs first as the profiler's own warm-up step, traced
    and discarded (``torch.profiler.schedule(warmup=1)``): a trace that
    starts with the recorded calls has lost a block's worth of kernels at
    its start on the card.  Each call is synchronised before its step
    ends, so its kernels land in its step.  The table holds the ``iters``
    calls' device kernels when ``device`` (default: ``'cuda'`` when a
    card is present) is a CUDA device, else their CPU ops.  The Chrome
    trace is written under ``trace_dir`` (default: a temporary directory,
    removed).  Raises ``RuntimeError`` when a CUDA trace holds no kernel
    event."""
    device = torch.device(device or ('cuda' if torch.cuda.is_available()
                                     else 'cpu'))
    on_card = device.type == 'cuda'
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    fn()
    _sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = trace_dir or tmp
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f'trace-{os.getpid()}-'
                                     f'{time.time_ns()}.pt.trace.json')
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=iters,
                                           repeat=1)
        with torch.profiler.profile(
                activities=activities, record_shapes=True, schedule=schedule,
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for _ in range(iters + 1):
                fn()
                _sync(device)
                prof.step()
        events = _load(path)
    if on_card and not any(e.get('cat') == 'kernel' for e in events):
        raise RuntimeError(
            f'the profiler recorded no CUDA kernel in {iters} calls on '
            f'{device}: an empty device table is no measurement')
    rows = parse_trace(events, top=top, device=on_card)
    if not quiet:
        for total_us, count, name, long_name in rows:
            per = total_us / max(count, 1)
            print(f'{total_us / 1e3:9.2f} ms  x{count:<5} {per:8.1f} '
                  f'us/call  {name}: {long_name[:90]}', flush=True)
    return rows


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--what', default='dit', choices=['dit', 'int8'])
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    return parser


def build_step(args):
    """``(step, model)``: one DiT-L/2 call on zeros (x (2, 32, 32, 12),
    t (2,), a (2, 77, 768) context) with random weights from seed 0, the
    model in bf16 on ``args.device``; ``--what int8`` with tanh GELU and
    ``quantize_dit``."""
    import dataclasses

    from ..config import denoiser_preset
    from ..models.dit import DiT_TriLatent
    from ..models.layers import random_init_
    from ..pipeline import resolve_device

    device = resolve_device(args.device)
    cfg = denoiser_preset('t23d-dit-l2')
    if args.what == 'int8':
        cfg = dataclasses.replace(cfg, exact_gelu=False)   # serving mode
    with torch.device(device):
        model = DiT_TriLatent(cfg)
    random_init_(model, torch.Generator(device=device).manual_seed(0))
    model = model.to(device).to(cfg.dtype).eval()
    if args.what == 'int8':
        from ..ops.int8 import quantize_dit
        model = quantize_dit(model)
    x = torch.zeros((2, 32, 32, 12), device=device)
    t = torch.zeros((2,), device=device)
    ctx = {'crossattn': torch.zeros((2, 77, 768), device=device)}

    @torch.no_grad()
    def step():
        return model(x, t, ctx)
    return step, model


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    step, _ = build_step(args)
    return profile_fn(step, iters=args.iters, device=args.device)


if __name__ == '__main__':
    main()
