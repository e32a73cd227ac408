#!/usr/bin/env python3
"""Quick card check of the model layer's last switches and of the
profiler trace.

    python3 scripts/switches_card_check.py [--trace-runs 5]

On one CUDA card: builds the kernels, runs ``chip_smoke.py``'s
``vae_variants`` phase (the Objaverse VAE at the released width with the
LRM point decoder and DiT2 without roll-out; no kernel may launch), then
its ``profiling_trace`` phase in ``--trace-runs`` fresh processes one
after another: each traces 3 calls of the fused DiT-L/2 with
``utils.profiling.trace`` and prints the trace's kernel-3 events beside
kernel 3's launches (72).  One JSON line per run, the card's name and
power limit, and a summary line last; exits non-zero if any run fails.
A shorter loop than ``chip_smoke.py``; imports no JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402


def trace_child():
    """One ``profiling_trace`` run in this process: its JSON line, or the
    failure's message."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as workdir:
        step = smoke.fused_dit_l2_step()
        try:
            res = dict(ok=True, **smoke.profiling_trace(workdir, step))
        except smoke.SmokeFailure as e:
            res = dict(ok=False, failure=str(e))
    smoke.emit(dict(run='profiling_trace', **res))
    return 0 if res['ok'] else 1


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--trace-runs', type=int, default=5)
    parser.add_argument('--trace-child', action='store_true',
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('switches_card_check: no CUDA device', file=sys.stderr)
        return 1
    from ln3diff_tpu_torch.ops._build import build_all
    build_all()
    if args.trace_child:
        return trace_child()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smoke.zero_kernel_launches()
    variants = smoke.vae_variants()
    smoke.emit(dict(run='vae_variants',
                    seconds=round(time.perf_counter() - t0, 3),
                    kernel_launches=smoke.no_kernel_launches('vae_variants'),
                    **variants))
    rcs = []
    for _ in range(args.trace_runs):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--trace-child'], cwd=ROOT, timeout=600)
        rcs.append(proc.returncode)
        print(json.dumps(dict(run_seconds=round(time.perf_counter() - t0,
                                                3))), flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    smoke.emit(dict(ok=not any(rcs), trace_run_rcs=rcs,
                    device=torch.cuda.get_device_name(0)))
    return 1 if any(rcs) else 0


if __name__ == '__main__':
    sys.exit(main())
