#!/usr/bin/env python3
"""Quick card check of the port's fused triplane point kernels (kernels 1
and 2).

    python3 scripts/osg_card_check.py [--ablate]

On one CUDA card: builds ``ops/csrc/fused_osg.cu`` and
``ops/csrc/fused_osg_bwd.cu`` (printing each kernel's registers, shared
memory and spills from ``-Xptxas -v``), holds both kernels against their
plain versions around their 64-point tiles and rings (``EDGES``), for
bf16 and f32 rows, with and without the bbox fold and with both
activations, under ``chip_smoke.py``'s ``TOL`` and ``TOL_BWD``, each
launched twice and compared bit for bit (with lrelu, the cotangent of a
colour whose pre-activation lies within 1e-5 of 0 in the plain forward
is zeroed in both backward runs: lrelu' jumps there, and either side is
right for sums taken in another order); then times each kernel's device
ms at the main path's shapes beside its bound, from CUDA events around
back-to-back launches of its C entry point and from torch.profiler over
its wrapper, with the wrapper's host µs and the SM clock.  With
``--ablate`` it also builds three cut-down variants of each kernel
(``OSG_ABLATE``; kernel 1: 1 streams the tiles and stores zeros, 2 skips
the MLP, 3 skips the copies; kernel 2: 1 skips the weight grads, 2 the
row grads, 3 the exponentials, logarithms and divisions) and times them
at the main shapes, which splits each kernel's time between its parts.
Exits non-zero on the first disagreement.  A shorter loop than
``chip_smoke.py`` for work on these two kernels; imports no JAX.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ln3diff_tpu_torch.ops import _build  # noqa: E402
from ln3diff_tpu_torch.ops import fused_render as fr  # noqa: E402

# point counts around the tiles (64 points), the forward's bf16 ring
# (3 tiles), one pass of a 132-block grid, and the training launch; M % 4
# takes every value (the per-point inputs' planes start k·M·4 bytes in)
EDGES = (1, 15, 63, 64, 65, 66, 127, 128, 129, 191, 193, 8447, 8449,
         65536, 65553)
RENDER_M = 192 * 192 * 64
TRAIN_M = 64 * 32 * 32


def forward_case(M, dt, with_inbox, act, seed):
    args, inbox = cs.osg_inputs(M, dt, with_inbox, seed)
    got = fr.osg_pointwise_fused(*args, activation=act, inbox=inbox)
    again = fr.osg_pointwise_fused(*args, activation=act, inbox=inbox)
    torch.cuda.synchronize()
    want = fr.osg_pointwise_reference(*args, activation=act, inbox=inbox)
    atol, rtol = cs.TOL[str(dt).split('.')[-1]]
    ok, err = True, 0.0
    for a, b in zip(got, want):
        d = (a - b).abs()
        ok &= bool(a.isfinite().all() and (d <= atol + rtol * b.abs()).all())
        err = max(err, float(d.max()))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    return ok and same, err, same


def near_lrelu_kink(args, tol=1e-5):
    """Colour pre-activations within ``tol`` of 0 in the plain forward,
    where lrelu' jumps: kernel 2 sums its f32 products in another order,
    so there it may take either side, and either derivative is right."""
    ref = fr.osg_pointwise_reference(*args, activation='lrelu')[0]
    return ref.abs() <= tol


def backward_case(M, dt, with_inbox, act, seed):
    args, inbox = cs.osg_inputs(M, dt, with_inbox, seed)
    g = torch.Generator(device='cuda').manual_seed(seed + 1)
    g_rgb = torch.randn((M, 32), generator=g, device='cuda')
    g_sig = torch.randn((M, 1), generator=g, device='cuda')
    if act == 'lrelu':
        g_rgb = g_rgb.masked_fill(near_lrelu_kink(args), 0.0)
    got = fr.osg_pointwise_backward(*args, g_rgb, g_sig, activation=act,
                                    inbox=inbox)
    again = fr.osg_pointwise_backward(*args, g_rgb, g_sig, activation=act,
                                      inbox=inbox)
    torch.cuda.synchronize()
    want = fr.osg_pointwise_backward_reference(*args, g_rgb, g_sig,
                                               activation=act, inbox=inbox)
    errs, ok = cs._bwd_errors(got, want, str(dt).split('.')[-1])
    same = all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, again))
    if not ok:
        print(f'  max|Δ| per output: {errs}')
    return ok and same, max(errs.values()), same


def edges():
    """Both kernels around their tiles; False at the first failure."""
    n = 0
    for M in EDGES:
        for dt in (torch.bfloat16, torch.float32):
            for with_inbox in (True, False):
                for act in ('sigmoid', 'lrelu'):
                    n += 1
                    for name, case in (('forward', forward_case),
                                       ('backward', backward_case)):
                        ok, err, same = case(M, dt, with_inbox, act, n)
                        if not ok:
                            print(f'{name} M={M} {dt} inbox={with_inbox} '
                                  f'{act}: max|Δ| {err}, repeatable {same}: '
                                  f'FAIL', flush=True)
                            return False
        print(f'M={M}: both kernels ok (max|Δ| of the last case {err})',
              flush=True)
    return True


def smi(query):
    return subprocess.run(['nvidia-smi', f'--query-gpu={query}',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def forward_launcher(fn, args, inbox):
    """A call that launches kernel 1's C entry ``fn`` once on
    preallocated outputs (no wrapper: a launch costs the host a few µs)."""
    rows, tx, ty, live, w1, b1, w2, b2 = args
    M = rows.shape[1]
    rgb = torch.empty((M, 32), device='cuda')
    sigma = torch.empty((M, 1), device='cuda')
    ptrs = (rows.data_ptr(), int(rows.dtype == torch.bfloat16),
            tx.data_ptr(), ty.data_ptr(), live.data_ptr(),
            None if inbox is None else inbox.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), rgb.data_ptr(),
            sigma.data_ptr(), M, 0, fr._blocks(M, rows.device))
    return lambda: _build.launch(rows.device, fn, *ptrs)


def backward_launcher(fn, args, inbox, g_rgb, g_sig):
    """The same for kernel 2's C entry (main kernel and reduce)."""
    rows, tx, ty, live, w1, b1, w2, b2 = args
    M = rows.shape[1]
    grows = torch.empty_like(rows)
    gtx, gty, glive = (torch.empty((3, M), device='cuda') for _ in range(3))
    ginbox = None if inbox is None else torch.empty((M,), device='cuda')
    wgrad = torch.empty((fr._NW,), device='cuda')
    nblocks = fr._blocks(M, rows.device)
    partials = torch.empty((nblocks * fr.BACKWARD_GROUPS[rows.dtype]
                            * fr._NW,), device='cuda')
    ptrs = (rows.data_ptr(), int(rows.dtype == torch.bfloat16),
            tx.data_ptr(), ty.data_ptr(), live.data_ptr(),
            None if inbox is None else inbox.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), g_rgb.data_ptr(),
            g_sig.data_ptr(), grows.data_ptr(), gtx.data_ptr(),
            gty.data_ptr(), glive.data_ptr(),
            None if ginbox is None else ginbox.data_ptr(),
            partials.data_ptr(), nblocks, wgrad.data_ptr(), M, 0)
    return lambda: _build.launch(rows.device, fn, *ptrs)


def events_ms(launch, n=20, reps=3):
    """Device ms per launch: the median over ``reps`` of CUDA events around
    ``n`` back-to-back launches, after three warm-up launches."""
    for _ in range(3):
        launch()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            rc = launch()
        b.record()
        b.synchronize()
        if rc != 0:
            raise RuntimeError(f'launch failed: CUDA error {rc}')
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[len(times) // 2]


FWD = ('fused_osg', 'ln3diff_fused_osg_forward')
BWD = ('fused_osg_bwd', 'ln3diff_fused_osg_backward')


def cotangents(M, seed):
    g = torch.Generator(device='cuda').manual_seed(seed)
    return (torch.randn((M, 32), generator=g, device='cuda'),
            torch.randn((M, 1), generator=g, device='cuda'))


def timings():
    """Each kernel's device ms at the main shapes, from CUDA events around
    back-to-back launches of its C entry and from torch.profiler over the
    wrapper, beside its bound, with the wrapper's host µs and the SM clock
    and power draw."""
    print(f'card: {smi("name,power.limit")}', flush=True)
    fwd = _build.LIBRARIES.function(*FWD, fr._FWD_ARGTYPES)
    bwd = _build.LIBRARIES.function(*BWD, fr._BWD_ARGTYPES)
    for name, M, dt, with_inbox in (
            ('render_pass', RENDER_M, torch.bfloat16, True),
            ('training_launch', TRAIN_M, torch.bfloat16, True),
            ('sigma_chunk', 2**18, torch.bfloat16, False),
            ('f32_rows', 2**18 + 5, torch.float32, True)):
        args, inbox = cs.osg_inputs(M, dt, with_inbox, 7)

        def call():
            return fr.osg_pointwise_fused(*args, inbox=inbox)

        bound, by = cs.osg_bound_ms(M, args[0].element_size(), with_inbox)
        ev = events_ms(forward_launcher(fwd, args, inbox))
        print(f'kernel 1 {name} M={M} {dt}: device {ev:.4f} ms (events; '
              f'profiler {cs.device_ms(call):.4f}), bound {bound:.4f} ms '
              f'({by}, {bound / ev:.0%}), host {cs.host_us(call):.1f} µs; '
              f'SM clock, power {smi("clocks.sm,power.draw")}', flush=True)
    for name, M, dt in (('training_launch', TRAIN_M, torch.bfloat16),
                        ('f32_rows', TRAIN_M, torch.float32)):
        args, inbox = cs.osg_inputs(M, dt, True, 8)
        g_rgb, g_sig = cotangents(M, 9)

        def call():
            return fr.osg_pointwise_backward(*args, g_rgb, g_sig, inbox=inbox)

        bound, by = cs.osg_bwd_bound_ms(M, args[0].element_size(), True)
        ev = events_ms(backward_launcher(bwd, args, inbox, g_rgb, g_sig))
        prof = cs.device_ms(call, stages=cs.BWD_STAGES)
        print(f'kernel 2 {name} M={M} {dt}: device {ev:.4f} ms (events, '
              f'with the reduce; profiler {prof}), bound {bound:.4f} ms '
              f'({by}, {bound / ev:.0%}), host {cs.host_us(call):.1f} µs',
              flush=True)


ABLATIONS = {
    FWD: {1: 'stream + store only', 2: 'stream + lerp, no MLP',
          3: 'lerp + MLP, no copies'},
    BWD: {1: 'no weight grads', 2: 'no row grads',
          3: 'no exp / log1p / divide (softplus, sigmoid)'},
}


def ablations():
    """Each kernel and its OSG_ABLATE variants at its main shape (kernel 1
    the render pass, kernel 2 the training launch), device ms from CUDA
    events, in turns (0, 1, 2, 3, 3, 2, 1, 0)."""
    out_dir = _build.BUILD_DIR / 'ablate'
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, _ in ABLATIONS:
        for v in (1, 2, 3):
            so = out_dir / f'{name}_ablate{v}.so'
            procs[name, v] = (so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, f'-DOSG_ABLATE={v}',
                 '-o', str(so), str(_build.CSRC / f'{name}.cu')],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for (name, v), (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f'{name} ablation {v} did not build:\n{err}')
            return False
        libs[name, v] = ctypes.CDLL(str(so))

    args, inbox = cs.osg_inputs(RENDER_M, torch.bfloat16, True, 10)
    bargs, binbox = cs.osg_inputs(TRAIN_M, torch.bfloat16, True, 11)
    g_rgb, g_sig = cotangents(TRAIN_M, 12)
    for key, names in ABLATIONS.items():
        name, symbol = key
        argtypes = fr._FWD_ARGTYPES if key == FWD else fr._BWD_ARGTYPES
        fns = {0: _build.LIBRARIES.function(name, symbol, argtypes)}
        for v in names:
            fns[v] = getattr(libs[name, v], symbol)
            fns[v].argtypes, fns[v].restype = argtypes, ctypes.c_int
        launchers = {
            v: (forward_launcher(fn, args, inbox) if key == FWD
                else backward_launcher(fn, bargs, binbox, g_rgb, g_sig))
            for v, fn in fns.items()}
        times = {v: [] for v in fns}
        for v in (0, 1, 2, 3, 3, 2, 1, 0):
            times[v].append(events_ms(launchers[v]))
        for v, ts in times.items():
            label = names.get(v, 'full kernel')
            print(f'{name} ablation {v} ({label}): device '
                  f'{[round(x, 4) for x in ts]} ms', flush=True)
        print(f'SM clock, power after the ablations of {name}: '
              f'{smi("clocks.sm,power.draw")}', flush=True)
    return True


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ablate', action='store_true',
                        help='also time the OSG_ABLATE variants of kernel 1')
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print('osg_card_check: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for r in _build.build_all(['fused_osg', 'fused_osg_bwd']):
        print(f'built {r.name} in {r.seconds:.1f} s')
        for ln in r.log.splitlines():
            if 'Used' in ln or 'spill' in ln or 'Compiling' in ln:
                print('  ', ln.strip())
    print(torch.cuda.get_device_name(0), flush=True)
    if not edges():
        print('osg_card_check: FAILED')
        return 1
    timings()
    if opts.ablate and not ablations():
        print('osg_card_check: FAILED')
        return 1
    print('osg_card_check: ok')
    return 0


if __name__ == '__main__':
    sys.exit(main())
