#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the text→3D serving path of ``ln3diff_tpu_torch`` at the full
width of the released Objaverse model (CLIP text tower, DiT-L/2 with
250-step DDIM and CFG 6.5, triplane VAE decode, a 24-frame 192² orbit and
the 192³ σ-grid query) with random weights drawn from a fixed seed, after
building every CUDA kernel from ``ln3diff_tpu_torch/ops/csrc`` with nvcc
and holding each one against its plain PyTorch version.  It prints one
JSON line per phase as the phase finishes, then the ``{"kernels": [...]}``
line, the card's name and power limit from nvidia-smi, and as its last
line ``{"ok": true, "device": {...}}``.  Any failed build, launch or check
exits non-zero without the last line, as does a machine without a CUDA
device.  The run writes nothing into the tree except the kernel build
directory ``ln3diff_tpu_torch/_build/``.

TF32: matmuls run in full f32 (PyTorch's default) and cuDNN's TF32 for f32
convolutions is switched off, so the f32 comparisons below hold the f32
arithmetic of both sides; the full-width path itself runs bf16.
"""

import copy
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import time

BUDGET_S = 900            # wall-clock budget of the whole run
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 without tensor cores

# tolerances of the kernel against its plain version (elementwise
# |Δ| <= atol + rtol·|plain|).  f32 rows: only the order of the f32 MLP
# sums differs.  bf16 rows: both lerp in bf16 with the same rounding
# order; the margin covers the f32 sums and an occasional 1-ulp bf16 tie.
TOL = {'float32': (1e-4, 1e-4), 'bfloat16': (1e-2, 1e-2)}
# small-size pipeline, card vs CPU, both in f32: |Δ| <= TOL_PIPE·max(1,|ref|)
TOL_PIPE = 2e-3

T0 = time.perf_counter()


class SmokeFailure(RuntimeError):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def elapsed():
    return time.perf_counter() - T0


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_done(phase, t0, **fields):
    import torch
    torch.cuda.synchronize()
    emit({'phase': phase, 'seconds': round(time.perf_counter() - t0, 3),
          **fields})
    check(elapsed() < BUDGET_S,
          f'over the {BUDGET_S} s budget after phase {phase}')


def cuda_time_ms(fn, warmup=2, iters=10):
    """Median of ``iters`` CUDA-event timings after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def osg_inputs(M, rows_dtype, with_inbox, seed):
    """Kernel inputs at one call's shapes: rows (3, M, 128), tx/ty/live
    (3, M), inbox (M,), OSG weights with the EqualDense scaling folded."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)
    dev = 'cuda'
    rows = torch.randn((3, M, 128), generator=g, device=dev).to(rows_dtype)
    tx = torch.rand((3, M), generator=g, device=dev)
    ty = torch.rand((3, M), generator=g, device=dev)
    live = (torch.rand((3, M), generator=g, device=dev) > 0.05).float()
    inbox = None
    if with_inbox:
        inbox = (torch.rand((M,), generator=g, device=dev) > 0.2).float()
    w1 = torch.randn((32, 64), generator=g, device=dev) / 32**0.5
    b1 = torch.randn((64,), generator=g, device=dev) * 0.1
    w2 = torch.randn((64, 33), generator=g, device=dev) / 64**0.5
    b2 = torch.randn((33,), generator=g, device=dev) * 0.1
    return (rows, tx, ty, live, w1, b1, w2, b2), inbox


def osg_bound_ms(M, rows_itemsize, with_inbox):
    """Least time for one call: bytes (each input read once, each output
    written once) over HBM bandwidth vs the f32 MLP and lerp operations
    over the f32 rate; the larger of the two."""
    nbytes = (3 * M * 128 * rows_itemsize + 3 * 3 * M * 4
              + (4 * M if with_inbox else 0) + M * 33 * 4
              + 4 * (32 * 64 + 64 + 64 * 33 + 33))
    flops = M * (2 * 32 * 64 + 2 * 64 * 33 + 3 * 32 * 7 + 3 * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def kernel_check():
    """fused_osg against osg_pointwise_reference at the main path's
    shapes: a 192² × 64-sample render pass (with the bbox fold), the same
    with a ragged M, one σ-grid chunk of 2^18 points (no fold), and f32
    rows."""
    import torch
    from ln3diff_tpu_torch.ops.fused_render import (osg_pointwise_fused,
                                                    osg_pointwise_reference)
    pass_M = 192 * 192 * 64
    cases = [('render_pass', pass_M, torch.bfloat16, True),
             ('render_pass_ragged', pass_M + 17, torch.bfloat16, True),
             ('sigma_chunk', 2**18, torch.bfloat16, False),
             ('render_pass_f32', 2**18 + 5, torch.float32, True)]
    results = []
    for i, (name, M, dt, with_inbox) in enumerate(cases):
        args, inbox = osg_inputs(M, dt, with_inbox, seed=100 + i)
        rgb, sigma = osg_pointwise_fused(*args, inbox=inbox)
        torch.cuda.synchronize()
        rgb_ref, sigma_ref = osg_pointwise_reference(*args, inbox=inbox)
        atol, rtol = TOL[str(dt).split('.')[-1]]
        err_rgb = (rgb - rgb_ref).abs()
        err_sig = (sigma - sigma_ref).abs()
        ok = bool(torch.isfinite(rgb).all() and torch.isfinite(sigma).all()
                  and (err_rgb <= atol + rtol * rgb_ref.abs()).all()
                  and (err_sig <= atol + rtol * sigma_ref.abs()).all())
        ms = cuda_time_ms(lambda: osg_pointwise_fused(*args, inbox=inbox))
        plain_ms = cuda_time_ms(
            lambda: osg_pointwise_reference(*args, inbox=inbox))
        bound, bound_by = osg_bound_ms(M, args[0].element_size(), with_inbox)
        res = dict(case=name, M=M, rows_dtype=str(dt), inbox=with_inbox,
                   max_abs_err_rgb=float(err_rgb.max()),
                   max_abs_err_sigma=float(err_sig.max()),
                   atol=atol, rtol=rtol, ok=ok, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=bound_by)
        results.append(res)
        emit({'kernel_check': res})
        check(ok, f'fused_osg disagrees with its plain version on {name}')
        del args, inbox, rgb, sigma, rgb_ref, sigma_ref, err_rgb, err_sig
        torch.cuda.empty_cache()
    return results


def small_reference():
    """A small model through the whole slice on the card and on the CPU,
    same weights and noise, f32 throughout: latents, planes and frames
    must agree (the CPU side runs the kernel's plain version)."""
    import torch
    from ln3diff_tpu_torch.conditioning.clip import CLIPTextConfig
    from ln3diff_tpu_torch.models.dit import DiT2Config, DiTConfig
    from ln3diff_tpu_torch.models.vae import TriplaneVAEConfig
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.pipeline import SamplerSpec, build_t23d_pipeline
    from ln3diff_tpu_torch.render.renderer import RenderOptions

    f32 = torch.float32
    kw = dict(
        den_cfg=DiTConfig(input_size=8, hidden_size=64, depth=2,
                          num_heads=2, context_dim=64, exact_gelu=False,
                          dtype=f32),
        vae_cfg=TriplaneVAEConfig(
            latent_size=8,
            dit2=DiT2Config(tokens_per_plane=16, hidden_size=64, depth=2,
                            num_heads=2, dtype=f32),
            conv_sr_ch=8, conv_sr_ch_mult=(1, 2), dtype=f32),
        text_cfg=CLIPTextConfig(hidden_size=64, num_layers=2, num_heads=2,
                                intermediate_size=128),
        render_opts=dataclasses.replace(
            RenderOptions(), depth_resolution=16,
            depth_resolution_importance=16, filter_out_of_bbox=True),
        render_resolution=32,
        sampler=SamplerSpec(num_steps=10, latent_shape=(8, 8, 12)),
        render_dtype=None)
    cpu_pipe, cpu_enc, mods = build_t23d_pipeline('cpu', seed=7, **kw)
    gpu_pipe, gpu_enc, _ = build_t23d_pipeline(
        'cuda', modules={k: copy.deepcopy(m) for k, m in mods.items()}, **kw)
    noise = torch.randn((1, 8, 8, 12),
                        generator=torch.Generator().manual_seed(3))
    outs = {}
    for name, pipe, enc in (('cpu', cpu_pipe, cpu_enc),
                            ('cuda', gpu_pipe, gpu_enc)):
        FusedOSG.launches = 0
        cond, uncond = enc('a small wooden chair')
        outs[name] = pipe(cond, uncond, num_frames=2, render_resolution=32,
                          x_init=noise)
    check(FusedOSG.launches > 0, 'the card run did not launch fused_osg')
    res = {}
    for key in ('latents', 'planes', 'video'):
        ref = outs['cpu'][key]
        got = outs['cuda'][key].cpu()
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        res[key] = dict(max_abs_err=err, tol=TOL_PIPE * scale)
        check(bool(torch.isfinite(got).all()), f'{key}: non-finite on card')
        check(err <= TOL_PIPE * scale,
              f'{key}: card vs CPU max|Δ| {err} > {TOL_PIPE * scale}')
    return res


def main():
    faulthandler.dump_traceback_later(1100, exit=True)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the card',
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import ln3diff_tpu_torch  # noqa: F401  (fails outside the repository)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ''
    phase_done('device', t0, name=name, count=count, nvidia_smi=smi_line,
               torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build every kernel source with nvcc
    t0 = time.perf_counter()
    from ln3diff_tpu_torch.ops._build import build_all
    builds = build_all()
    phase_done('build', t0, kernels=[
        dict(name=b.name, path=os.path.relpath(b.path, here),
             compile_seconds=round(b.seconds, 3),
             ptxas=[ln for ln in b.log.splitlines() if 'ptxas' in ln])
        for b in builds])

    # 3. each kernel against its plain version
    t0 = time.perf_counter()
    checks = kernel_check()
    phase_done('kernel_check', t0)

    # 4. small model: card vs CPU
    t0 = time.perf_counter()
    small = small_reference()
    phase_done('small_reference', t0, **small)

    # 5. the main path at full width, random weights
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.pipeline import build_t23d_pipeline
    t0 = time.perf_counter()
    pipe, encode, _ = build_t23d_pipeline('cuda', seed=0)
    phase_done('pipeline_build', t0, weights='random (torch.Generator '
               'seed 0); DiT-L/2 bf16 tanh-GELU, DiT2-L/2 VAE decoder bf16, '
               'CLIP-L text f32; ddim250, cfg 6.5, 24 x 192^2 orbit, '
               '64+64 samples, bf16 planes, 192^3 sigma grid')

    walls = {'dit_sample': 0.0, 'vae_decode': 0.0, 'render': 0.0}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            walls[key] += time.perf_counter() - s
            return out
        return run

    pipe.denoiser_fn = timed('dit_sample', pipe.denoiser_fn)
    pipe.decode_fn = timed('vae_decode', pipe.decode_fn)
    pipe.render_fn = timed('render', pipe.render_fn)

    t0 = time.perf_counter()
    cond, uncond = encode('a red wooden chair with four legs')
    text_s = time.perf_counter() - t0

    FusedOSG.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_main = time.perf_counter()
    out = pipe(cond, uncond, batch=1, num_frames=24, render_resolution=192,
               generator=torch.Generator(device='cuda').manual_seed(1))
    torch.cuda.synchronize()
    render_launches = FusedOSG.launches
    FusedOSG.launches = 0
    t1 = time.perf_counter()
    sigma = pipe.dispatch_mesh_sigma(out['planes'].to(torch.bfloat16), 192,
                                     smooth=True)
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t1
    query_launches = FusedOSG.launches
    main_s = time.perf_counter() - t_main

    video, latents = out['video'], out['latents']
    check(tuple(latents.shape) == (1, 32, 32, 12), 'latent shape')
    check(tuple(out['planes'].shape) == (1, 3, 128, 128, 32), 'plane shape')
    check(tuple(video.shape) == (1, 24, 192, 192, 3), 'video shape')
    check(tuple(sigma.shape) == (192**3,), 'sigma grid shape')
    check(bool(torch.isfinite(latents).all()), 'latents not finite')
    check(bool(torch.isfinite(out['planes']).all()), 'planes not finite')
    check(bool(torch.isfinite(video).all()), 'frames not finite')
    vmin, vmax = float(video.min()), float(video.max())
    check(-1.01 <= vmin and vmax <= 1.01, f'frames out of range '
          f'[{vmin}, {vmax}]')
    check(bool(torch.isfinite(sigma).all()), 'sigma grid not finite')
    check(render_launches > 0, 'render did not launch fused_osg')
    check(query_launches > 0, 'sigma query did not launch fused_osg')
    phase_done('pipeline', t0, seconds_by_phase=dict(
        text_encode=round(text_s, 3),
        dit_sample=round(walls['dit_sample'], 3),
        vae_decode=round(walls['vae_decode'], 3),
        render=round(walls['render'], 3), sigma_query=round(query_s, 3)),
        main_path_seconds=round(main_s, 3),
        fused_osg_launches=dict(render=render_launches,
                                query=query_launches),
        frames_range=[vmin, vmax],
        latents_abs_max=float(latents.abs().max()),
        sigma_range=[float(sigma.min()), float(sigma.max())],
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))

    main_check = checks[0]
    emit({'kernels': [dict(
        name='fused_osg', route='cuda',
        source='ln3diff_tpu_torch/ops/csrc/fused_osg.cu',
        replaces='ln3diff_tpu/ops/fused_render.py:98',
        launches=render_launches + query_launches,
        max_abs_err=max(max(c['max_abs_err_rgb'], c['max_abs_err_sigma'])
                        for c in checks),
        ms=main_check['ms'], plain_ms=main_check['plain_ms'],
        bound_ms=main_check['bound_ms'], bound_by=main_check['bound_by'],
        library_ms=None)]})
    print(smi_line, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': count}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
