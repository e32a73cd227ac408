#!/usr/bin/env python3
"""Quick card check of the port's attention kernels (kernels 3 and 4).

    python3 scripts/attention_card_check.py

On one CUDA card: builds ``ops/csrc/fused_attention.cu`` and
``ops/csrc/fused_qkv_attention.cu`` (printing each kernel's registers and
spills from ``-Xptxas -v``), holds kernel 3 against ``attention_reference``
in bf16 around its 64-row tiles (L from 1 to 2048, d = 32 and 64, the
qkv-thirds views) and in f32, and kernel 4's projection workspace and
output against the plain versions, each launched twice and compared bit
for bit; then times kernel 3 and ``scaled_dot_product_attention`` at the
DiT-L/2 self-attention's shapes (and L = 2048) and kernel 4's two stages,
as device time under torch.profiler, and splits the host time of kernel
3's wrapper.  Exits non-zero on the first disagreement.  A shorter loop
than ``chip_smoke.py`` for work on these two kernels; imports no JAX.
"""

import math
import os
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ln3diff_tpu_torch.ops import fused_attention as fa  # noqa: E402
from ln3diff_tpu_torch.ops._build import build_all  # noqa: E402

# chip_smoke.py TOL_ATTN / TOL_QKV: |Δ| <= atol + rtol·|plain|
TOL = {torch.bfloat16: (4e-3, 1e-2), torch.float32: (2e-5, 2e-5)}


def close(got, want, dtype):
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got).all()
              and (err <= atol + rtol * want.float().abs()).all())
    return ok, float(err.max())


def attention_case(B, L, H, d, dtype, thirds=False, seed=0):
    g = torch.Generator(device='cuda').manual_seed(seed)
    if thirds:
        qkv = torch.randn((B, L, 3 * H * d), generator=g,
                          device='cuda').to(dtype)
        q, k, v = (t.reshape(B, L, H, d) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn((B, L, H, d), generator=g,
                               device='cuda').to(dtype) for _ in range(3))
    got = fa.fused_attention(q, k, v)
    again = fa.fused_attention(q, k, v)
    torch.cuda.synchronize()
    ok, err = close(got, fa.attention_reference(q, k, v), dtype)
    same = bool(torch.equal(got, again))
    print(f'kernel 3 {(B, L, H, d)} {dtype} thirds={thirds}: max|Δ| {err} '
          f'{"ok" if ok else "FAIL"}, repeatable {same}', flush=True)
    return ok and same


def qkv_case(B, L, D, H, dtype, seed=1):
    """Kernel 4 with the workspace of stage A in hand, so that the
    projection is checked on its own."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    d = D // H
    x = torch.randn((B, L, D), generator=g, device='cuda').to(dtype)
    w = (torch.randn((D, 3 * D), generator=g, device='cuda')
         / D**0.5).to(dtype)
    b = (0.1 * torch.randn((3 * D,), generator=g, device='cuda')).to(dtype)
    ws, bs = fa.split_qkv_weights(w, b, H)
    args = (x, *ws, *bs)
    work = torch.full((B, L, 3, H, d), float('nan'), dtype=dtype,
                      device='cuda')
    o = torch.empty((B, L, D), dtype=dtype, device='cuda')
    fn = fa.LIBRARIES.function('fused_qkv_attention',
                               'ln3diff_fused_qkv_attention',
                               fa._QKV_ARGTYPES)
    rc = fa.launch(x.device, fn, *(t.data_ptr() for t in args),
                   work.data_ptr(), o.data_ptr(),
                   int(dtype == torch.bfloat16), B, L, H, d,
                   1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    if rc:
        print(f'kernel 4 {(B, L, D, H)} {dtype}: launch returned {rc}')
        return False
    want_work = torch.stack([
        (torch.einsum('bld,hde->blhe', x.float(), wm.float())
         + bm.float()).to(dtype) for wm, bm in zip(ws, bs)], dim=2)
    ok_p, err_p = close(work, want_work, dtype)
    ok_o, err_o = close(o, fa.qkv_attention_reference(*args, H), dtype)
    same = bool(torch.equal(fa.fused_qkv_attention(*args, num_heads=H),
                            fa.fused_qkv_attention(*args, num_heads=H)))
    print(f'kernel 4 {(B, L, D, H)} {dtype}: projection max|Δ| {err_p} '
          f'{"ok" if ok_p else "FAIL"}, output max|Δ| {err_o} '
          f'{"ok" if ok_o else "FAIL"}, repeatable {same}', flush=True)
    return ok_p and ok_o and same


def device_ms(fn, calls=10):
    """Device ms per call by kernel name, torch.profiler (CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = (getattr(e, 'self_device_time_total', None)
              or getattr(e, 'self_cuda_time_total', 0))
        if us > 0:
            out[e.key[:60]] = us / calls / 1e3
    return out


def host_us(fn, calls=500):
    """Host µs per call of back-to-back calls (enqueue only)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main():
    if not torch.cuda.is_available():
        print('attention_card_check: no CUDA device', file=sys.stderr)
        return 1
    for r in build_all(['fused_attention', 'fused_qkv_attention']):
        print(f'built {r.name} in {r.seconds:.1f} s')
        for ln in r.log.splitlines():
            if 'Used' in ln or 'spill' in ln:
                print('  ', ln.strip())
    print(torch.cuda.get_device_name(0), flush=True)

    ok = True
    for d in (64, 32):
        for L in (1, 64, 65, 77, 128, 768, 2048):
            ok &= attention_case(1 if L == 2048 else 2, L,
                                 16 if L >= 768 else 4, d, torch.bfloat16)
    ok &= attention_case(2, 768, 16, 64, torch.bfloat16, thirds=True)
    ok &= attention_case(2, 100, 4, 32, torch.bfloat16, thirds=True)
    ok &= attention_case(2, 77, 16, 64, torch.float32, thirds=True)
    ok &= attention_case(2, 768, 16, 64, torch.float32)
    for case in ((2, 77, 1024, 16), (2, 96, 128, 4), (1, 200, 512, 8),
                 (2, 768, 1024, 16)):
        ok &= qkv_case(*case, torch.bfloat16)
    ok &= qkv_case(2, 77, 1024, 16, torch.float32)
    if not ok:
        print('attention_card_check: FAILED')
        return 1

    for L in (768, 2048):
        g = torch.Generator(device='cuda').manual_seed(3)
        qkv = torch.randn((2, L, 3 * 1024), generator=g,
                          device='cuda').to(torch.bfloat16)
        q, k, v = (t.reshape(2, L, 16, 64) for t in qkv.chunk(3, dim=-1))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        print(f'device ms, (2, {L}, 16, 64) bf16: kernel 3',
              device_ms(lambda: fa.fused_attention(q, k, v)), 'SDPA',
              device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)))
    g = torch.Generator(device='cuda').manual_seed(4)
    x = torch.randn((2, 768, 1024), generator=g,
                    device='cuda').to(torch.bfloat16)
    w = (torch.randn((1024, 3072), generator=g, device='cuda')
         / 32).to(torch.bfloat16)
    ws, bs = fa.split_qkv_weights(w, None, 16)
    print('device ms, kernel 4 at (2, 768, 1024, 16 heads) bf16:',
          device_ms(lambda: fa.fused_qkv_attention(x, *ws, *bs,
                                                   num_heads=16)))

    # host time of kernel 3's wrapper and of its parts, at the DiT shape
    g = torch.Generator(device='cuda').manual_seed(3)
    qkv = torch.randn((2, 768, 3 * 1024), generator=g,
                      device='cuda').to(torch.bfloat16)
    q, k, v = (t.reshape(2, 768, 16, 64) for t in qkv.chunk(3, dim=-1))
    o = torch.empty((2, 768, 16, 64), dtype=torch.bfloat16, device='cuda')
    fn = fa.LIBRARIES.function('fused_attention', 'ln3diff_fused_attention',
                               fa._ATTN_ARGTYPES)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 2,
            768, 16, 64, *fa._byte_strides(q, 'q'),
            *fa._byte_strides(k, 'k'), *fa._byte_strides(v, 'v'),
            2048, 128, 768 * 2048, 0.125,
            torch.cuda.current_stream().cuda_stream)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    print('host µs per call:', dict(
        wrapper=host_us(lambda: fa.fused_attention(q, k, v)),
        c_entry_alone=host_us(lambda: fn(*args)),
        output_alloc=host_us(lambda: torch.empty(
            (2, 768, 16, 64), dtype=torch.bfloat16, device='cuda')),
        stride_checks=host_us(lambda: [fa._byte_strides(t, 'q')
                                       for t in (q, k, v)]),
        sdpa=host_us(lambda: F.scaled_dot_product_attention(qt, kt, vt))))
    print('attention_card_check: ok')
    return 0


if __name__ == '__main__':
    sys.exit(main())
