"""The arithmetic and the geometry of the port's fused triplane point
kernels for Hopper, on the CPU, against the JAX package.

Kernels 1 and 2 (``ln3diff_tpu_torch/ops/csrc/fused_osg.cu`` and
``fused_osg_bwd.cu``) run only on the card.  Here their arithmetic is
emulated in torch, step by step as the kernels take it: the lerp rounded
op by op in the rows' dtype (the kernels' bf16x2 ``mul.rn`` / ``add.rn``
round each op once, as torch's bf16 ops do), the f32 plane mean, every
product on the 3xTF32 split (``cvt.rna`` emulated on the bits) over 8-deep
k-steps in the kernels' permuted k order, softplus from one exponential,
kernel 1's softplus as log(1 + e^-|z|), and for kernel 2 its more
accurate accumulation of the recomputed forward and its weight grads
summed per group of consumer warps over the group's tiles and then over
the (block, group) slots in order.  The emulation is held to
the Pallas kernels of ``ln3diff_tpu.ops.fused_render`` run in interpret
mode on the same numpy inputs, and to the port's plain versions.  The tile
and grid helpers that stay in Python are held to what the kernels expect.
The kernels themselves are checked on the card in
``tests/test_torch_gpu.py``, by ``scripts/osg_card_check.py`` and by
``chip_smoke.py``.

Tolerances (``chip_smoke.py`` ``TOL`` and ``TOL_BWD``, the card's bounds
for a kernel against its plain version): forward |Δ| <= atol + rtol·|ref|,
f32 rows (1e-4, 1e-4), bf16 rows (1e-2, 1e-2); backward |Δ| <=
atol·max|ref| + rtol·|ref|, per-point outputs (1e-5, 1e-4), bf16 row grads
(1e-5, 2e-2), weight grads (1e-4, 1e-4).  f32 rows are held to JAX at
those bounds.  bf16 rows are held to the plain version at those bounds
and to JAX at the bounds of ``tests/test_torch_fused_render.py`` (5e-3
forward, 1e-2 of scale backward, sigmoid only): XLA on the CPU keeps the
bf16 lerp's intermediates in f32 where the kernels and torch round each
op, so features differ from JAX's by a bf16 ulp before the MLP.
"""

import math
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from ln3diff_tpu.ops import fused_render as jfr
from ln3diff_tpu_torch.ops import fused_render as tfr

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

P = tfr.POINTS_PER_TILE
CSRC = Path(tfr.__file__).resolve().parent / 'csrc'
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
TOL_BWD = {'point': (1e-5, 1e-4), 'grows_bf16': (1e-5, 2e-2),
           'weights': (1e-4, 1e-4)}
BWD_NAMES = ('grows', 'gtx', 'gty', 'glive', 'ginbox', 'gw1', 'gb1', 'gw2',
             'gb2')
M_RAGGED = 300          # four full tiles and one of 44 points


# -- the kernels' arithmetic, emulated ----------------------------------------

def tf32_rna(x):
    """``cvt.rna.tf32.f32``: the f32 significand rounded to 10 bits, ties
    away from zero, the low 13 bits cleared (on the bits: the float's
    sign and magnitude are separate, so adding half an ulp of the kept
    bits rounds the magnitude)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def x_order():
    """k order of x·w1: k-step kk, positions t and t + 4 are channels
    8t + 2kk and 8t + 2kk + 1 (lane t lerped channels 8t .. 8t + 7)."""
    return [[8 * (p % 4) + 2 * kk + p // 4 for p in range(8)]
            for kk in range(4)]


def c_order(n):
    """k order of a product whose A is an earlier product's C fragments
    (n columns): k-step kk, positions t and t + 4 are 8kk + 2t and
    8kk + 2t + 1."""
    return [[8 * kk + 2 * (p % 4) + p // 4 for p in range(8)]
            for kk in range(n // 8)]


def mma3(a, b, order, d=None):
    """d + a @ b as the kernels run it: per 8-deep k-step (``order``),
    d += a_lo·b_hi, then a_hi·b_lo, then a_hi·b_hi, each an f32 sum of
    eight exact products."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if d is None:
        d = torch.zeros((a.shape[0], b.shape[1]))
    for idx in order:
        d = d + a_lo[:, idx] @ b_hi[idx]
        d = d + a_hi[:, idx] @ b_lo[idx]
        d = d + a_hi[:, idx] @ b_hi[idx]
    return d


def mma3_acc(a, b, order):
    """a @ b as kernel 2 runs its forward recompute: the small terms in
    their own f32 sum, each k-step's a_hi·b_hi summed from zero and added
    to the big sum, the two added at the end."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    d = torch.zeros((a.shape[0], b.shape[1]))
    s = torch.zeros_like(d)
    for idx in order:
        s = s + a_lo[:, idx] @ b_hi[idx]
        s = s + a_hi[:, idx] @ b_lo[idx]
        d = d + a_hi[:, idx] @ b_hi[idx]
    return d + s


def pad_outputs(w2, b2):
    """w2 (64, 33), b2 (33,) → the kernels' 40 columns: rgb 0..31, σ at
    32, zeros."""
    w2p = torch.cat([w2[:, 1:], w2[:, :1], torch.zeros((w2.shape[0], 7))], 1)
    b2p = torch.cat([b2[1:], b2[:1], torch.zeros(7)])
    return w2p, b2p


def unpad(gp):
    """(…, 40) in the kernels' column order → (…, 33) as [σ, rgb]."""
    return torch.cat([gp[..., 32:33], gp[..., :32]], -1)


def lerp(rows, tx, ty, live):
    """f32 x (M, 32) and the per-corner weights (3, M, 1) in the rows'
    dtype: each op rounded to the rows' dtype, planes summed in f32 in
    order from 0, then × f32(1/3)."""
    C = 32
    dt = rows.dtype
    fx, fy, fl = (v[..., None].to(dt) for v in (tx, ty, live))
    omx, omy = 1 - fx, 1 - fy
    w = [(omx * omy) * fl, (fx * omy) * fl, (omx * fy) * fl, (fx * fy) * fl]
    c = [rows[..., q * C:(q + 1) * C] for q in range(4)]
    f = (((w[0] * c[0] + w[1] * c[1]) + w[2] * c[2]) + w[3] * c[3]).float()
    x = torch.zeros_like(f[0])
    for k in range(3):
        x = x + f[k]
    return x * np.float32(1.0 / 3.0), w, c


def softplus_sfu(z):
    """Kernel 1's softplus: max(z, 0) + log(1 + exp(-|z|)) (the kernel
    takes exp and log from the special-function unit)."""
    return torch.clamp(z, min=0) + torch.log(1 + torch.exp(-z.abs()))


def softplus_sigmoid(z):
    e = torch.exp(-z.abs())
    return torch.clamp(z, min=0) + torch.log1p(e), torch.where(
        z >= 0, 1 / (1 + e), e / (1 + e))


def act_and_grad(v, activation):
    if activation == 'sigmoid':
        s = torch.sigmoid(v)
        return s * 1.002 - 0.001, s * (1 - s) * 1.002
    sqrt2 = math.sqrt(2.0)
    return (F.leaky_relu(v, 0.2) * sqrt2,
            torch.where(v >= 0, 1.0, 0.2) * sqrt2)


def emulate_forward(rows, tx, ty, live, w1, b1, w2, b2, activation,
                    inbox=None):
    """Kernel 1: (rgb (M, 32), sigma (M, 1)) f32."""
    x, _, _ = lerp(rows, tx, ty, live)
    w2p, b2p = pad_outputs(w2, b2)
    h = softplus_sfu(mma3(x, w1, x_order()) + b1)
    o = mma3(h, w2p, c_order(64)) + b2p
    rgb, _ = act_and_grad(o[:, :32], activation)
    sigma = o[:, 32:33]
    if inbox is not None:
        m = inbox[:, None]
        rgb = rgb * m
        sigma = torch.where(m > 0, sigma, torch.full_like(sigma, -1e10))
    return rgb, sigma


def emulate_backward(rows, tx, ty, live, w1, b1, w2, b2, g_rgb, g_sigma,
                     activation, inbox=None, nblocks=2, groups=2):
    """Kernel 2 on ``nblocks`` persistent blocks of ``groups`` groups of
    consumer warps: the nine outputs of
    ``osg_pointwise_backward_reference``."""
    M = rows.shape[1]
    dt = rows.dtype
    x, w, c = lerp(rows, tx, ty, live)
    w2p, b2p = pad_outputs(w2, b2)
    h, sg = softplus_sigmoid(mma3_acc(x, w1, x_order()) + b1)
    o = mma3_acc(h, w2p, c_order(64)) + b2p
    act, dact = act_and_grad(o[:, :32], activation)
    ginbox = None
    g_in, g_sig = g_rgb, g_sigma
    if inbox is not None:
        m = inbox[:, None]
        ginbox = (g_rgb * act).sum(-1)
        g_in = g_rgb * m
        g_sig = torch.where(m > 0, g_sigma, torch.zeros_like(g_sigma))
    g_out = torch.cat([g_in * dact, g_sig, torch.zeros((M, 7))], 1)
    g_hpre = mma3(g_out, w2p.t(), c_order(40)) * sg
    g_f = mma3(g_hpre, w1.t(), c_order(64)) * np.float32(1.0 / 3.0)

    grows = torch.cat([wq * g_f.to(dt) for wq in w], -1)
    s = [(g_f * cq.float()).sum(-1) for cq in c]
    gtx = live * ((1 - ty) * (s[1] - s[0]) + ty * (s[3] - s[2]))
    gty = live * ((1 - tx) * (s[2] - s[0]) + tx * (s[3] - s[1]))
    glive = ((1 - tx) * (1 - ty) * s[0] + tx * (1 - ty) * s[1]
             + (1 - tx) * ty * s[2] + tx * ty * s[3])

    # weight grads: block b's tiles are b, b + nblocks, …; its group q
    # sums every groups-th of them in order, 8 points per k-step; then the
    # partials are added in (block, group) order
    tiles = tfr.tiles(M)
    pad = tiles * P - M
    xp, hp, gop, ghp = (F.pad(t, (0, 0, 0, pad))
                        for t in (x, h, g_out, g_hpre))
    parts = []
    for blk, grp in ((b, q) for b in range(nblocks) for q in range(groups)):
        gw1 = torch.zeros((32, 64))
        gw2 = torch.zeros((64, 40))
        gb1, gb2 = torch.zeros(64), torch.zeros(40)
        for tile in list(range(blk, tiles, nblocks))[grp::groups]:
            pts = slice(tile * P, (tile + 1) * P)
            steps = [list(range(k0, k0 + 8)) for k0 in range(0, P, 8)]
            gw2 = mma3(hp[pts].t(), gop[pts], steps, gw2)
            gw1 = mma3(xp[pts].t(), ghp[pts], steps, gw1)
            gb1 = gb1 + ghp[pts].sum(0)
            gb2 = gb2 + gop[pts].sum(0)
        parts.append((gw1, gb1, gw2, gb2))
    gw1, gb1, gw2, gb2 = (sum(p[i] for p in parts) for i in range(4))
    return (grows, gtx, gty, glive, ginbox, gw1, gb1, unpad(gw2),
            unpad(gb2))


# -- inputs and the JAX side --------------------------------------------------

def _inputs(M, seed, with_inbox):
    rng = np.random.default_rng(seed)
    d = dict(
        rows=rng.standard_normal((3, M, 128)).astype(np.float32),
        tx=rng.uniform(0, 1, (3, M)).astype(np.float32),
        ty=rng.uniform(0, 1, (3, M)).astype(np.float32),
        live=(rng.uniform(0, 1, (3, M)) > 0.05).astype(np.float32),
        w1=(rng.standard_normal((32, 64)) / math.sqrt(32)).astype(np.float32),
        b1=(rng.standard_normal(64) * 0.1).astype(np.float32),
        w2=(rng.standard_normal((64, 33)) / 8).astype(np.float32),
        b2=(rng.standard_normal(33) * 0.1).astype(np.float32),
        inbox=((rng.uniform(0, 1, M) > 0.2).astype(np.float32)
               if with_inbox else None),
        g_rgb=rng.standard_normal((M, 32)).astype(np.float32),
        g_sigma=rng.standard_normal((M, 1)).astype(np.float32))
    return d


def _torch(d, rows_dtype):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in d.items()}
    t['rows'] = t['rows'].to(rows_dtype)
    return t


def _jax(d, rows_dtype):
    j = {k: None if v is None else jnp.asarray(v) for k, v in d.items()}
    j['rows'] = j['rows'].astype(rows_dtype)
    return j


_ARGS = ('rows', 'tx', 'ty', 'live', 'w1', 'b1', 'w2', 'b2')


def _jax_forward(d, rows_dtype, activation):
    j = _jax(d, rows_dtype)
    rgb, sigma = jfr.osg_pointwise_fused(
        *(j[k] for k in _ARGS), activation=activation, interpret=True,
        inbox=j['inbox'])
    return np.asarray(rgb), np.asarray(sigma)


def _jax_backward(d, rows_dtype, activation):
    j = _jax(d, rows_dtype)
    return jfr._osg_backward(*(j[k] for k in _ARGS), j['inbox'],
                             j['g_rgb'], j['g_sigma'], activation, True, 128)


def _forward_close(got, want, rows_dtype, atol=None):
    a, r = TOL[rows_dtype]
    if atol is not None:
        a, r = atol, 0.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=a, rtol=r)


def _backward_close(got, want, rows_dtype, rel=None):
    """TOL_BWD per output kind, or |Δ| <= rel·max|want| when given."""
    for name, g, w in zip(BWD_NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        g = g.float().numpy()
        w = (w.float().numpy() if torch.is_tensor(w)
             else np.asarray(w, np.float32))
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        if rel is not None:
            atol, rtol = rel, 0.0
        elif name.startswith(('gw', 'gb')):
            atol, rtol = TOL_BWD['weights']
        elif name == 'grows' and rows_dtype == torch.bfloat16:
            atol, rtol = TOL_BWD['grows_bf16']
        else:
            atol, rtol = TOL_BWD['point']
        np.testing.assert_allclose(g, w, atol=atol * scale, rtol=rtol,
                                   err_msg=name)


# -- the emulation against JAX and the plain versions -------------------------

@pytest.mark.parametrize('activation', ['sigmoid', 'lrelu'])
@pytest.mark.parametrize('with_inbox', [False, True])
def test_forward_emulation_matches_pallas_f32(activation, with_inbox):
    """f32 rows: kernel 1's arithmetic against the Pallas kernel in
    interpret mode at the card's TOL, ragged M."""
    d = _inputs(M_RAGGED, 1, with_inbox)
    t = _torch(d, torch.float32)
    got = emulate_forward(*(t[k] for k in _ARGS), activation, t['inbox'])
    _forward_close(got, _jax_forward(d, jnp.float32, activation),
                   torch.float32)


@pytest.mark.parametrize('activation', ['sigmoid', 'lrelu'])
@pytest.mark.parametrize('with_inbox', [False, True])
def test_forward_emulation_bf16(activation, with_inbox):
    """bf16 rows: kernel 1's arithmetic against the plain version at the
    card's TOL, and against the Pallas kernel in interpret mode at 5e-3
    (the bf16 lerp gap of XLA on the CPU)."""
    d = _inputs(M_RAGGED, 2, with_inbox)
    t = _torch(d, torch.bfloat16)
    args = [t[k] for k in _ARGS]
    got = emulate_forward(*args, activation, t['inbox'])
    want = tfr.osg_pointwise_reference(*args, activation=activation,
                                       inbox=t['inbox'])
    _forward_close(got, want, torch.bfloat16)
    _forward_close(got, _jax_forward(d, jnp.bfloat16, activation),
                   torch.bfloat16, atol=5e-3)


@pytest.mark.parametrize('activation', ['sigmoid', 'lrelu'])
@pytest.mark.parametrize('with_inbox', [False, True])
def test_backward_emulation_matches_pallas_f32(activation, with_inbox):
    """f32 rows: kernel 2's arithmetic, its weight grads summed over two
    persistent blocks, against the Pallas backward kernel in interpret
    mode at the card's TOL_BWD, ragged M."""
    d = _inputs(M_RAGGED, 3, with_inbox)
    t = _torch(d, torch.float32)
    got = emulate_backward(*(t[k] for k in _ARGS), t['g_rgb'], t['g_sigma'],
                           activation, t['inbox'])
    _backward_close(got, _jax_backward(d, jnp.float32, activation),
                    torch.float32)


@pytest.mark.parametrize('activation', ['sigmoid', 'lrelu'])
@pytest.mark.parametrize('with_inbox', [False, True])
def test_backward_emulation_bf16(activation, with_inbox):
    """bf16 rows: kernel 2's arithmetic (row grads w_k·round(g_f) in bf16)
    against the plain version at the card's TOL_BWD; with sigmoid also
    against the Pallas backward in interpret mode at 1e-2 of scale
    (lrelu's derivative jumps at 0, where the lerp gap flips it)."""
    d = _inputs(M_RAGGED, 4, with_inbox)
    t = _torch(d, torch.bfloat16)
    args = [t[k] for k in _ARGS]
    got = emulate_backward(*args, t['g_rgb'], t['g_sigma'], activation,
                           t['inbox'], nblocks=3)
    assert got[0].dtype == torch.bfloat16
    want = tfr.osg_pointwise_backward_reference(
        *args, t['g_rgb'], t['g_sigma'], activation=activation,
        inbox=t['inbox'])
    _backward_close(got, want, torch.bfloat16)
    if activation == 'sigmoid':
        _backward_close(got, _jax_backward(d, jnp.bfloat16, activation),
                        torch.bfloat16, rel=1e-2)


@pytest.mark.parametrize('nblocks', [1, 2, 5, 7])
@pytest.mark.parametrize('groups', [1, 2])
def test_backward_weight_grads_do_not_depend_on_the_grid(nblocks, groups):
    """The persistent grid and the groups of consumer warps change only
    the order of the weight-grad sums (more blocks than tiles leave blocks
    and groups without a tile)."""
    d = _inputs(M_RAGGED, 5, True)
    t = _torch(d, torch.float32)
    args = [t[k] for k in _ARGS]
    one = emulate_backward(*args, t['g_rgb'], t['g_sigma'], 'sigmoid',
                           t['inbox'], nblocks=1, groups=1)
    got = emulate_backward(*args, t['g_rgb'], t['g_sigma'], 'sigmoid',
                           t['inbox'], nblocks=nblocks, groups=groups)
    _backward_close(got, one, torch.float32)


# -- the pieces of the arithmetic ---------------------------------------------

def test_tf32_split_keeps_f32_precision():
    """a = hi + lo to 2^-22 of a (hi keeps 11 bits, lo the next 11), both
    TF32 (low 13 bits clear, as cvt.rna leaves them), and the 3xTF32
    product of random f32 matrices is within a few f32 ulps of the f64
    product, where one TF32 pass is not."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn((64, 32), generator=g)
    b = torch.randn((32, 64), generator=g)
    hi, lo = split(a)
    assert bool(((hi.double() + lo.double() - a.double()).abs()
                 <= a.double().abs() * 2.0**-22).all())
    for v in (hi, lo):
        assert not bool((v.view(torch.int32) & 0x1FFF).any())
    exact = a.double() @ b.double()
    err3 = float((mma3(a, b, x_order()).double() - exact).abs().max())
    err1 = float((tf32_rna(a).double() @ tf32_rna(b).double()
                  - exact).abs().max())
    scale = float(exact.abs().max())
    assert err3 < 1e-6 * scale < err1


def test_tf32_rna_rounds_ties_away_from_zero():
    """cvt.rna: a value halfway between two TF32 values goes to the one of
    larger magnitude, for either sign."""
    one = 1.0
    half_ulp = 2.0 ** -11           # TF32 keeps 10 fraction bits
    x = torch.tensor([one + half_ulp, -(one + half_ulp),
                      one + half_ulp / 2, one + 3 * half_ulp])
    got = tf32_rna(x).tolist()
    assert got == [one + 2 * half_ulp, -(one + 2 * half_ulp), one,
                   one + 4 * half_ulp]


def test_k_orders_are_what_the_lanes_hold():
    """Every product's k order is a permutation, and lane (g, t) feeds
    x·w1 exactly the channels it lerped (8t .. 8t + 7), and the next
    product exactly the C-fragment columns it holds (8kk + 2t, + 1)."""
    assert sorted(sum(x_order(), [])) == list(range(32))
    for n in (40, 64):
        assert sorted(sum(c_order(n), [])) == list(range(n))
    for t in range(4):
        held = {ch for kk, idx in enumerate(x_order())
                for p, ch in enumerate(idx) if p % 4 == t}
        assert held == set(range(8 * t, 8 * t + 8))
        for kk, idx in enumerate(c_order(64)):
            assert {idx[t], idx[t + 4]} == {8 * kk + 2 * t, 8 * kk + 2 * t + 1}


def test_bf16_op_rounding_is_one_rounding():
    """A bf16 product or sum of two bf16 values rounded to f32 and then to
    bf16 equals one rounding to bf16 (f32 keeps 24 >= 2·8 + 2 bits): so the
    kernel's bf16x2 ``mul.rn`` / ``add.rn`` give the op-by-op f32 version's
    bits."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn(200_000, generator=g).to(torch.bfloat16)
    b = torch.randn(200_000, generator=g).to(torch.bfloat16)
    for op in (torch.mul, torch.add):
        once = op(a.double(), b.double()).to(torch.bfloat16)
        twice = op(a.float(), b.float()).to(torch.bfloat16)
        assert torch.equal(once, twice)


def test_softplus_forms():
    """Kernel 2's softplus and sigmoid from one e^-|z| agree with torch's
    to f32 rounding, and kernel 1's log(1 + e^-|z|) form to its absolute
    rounding error (z up to ±30, where 1 + e^-|z| rounds to 1)."""
    z = torch.linspace(-30, 30, 10_001)
    sp, sg = softplus_sigmoid(z)
    torch.testing.assert_close(sp, F.softplus(z), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(sg, torch.sigmoid(z), atol=1e-7, rtol=1e-6)
    torch.testing.assert_close(softplus_sfu(z), F.softplus(z), atol=1e-6,
                               rtol=0)


# -- the tile, grid and copy helpers ------------------------------------------

@pytest.mark.parametrize('M', [1, 63, 64, 65, 2**16, 192 * 192 * 64 + 17])
@pytest.mark.parametrize('sms', [1, 132])
def test_persistent_grid(M, sms):
    """One block per SM, at most one per tile; block b's tiles b, b +
    grid, … cover every tile once."""
    n = tfr.tiles(M)
    assert (n - 1) * P < M <= n * P
    grid = tfr.persistent_blocks(M, sms)
    assert grid == min(n, sms) >= 1
    covered = sorted(tile for b in range(grid) for tile in range(b, n, grid))
    assert covered == list(range(n))


@pytest.mark.parametrize('M', [1, 15, 63, 64, 65, 66, 127, 191, 193, 8449,
                               65553, 192 * 192 * 64 + 17])
@pytest.mark.parametrize('rows_dtype', [torch.bfloat16, torch.float32])
def test_bulk_copies_stay_inside_the_tensors(M, rows_dtype):
    """The producer's bulk copies of a tile (one per plane, n rows of
    4C values from row k·M + m0; kernel 2 also n rows of g_rgb) start and
    end on 16-byte boundaries and never pass the plane's or the tensor's
    end; the per-point f32 inputs of plane k start k·M·4 bytes in, which
    is 16-byte aligned only when M % 4 == 0, so those are 4-byte copies."""
    row_bytes = 128 * torch.tensor([], dtype=rows_dtype).element_size()
    for tile in range(tfr.tiles(M)):
        m0 = tile * P
        n = min(P, M - m0)
        assert n >= 1
        for k in range(3):
            start = (k * M + m0) * row_bytes
            size = n * row_bytes
            assert start % 16 == 0 and size % 16 == 0
            assert start + size <= (k + 1) * M * row_bytes
        assert (m0 * 128) % 16 == 0 and (n * 128) % 16 == 0    # g_rgb
    assert all((k * M * 4) % 16 == 0 for k in range(3)) == (M % 4 == 0)


@pytest.mark.parametrize('rows_dtype', [torch.bfloat16, torch.float32])
def test_rings_fit_shared_memory(rows_dtype):
    """The shared memory of each kernel's block, as its Layout lays it out
    (weights in fragment order, kernel 2's biases and each consumer
    group's two weight-grad buffers, the ring's stages of rows and
    per-point inputs),
    fits the 227 KB a block may take, and the weights' scratch (4257
    floats) fits where it is staged: a stage (kernel 1) or a group's
    buffers (kernel 2)."""
    es = torch.tensor([], dtype=rows_dtype).element_size()
    rows = 3 * P * 128 * es
    frag = 32 * 16                                   # one (kk, nt) pre-split
    fwd = (128 + (4 * 8 + 8 * 5) * frag
           + tfr.FORWARD_STAGES[rows_dtype] * (rows + 10 * P * 4))
    bufs = P * (72 + 40) * 4       # h then g_hpre; g_out then x
    bwd = (128 + (4 * 8 + 8 * 5 + 5 * 8 + 8 * 4) * frag // 2 + 512
           + tfr.BACKWARD_GROUPS[rows_dtype]
           * (bufs + rows + P * 32 * 4 + 11 * P * 4))
    assert fwd <= 232_448 and bwd <= 232_448
    raw = 4 * (32 * 64 + 64 * 33)
    assert raw <= rows and raw <= bufs


def _c_params(source, symbol):
    """The parameter count of an ``extern "C"`` entry point."""
    text = (CSRC / source).read_text()
    m = re.search(rf'int {symbol}\(([^)]*)\)', text)
    return len(m.group(1).split(','))


def test_ctypes_signatures_match_the_entry_points():
    """The wrappers' ctypes argument lists have one type per parameter of
    the C entry points (a missing one reads past the call's arguments)."""
    assert len(tfr._FWD_ARGTYPES) == _c_params(
        'fused_osg.cu', 'ln3diff_fused_osg_forward')
    assert len(tfr._BWD_ARGTYPES) == _c_params(
        'fused_osg_bwd.cu', 'ln3diff_fused_osg_backward')
