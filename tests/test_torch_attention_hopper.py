"""The arithmetic and the geometry of the port's bf16 attention kernels for
Hopper, on the CPU, against the JAX package.

The wgmma kernels of ``ln3diff_tpu_torch/ops/csrc`` (kernel 3's
``attn::sm90::attention_kernel``, run by kernel 4 as its attention stage,
and kernel 4's projection ``proj::sm90::projection_kernel``) run only on
the card.  Here their arithmetic is emulated in torch, step by step as the
kernels take it, and held to the Pallas kernels of
``ln3diff_tpu.ops.fused_attention`` run in interpret mode on the same
numpy inputs; and the tile and tensor-map helpers that stay in Python are
held to what the kernels expect.  The kernels themselves are checked on the
card in ``tests/test_torch_gpu.py`` and by ``chip_smoke.py``.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ln3diff_tpu.ops import fused_attention as jfa
from ln3diff_tpu_torch.ops import fused_attention as tfa
from ln3diff_tpu_torch.ops.fused_attention import (
    KEY_TILE, PROJ_K_CHUNK, key_mask, key_tiles, qkv_attention_reference,
    split_qkv_weights, tma_geometry)

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

# the card's bf16 tolerance (chip_smoke.py TOL_ATTN, tests/test_torch_gpu.py
# ATTN_TOL): |Δ| <= 4e-3 + 1e-2·|ref|.  Both sides round p and o to bf16
# from f32 values computed in another order (here also exp2 with log2(e)
# folded into the scale, and 1/l multiplied in), so an element may land
# one bf16 ulp away, and a p one ulp away moves o by about 2^-8·p·|v|.
ATOL, RTOL = 4e-3, 1e-2
LOG2E = np.float32(1.4426950408889634)


def _emulate_attention(q, k, v):
    """Kernel 3's bf16 arithmetic on ``(B, L, H, d)`` bf16 tensors, in the
    kernel's order: s = q·kᵀ in f32; c = f32(1/√d)·log2(e) in f32; pass 1
    a running row max m and sum l of 2^(s·c - m) over key tiles of
    ``KEY_TILE`` keys, keys >= L at -inf; pass 2 p = 2^(s·c - m)·(1/l),
    rounded to bf16, and o += p·v in f32 one key tile at a time; o rounded
    to bf16."""
    B, L, H, d = q.shape
    c = torch.tensor(np.float32(1.0 / math.sqrt(d)) * LOG2E)
    n = key_tiles(L) * KEY_TILE
    pad = (0, 0, 0, 0, 0, n - L)          # zero rows, as TMA fills them
    qf = q.float().permute(0, 2, 1, 3)                      # (B, H, L, d)
    kf = torch.nn.functional.pad(k.float(), pad).permute(0, 2, 1, 3)
    vf = torch.nn.functional.pad(v.float(), pad).permute(0, 2, 1, 3)
    valid = key_mask(L)                                     # (tiles, 64)
    m = torch.full((B, H, L, 1), -math.inf)
    l = torch.zeros((B, H, L, 1))
    tiles = range(key_tiles(L))
    for j in tiles:
        kt = kf[:, :, j * KEY_TILE:(j + 1) * KEY_TILE]
        x = (qf @ kt.transpose(-1, -2)) * c
        x = x.masked_fill(~valid[j], -math.inf)
        mn = torch.maximum(m, x.amax(-1, keepdim=True))
        l = l * torch.exp2(m - mn) + torch.exp2(x - mn).sum(-1, keepdim=True)
        m = mn
    inv_l = 1.0 / l
    o = torch.zeros((B, H, L, d))
    for j in tiles:
        sl = slice(j * KEY_TILE, (j + 1) * KEY_TILE)
        s = qf @ kf[:, :, sl].transpose(-1, -2)
        p = torch.exp2(s * c - m) * inv_l
        p = p.masked_fill(~valid[j], 0.0).to(torch.bfloat16)
        o = o + p.float() @ vf[:, :, sl]
    return o.permute(0, 2, 1, 3).to(torch.bfloat16)


def _emulate_projection(x, w, b):
    """Kernel 4's projection of one of q, k, v: x ``(B, L, D)`` and the
    head-major weight ``(H, D, d)`` in bf16, the f32 sum taken over chunks
    of ``PROJ_K_CHUNK`` of D in order, the f32 bias added, one rounding:
    ``(B, L, H, d)`` bf16."""
    D = x.shape[-1]
    acc = 0.0
    for k0 in range(0, D, PROJ_K_CHUNK):
        acc = acc + torch.einsum('bld,hde->blhe',
                                 x[..., k0:k0 + PROJ_K_CHUNK].float(),
                                 w[:, k0:k0 + PROJ_K_CHUNK].float())
    return (acc + b.float()).to(torch.bfloat16)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


# -- (a) kernel 3's arithmetic ------------------------------------------------

@pytest.mark.parametrize('shape', [(2, 96, 4, 64), (2, 77, 4, 32),
                                   (1, 1, 2, 64)],
                         ids=['two_tiles', 'ragged_d32', 'one_key'])
def test_kernel3_arithmetic_matches_pallas_bf16(shape):
    """The emulated kernel against the Pallas kernel in interpret mode, bf16
    inputs, within the card's bf16 tolerance; and against the plain
    version ``attention_reference`` within the same tolerance."""
    q, k, v = _qkv(shape, seed=sum(shape))
    want = np.asarray(jfa.fused_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
        interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = _emulate_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    plain = tfa.attention_reference(tq, tk, tv).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), plain, rtol=RTOL,
                               atol=ATOL)


def test_kernel3_masks_zero_filled_keys():
    """Keys past L read as zero rows (TMA's fill) give s = 0, not -inf:
    without the explicit mask a query whose scores are all negative would
    put most of its weight on them.  The emulation masks; dropping the
    mask moves the output far outside the tolerance."""
    L, d = 3, 64
    q = torch.full((1, L, 1, d), -1.0, dtype=torch.bfloat16)
    k = torch.full((1, L, 1, d), 1.0, dtype=torch.bfloat16)
    v = torch.arange(L * d, dtype=torch.float32).reshape(1, L, 1, d)
    v = (v / (L * d)).to(torch.bfloat16)
    want = tfa.attention_reference(q, k, v)
    got = _emulate_attention(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL,
                               rtol=RTOL)
    assert not key_mask(L)[0, L:].any()
    # the same arithmetic with the zero rows counted as keys
    unmasked = torch.nn.functional.pad(
        torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()), (0, 61))
    p = torch.softmax(unmasked / math.sqrt(d), -1)[..., :L]
    assert float(p.sum(-1).max()) < 0.5


# -- (b) tile and tensor-map geometry ------------------------------------------

@pytest.mark.parametrize('L,tiles', [(1, 1), (63, 1), (64, 1), (65, 2),
                                     (77, 2), (768, 12), (2048, 32)])
def test_key_tiles_and_mask(L, tiles):
    """Each pass streams ceil(L/64) key tiles; the mask keeps exactly the
    first L keys of them."""
    assert key_tiles(L) == tiles
    mask = key_mask(L)
    assert mask.shape == (tiles, KEY_TILE) and mask.dtype == torch.bool
    flat = mask.reshape(-1)
    assert int(flat.sum()) == L and bool(flat[:L].all())


def test_tma_geometry_contiguous():
    """A contiguous (B, L, H, d) bf16 tensor: dims (d, L, H, B) and byte
    strides (H·d, d, L·H·d)·2."""
    B, L, H, d = 2, 77, 16, 64
    t = torch.zeros((B, L, H, d), dtype=torch.bfloat16)
    dims, strides = tma_geometry(t)
    assert dims == (d, L, H, B)
    assert strides == (H * d * 2, d * 2, L * H * d * 2)


def test_tma_geometry_qkv_thirds_and_heads_first():
    """The thirds of one qkv projection keep the projection's row stride
    3·H·d (read in place, no copy); a heads-first tensor seen as
    (B, L, H, d) has head stride L·d.  f32 counts 4 bytes an element."""
    B, L, H, d = 2, 100, 4, 32
    qkv = torch.zeros((B, L, 3 * H * d), dtype=torch.bfloat16)
    views = [t.reshape(B, L, H, d) for t in qkv.chunk(3, dim=-1)]
    for view in views:
        dims, strides = tma_geometry(view)
        assert dims == (d, L, H, B)
        assert strides == (3 * H * d * 2, d * 2, L * 3 * H * d * 2)
    assert views[1].data_ptr() - views[0].data_ptr() == H * d * 2
    heads_first = torch.zeros((B, H, L, d)).permute(0, 2, 1, 3)
    _, strides = tma_geometry(heads_first)
    assert strides == (d * 4, L * d * 4, H * L * d * 4)


def test_tma_geometry_rejects_what_tma_cannot_read():
    """A byte stride that is not a multiple of 16 (rows of 36 bf16
    elements = 72 bytes, cut to d = 32) and a strided d raise ValueError,
    as fused_attention does before any launch."""
    t = torch.zeros((1, 8, 3, 36), dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match='multiples of 16'):
        tma_geometry(t, 'q')
    t = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match='unit stride'):
        tma_geometry(t, 'k')


# -- (c) kernel 4's projection --------------------------------------------------

def _qkv_inputs(B, L, D, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    w = (0.05 * rng.standard_normal((D, 3 * D))).astype(np.float32)
    b = (0.05 * rng.standard_normal((3 * D,))).astype(np.float32)
    return x, w, b


QKV_SHAPES = [(2, 96, 128, 4), (2, 77, 256, 4)]


@pytest.mark.parametrize('B,L,D,H', QKV_SHAPES, ids=['d32', 'ragged_d64'])
def test_projection_arithmetic_matches_plain_qkv(B, L, D, H):
    """The K-chunked f32 sums with the bias and one rounding against the
    plain version's q, k and v (one f32 einsum plus the bias, one
    rounding): the f32 sums differ in order only, so an element may round
    to the neighbouring bf16 value, at most one ulp, 2^-7 relative
    (measured well inside)."""
    x, w, b = _qkv_inputs(B, L, D, seed=B + L + D)
    ws, bs = split_qkv_weights(torch.from_numpy(w).to(torch.bfloat16),
                               torch.from_numpy(b).to(torch.bfloat16), H)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for wm, bm in zip(ws, bs):
        got = _emulate_projection(tx, wm, bm)
        want = (torch.einsum('bld,hde->blhe', tx.float(), wm.float())
                + bm.float()).to(torch.bfloat16)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                                   rtol=2.0**-7)


@pytest.mark.parametrize('B,L,D,H', QKV_SHAPES, ids=['d32', 'ragged_d64'])
def test_kernel4_arithmetic_matches_pallas_bf16(B, L, D, H):
    """The emulated projection, then the emulated kernel 3 on its q, k and
    v, against JAX's ``fused_qkv_attention(interpret=True)`` in bf16, and
    against the plain version, within the card's bf16 tolerance
    (chip_smoke.py TOL_QKV)."""
    x, w, b = _qkv_inputs(B, L, D, seed=B + L + D)
    (jwq, jwk, jwv), (jbq, jbk, jbv) = jfa.split_qkv_weights(
        jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), H)
    want = np.asarray(jfa.fused_qkv_attention(
        jnp.asarray(x, jnp.bfloat16), jwq, jwk, jwv, jbq, jbk, jbv,
        num_heads=H, interpret=True).astype(jnp.float32))
    ws, bs = split_qkv_weights(torch.from_numpy(w).to(torch.bfloat16),
                               torch.from_numpy(b).to(torch.bfloat16), H)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    q, k, v = (_emulate_projection(tx, wm, bm) for wm, bm in zip(ws, bs))
    got = _emulate_attention(q, k, v).reshape(B, L, D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    plain = qkv_attention_reference(tx, *ws, *bs, H).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), plain, rtol=RTOL,
                               atol=ATOL)
