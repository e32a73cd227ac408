"""The fused qkv projection + attention of the port against the JAX package
on the CPU.

``ln3diff_tpu_torch.ops.fused_attention.qkv_attention_reference`` (the
plain version of the CUDA kernel ``csrc/fused_qkv_attention.cu``, which is
what ``fused_qkv_attention`` runs on CPU tensors) is held to the Pallas
kernel ``ln3diff_tpu.ops.fused_attention.fused_qkv_attention`` run in
interpret mode, on the same numpy inputs; the port's ``split_qkv_weights``
to JAX's; the kernel's function on a DiT ``Attention``'s qkv weights to the
JAX module; and the chain of ``.bench_megakernel.py`` (x ← 0.5·y + 0.5·x
in the input dtype, y from the kernel) to the same chain through the
Pallas kernel.  The kernel itself is checked on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import os
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.ops import fused_attention as jfa
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.ops.fused_attention import (FusedAttention,
                                                   FusedQKVAttention,
                                                   attention_reference,
                                                   fused_qkv_attention,
                                                   qkv_attention_reference,
                                                   split_qkv_weights)

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

JDT = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}
TDT = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _inputs(B, L, D, seed, x_scale=1.0, w_scale=0.05, b_scale=0.05):
    """x (B, L, D), one (D, 3D) qkv kernel and its (3D,) bias, f32 numpy."""
    rng = np.random.default_rng(seed)
    x = (x_scale * rng.standard_normal((B, L, D))).astype(np.float32)
    w = (w_scale * rng.standard_normal((D, 3 * D))).astype(np.float32)
    b = (b_scale * rng.standard_normal((3 * D,))).astype(np.float32)
    return x, w, b


def _pallas(x, w, b, H, dtype):
    """JAX's split and kernel in interpret mode, as f32 numpy."""
    jd = JDT[dtype]
    (wq, wk, wv), (bq, bk, bv) = jfa.split_qkv_weights(
        jnp.asarray(w, jd), jnp.asarray(b, jd), H)
    out = jfa.fused_qkv_attention(jnp.asarray(x, jd), wq, wk, wv, bq, bk, bv,
                                  num_heads=H, interpret=True)
    assert out.dtype == jd
    return np.asarray(out.astype(jnp.float32))


def _torch_args(x, w, b, H, dtype):
    td = TDT[dtype]
    ws, bs = split_qkv_weights(torch.from_numpy(w).to(td),
                               torch.from_numpy(b).to(td), H)
    return (torch.from_numpy(x).to(td), *ws, *bs)


@pytest.mark.parametrize('with_bias', [True, False])
def test_split_qkv_weights_matches_jax(with_bias):
    """The head-major layout of an ``arange`` kernel and bias at D = 32,
    H = 4 equals JAX's, exactly; a ``None`` bias gives zeros."""
    D, H = 32, 4
    kernel = np.arange(D * 3 * D, dtype=np.float32).reshape(D, 3 * D)
    bias = np.arange(3 * D, dtype=np.float32) if with_bias else None
    jw, jb = jfa.split_qkv_weights(
        jnp.asarray(kernel), None if bias is None else jnp.asarray(bias), H)
    tw, tb = split_qkv_weights(
        torch.from_numpy(kernel),
        None if bias is None else torch.from_numpy(bias), H)
    for j, t in zip(jw + jb, tw + tb):
        assert t.is_contiguous() and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if bias is None:
        assert all(not t.any() for t in tb)


SHAPES = [(2, 96, 128, 4), (2, 77, 256, 4), (1, 64, 128, 2)]


@pytest.mark.parametrize('B,L,D,H', SHAPES)
def test_plain_matches_pallas_f32(B, L, D, H):
    """f32 at the JAX test's shape (d = 32), a ragged L with d = 64 and
    d = 64 at B = 1: the two differ only in f32 summation order (tolerance
    of tests/test_fused_attention.py, 2e-5; measured 1.8e-7)."""
    x, w, b = _inputs(B, L, D, seed=B + L + D)
    got = qkv_attention_reference(*_torch_args(x, w, b, H, 'float32'), H)
    assert got.dtype == torch.float32 and got.shape == (B, L, D)
    np.testing.assert_allclose(got.numpy(), _pallas(x, w, b, H, 'float32'),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('B,L,D,H', SHAPES)
def test_plain_matches_pallas_bf16(B, L, D, H):
    """bf16: both round q, k, v, p and o to bf16 from f32 values summed in
    another order, so an element may land one bf16 ulp away (2^-7
    relative), as for kernel 3: |Δ| <= 4e-3 + 1e-2·|pallas| (measured at
    most 2.0e-3, one ulp, at an output scale of 0.57)."""
    x, w, b = _inputs(B, L, D, seed=B + L + D)
    got = qkv_attention_reference(*_torch_args(x, w, b, H, 'bfloat16'), H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _pallas(x, w, b, H, 'bfloat16'),
                               rtol=1e-2, atol=4e-3)


def test_plain_rounds_after_the_f32_bias():
    """q, k and v are rounded once, after the bias is added in f32: with
    one key the output is v itself, so it shows the rounding of
    v = round(f32(x·wv) + f32(bv)).  Here x·wv = 1 + 2^-8 (a tie in bf16)
    and bv = 2^-9: rounded once that is 1 + 2^-7; rounding the product
    first (to 1, the even neighbour) and then the sum would give 1."""
    D, H = 32, 1
    x = torch.zeros((1, 1, D), dtype=torch.bfloat16)
    x[0, 0, :2] = 1.0
    w = torch.zeros((D, 3 * D), dtype=torch.bfloat16)
    w[0, 2 * D:] = 1.0
    w[1, 2 * D:] = 2.0**-8
    b = torch.zeros((3 * D,), dtype=torch.bfloat16)
    b[2 * D:] = 2.0**-9
    ws, bs = split_qkv_weights(w, b, H)
    got = qkv_attention_reference(x, *ws, *bs, H)
    assert got.dtype == torch.bfloat16
    assert (got == 1.0 + 2.0**-7).all()


def test_cpu_tensors_run_the_plain_version():
    """``fused_qkv_attention`` on CPU tensors is the plain version, bit for
    bit, and counts no launch of either attention kernel."""
    x, w, b = _inputs(2, 40, 128, seed=3)
    args = _torch_args(x, w, b, 4, 'float32')
    before = (FusedAttention.launches, FusedQKVAttention.launches)
    got = fused_qkv_attention(*args, num_heads=4)
    assert (FusedAttention.launches, FusedQKVAttention.launches) == before
    torch.testing.assert_close(got, qkv_attention_reference(*args, 4),
                               atol=0, rtol=0)


def _meta(B=1, L=8, D=128, H=2, dtype=torch.bfloat16):
    d = D // H
    return [torch.empty(s, dtype=dtype, device='meta')
            for s in [(B, L, D)] + [(H, D, d)] * 3 + [(H, d)] * 3]


def _transposed_wq(args):
    args[1] = torch.empty((2, 64, 128), dtype=torch.bfloat16,
                          device='meta').transpose(1, 2)


def _f32_bq(args):
    args[4] = args[4].float()


def _grad_wk(args):
    args[2].requires_grad_()


@pytest.mark.parametrize('kw,heads,edit,error,match', [
    (dict(dtype=torch.float16), 2, None, ValueError, 'dtype'),
    (dict(H=8), 8, None, ValueError, 'head dim'),
    ({}, 2, _transposed_wq, ValueError, 'contiguous'),
    ({}, 2, _f32_bq, ValueError, 'dtype'),
    ({}, 4, None, ValueError, 'shape'),
    ({}, 2, None, ValueError, 'CPU or CUDA'),
    ({}, 2, _grad_wk, RuntimeError, 'no backward'),
], ids=['float16', 'head_dim_16', 'non_contiguous_weight', 'mixed_dtype',
        'wrong_num_heads', 'meta_device', 'requires_grad'])
def test_off_cpu_inputs_are_checked(kw, heads, edit, error, match):
    """Tensors off the CPU are checked before any launch: what the kernel
    does not take raises (f16, d = 16, a weight that is not head-major
    contiguous, mixed dtypes, weights of another head count, an input
    that needs grad), and so do devices other than CUDA."""
    args = _meta(**kw)
    if edit is not None:
        edit(args)
    with pytest.raises(error, match=match):
        fused_qkv_attention(*args, num_heads=heads)


def _attention_pair(D=128, H=4):
    """The JAX DiT ``Attention`` with every weight perturbed, and the port's
    ``Attention(D, H)`` loaded with its weights through the bridge."""
    jm = jdit.Attention(num_heads=H)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, D)))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.PRNGKey(9),
                                               p.shape), v['params'])
    v = {'params': params}
    tm = tdit.Attention(D, H)
    tm.load_state_dict(bridge.dit_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, v, tm


def test_dit_attention_tie_f32():
    """A DiT self-attention, f32: the port's kernel function on the split
    ``qkv`` weights of ``Attention(128, 4)`` (``weight.T`` of the
    ``nn.Linear``), then its ``proj``, equals the JAX module's output and
    JAX's ``fused_qkv_attention`` in interpret mode followed by the same
    ``proj`` (1e-5: f32 sums in another order; measured below 1e-6).  The
    port module's own forward agrees too."""
    B, L, D, H = 2, 48, 128, 4
    jm, v, tm = _attention_pair(D, H)
    x = np.random.default_rng(11).standard_normal((B, L, D)).astype(
        np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    p = v['params']
    (wq, wk, wv), (bq, bk, bv) = jfa.split_qkv_weights(
        p['qkv']['kernel'], p['qkv']['bias'], H)
    heads = jfa.fused_qkv_attention(jnp.asarray(x), wq, wk, wv, bq, bk, bv,
                                    num_heads=H, interpret=True)
    pallas = np.asarray(heads @ p['proj']['kernel'] + p['proj']['bias'])
    with torch.no_grad():
        ws, bs = split_qkv_weights(tm.qkv.weight.T, tm.qkv.bias, H)
        tx = torch.from_numpy(x)
        got = tm.proj(fused_qkv_attention(tx, *ws, *bs, num_heads=H))
        module = tm(tx)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(module.numpy(), want, rtol=1e-5, atol=1e-5)


def test_dit_attention_tie_module_qkv():
    """Kernel 4's plain version equals ``attention_reference`` on the port
    module's own q, k and v (from ``Attention.qkv``, f32), to f32 sum
    order."""
    B, L, D, H = 2, 33, 128, 4
    _, _, tm = _attention_pair(D, H)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (B, L, D)).astype(np.float32))
    with torch.no_grad():
        ws, bs = split_qkv_weights(tm.qkv.weight.T, tm.qkv.bias, H)
        got = fused_qkv_attention(x, *ws, *bs, num_heads=H)
        q, k, v = (t.reshape(B, L, H, D // H)
                   for t in tm.qkv(x).chunk(3, dim=-1))
        want = attention_reference(q, k, v).reshape(B, L, D)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# the chain's tolerance: |Δ| <= atol·max|pallas| + rtol·|pallas| after 4
# steps.  f32: summation order only (measured 2.8e-9 at an output scale of
# 0.027).  bf16: each step may put an element one bf16 ulp away (2^-8
# relative at most) on either side, and the average carries half of each
# older difference into the next step (measured 3.8e-6 at a scale of
# 0.027, 10 of 16,384 elements differ).
CHAIN_TOL = {'float32': (1e-5, 1e-5), 'bfloat16': (1e-2, 2e-2)}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_megakernel_chain_matches_jax(dtype):
    """Four steps of ``.bench_megakernel.py``'s mega chain at (2, 64, 128,
    4): x ← (0.5·fused_qkv_attention(x) + 0.5·x) in the input dtype, with
    wqkv = 0.02·N(0, 1), a zero bias and x₀ = 0.1·N(0, 1); JAX's Pallas
    kernel in interpret mode against the port on the CPU."""
    B, L, D, H = 2, 64, 128, 4
    x0, w, _ = _inputs(B, L, D, seed=21, x_scale=0.1, w_scale=0.02)
    b = np.zeros((3 * D,), np.float32)
    jd = JDT[dtype]
    (wq, wk, wv), (bq, bk, bv) = jfa.split_qkv_weights(
        jnp.asarray(w, jd), jnp.asarray(b, jd), H)
    jx = jnp.asarray(x0, jd)
    args = _torch_args(x0, w, b, H, dtype)
    tx, tw = args[0], args[1:]
    for _ in range(4):
        y = jfa.fused_qkv_attention(jx, wq, wk, wv, bq, bk, bv, num_heads=H,
                                    interpret=True)
        jx = (0.5 * y + 0.5 * jx).astype(jd)
        tx = (0.5 * fused_qkv_attention(tx, *tw, num_heads=H)
              + 0.5 * tx).to(TDT[dtype])
    want = np.asarray(jx.astype(jnp.float32))
    got = tx.float().numpy()
    assert np.isfinite(got).all()
    atol, rtol = CHAIN_TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * np.abs(want).max())
