"""The fused attention of the port against the JAX package on the CPU.

``ln3diff_tpu_torch.ops.fused_attention.attention_reference`` (the plain
version of the CUDA kernel, which is what ``fused_attention`` runs on CPU
tensors) is held to the Pallas kernel ``ln3diff_tpu.ops.fused_attention
.fused_attention`` run in interpret mode, on the same numpy inputs; the
port's DiT with ``fused_attention=True`` is held to the JAX DiT with the
same switch (which runs XLA's attention off the TPU) under the same bridged
weights.  The kernel itself is checked on the card in
``tests/test_torch_gpu.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.ops.fused_attention import fused_attention as pallas_attn
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models.layers import dot_product_attention
from ln3diff_tpu_torch.ops.fused_attention import (FusedAttention,
                                                   attention_reference,
                                                   fused_attention, sdpa_auto)

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _pallas(q, k, v, dtype=jnp.float32):
    return np.asarray(pallas_attn(*(jnp.asarray(t, dtype) for t in (q, k, v)),
                                  interpret=True).astype(jnp.float32))


def _plain(q, k, v, dtype=torch.float32):
    out = attention_reference(*(torch.from_numpy(t).to(dtype)
                                for t in (q, k, v)))
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize('shape', [(2, 128, 4, 64), (1, 96, 2, 32),
                                   (2, 77, 2, 64)])
def test_plain_matches_pallas_f32(shape):
    """f32 at the JAX package's own test shapes and a ragged L: the two
    differ only in f32 summation order (tolerance of
    tests/test_fused_attention.py, 2e-5)."""
    q, k, v = _qkv(shape, seed=sum(shape))
    np.testing.assert_allclose(_plain(q, k, v), _pallas(q, k, v),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('shape', [(2, 64, 2, 64), (1, 100, 2, 32)])
def test_plain_matches_pallas_bf16(shape):
    """bf16 operands: both round p and o to bf16 from f32 values computed
    in another summation order, so an element may differ by one bf16 ulp
    (2^-7 relative) and a p one ulp away moves o by about 2^-8·p·|v|:
    |Δ| <= 4e-3 + 1e-2·|pallas|."""
    q, k, v = _qkv(shape, seed=7)
    got = _plain(q, k, v, torch.bfloat16)
    want = _pallas(q, k, v, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=4e-3)


def test_cpu_tensors_run_the_plain_version():
    """``fused_attention`` on CPU tensors is the plain version, bit for bit,
    and counts no launch; strided views (the thirds of one qkv
    projection) are taken as they are."""
    B, L, H, d = 2, 40, 2, 32
    qkv = torch.from_numpy(
        np.random.default_rng(3).standard_normal((B, L, 3 * H * d))
        .astype(np.float32))
    q, k, v = (t.reshape(B, L, H, d) for t in qkv.chunk(3, dim=-1))
    before = FusedAttention.launches
    got = fused_attention(q, k, v)
    assert FusedAttention.launches == before
    torch.testing.assert_close(
        got, attention_reference(q.contiguous(), k.contiguous(),
                                 v.contiguous()), atol=0, rtol=0)


def test_other_devices_raise():
    """Tensors that lie neither on the CPU nor on a card get an error, not
    the plain version."""
    q = torch.empty((1, 8, 2, 64), device='meta')
    with pytest.raises(ValueError, match='CPU or CUDA'):
        fused_attention(q, q, q)


def test_sdpa_auto_dispatch():
    """``use_fused=False`` is the plain attention of
    ``jax.nn.dot_product_attention``; ``use_fused=True`` the fused path."""
    q, k, v = _qkv((1, 32, 2, 16), seed=5)
    want = np.asarray(jax.nn.dot_product_attention(
        *(jnp.asarray(t) for t in (q, k, v))))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    np.testing.assert_allclose(sdpa_auto(tq, tk, tv).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sdpa_auto(tq, tk, tv, use_fused=True),
                               attention_reference(tq, tk, tv), atol=0,
                               rtol=0)
    torch.testing.assert_close(sdpa_auto(tq, tk, tv),
                               dot_product_attention(tq, tk, tv), atol=0,
                               rtol=0)


def _dit(fused, depth=2, hidden=64, heads=2):
    kw = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=hidden,
              depth=depth, num_heads=heads, context_dim=16,
              exact_gelu=False, fused_attention=fused)
    jm = jdit.DiT_TriLatent(jdit.DiTConfig(variant='text', dtype=jnp.float32,
                                           **kw))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, 8, 12)),
                jnp.zeros((2,)), {'crossattn': jnp.zeros((2, 7, 16))})
    # flax zero-inits adaLN and the final layer; perturb every leaf
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.PRNGKey(9),
                                               p.shape), v['params'])
    v = {'params': params, 'constants': v['constants']}
    tm = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32, **kw))
    tm.load_state_dict(bridge.dit_state_dict(
        jax.tree_util.tree_map(np.asarray, v)))
    return jm, v, tm


@pytest.mark.parametrize('hidden,heads', [(64, 2), (64, 1)])
def test_dit_fused_attention_matches_jax(hidden, heads):
    """DiT_TriLatent with ``fused_attention=True`` (self-attention through
    ``sdpa_auto``; head dims 32 and 64), JAX vs port under the same bridged
    weights, f32: 1e-4 as the other whole-network DiT tests.  The switch
    adds no parameter: the bridge loads the JAX weights strictly."""
    jm, v, tm = _dit(True, hidden=hidden, heads=heads)
    assert all(b.attn.fused for b in tm.blocks)
    assert not any(getattr(b.cross_attn, 'fused', False) for b in tm.blocks)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    t = np.array([3, 970], np.int32)
    ctx = rng.standard_normal((2, 7, 16)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(t),
                    {'crossattn': jnp.asarray(ctx)})
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 {'crossattn': torch.from_numpy(ctx)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # the same weights in the flag-off model give the same output
    tm_off = tdit.DiT_TriLatent(dataclasses.replace(tm.cfg,
                                                    fused_attention=False))
    tm_off.load_state_dict(tm.state_dict())
    with torch.no_grad():
        off = tm_off(torch.from_numpy(x), torch.from_numpy(t),
                     {'crossattn': torch.from_numpy(ctx)})
    np.testing.assert_allclose(got.numpy(), off.numpy(), atol=1e-5,
                               rtol=1e-5)
