"""The PixArt variants of ``DiT_TriLatent`` against the JAX package:
``'pixelart-text'``, ``'image-pixelart'`` (image→3D), ``'image-pixelart-
noclip'`` and ``'mv-pixelart'`` (multi-view→3D), each through the plain
self-attention and with ``fused_attention=True`` (the kernel's plain
version on the CPU), weights carried by ``bridge.dit_state_dict``.

Toy sizes (hidden 64, two heads of 32, depth 2, 8² latents), f32 on both
sides, flow-matching times in [0, 1).  Tolerance 1e-5 of the output's
scale."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu import config as jconfig
from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch import config as tconfig
from ln3diff_tpu_torch.models import dit as tdit

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-5
B = 2
CTX, VEC, DINO = 24, 16, 20

VARIANTS = {
    # text tokens through attention_y_norm, pooled vector, T2I final layer
    'pixelart-text': dict(cfg=dict(context_dim=CTX, pooled_vector_dim=VEC,
                                   t2i_final=True),
                          ctx=dict(crossattn=(B, 7, CTX), vector=(B, VEC))),
    # the image→3D layout: CLIP tokens, pooled vector, DINO in self-attn
    'image-pixelart': dict(cfg=dict(context_dim=CTX, pooled_vector_dim=VEC,
                                    dino_dim=DINO, t2i_final=True),
                           ctx=dict(crossattn=(B, 5, CTX), vector=(B, VEC),
                                    dino=(B, 9, DINO))),
    # no cross-attention; adaLN final layer
    'image-pixelart-noclip': dict(cfg=dict(dino_dim=DINO),
                                  ctx=dict(dino=(B, 9, DINO))),
    # the multi-view→3D layout: (B, V, L, C) views flattened into the
    # cross-attention
    'mv-pixelart': dict(cfg=dict(context_dim=CTX),
                        ctx=dict(concat=(B, 3, 5, CTX))),
}


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


def _kw(variant, fused):
    return dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
                depth=2, num_heads=2, exact_gelu=False,
                fused_attention=fused, variant=variant,
                **VARIANTS[variant]['cfg'])


def _context(variant, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k, shape in VARIANTS[variant]['ctx'].items()}


@functools.lru_cache(maxsize=None)
def _models(variant):
    """The JAX model's init with every leaf moved off its (partly zero)
    init, and the port's model loaded with it."""
    jm = jdit.DiT_TriLatent(jdit.DiTConfig(dtype=jnp.float32,
                                           **_kw(variant, False)))
    ctx = {k: jnp.asarray(v) for k, v in _context(variant, 0).items()}
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((B, 8, 8, 12)),
                         jnp.zeros((B,)), ctx)
    rng = np.random.default_rng(10)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(p.shape))
        .astype(np.float32), v['params'])
    v = {'params': params, 'constants': v['constants']}
    sd = bridge.dit_state_dict(jax.tree_util.tree_map(np.asarray, v))
    return jm, v, sd


@pytest.mark.parametrize('fused', [False, True], ids=['plain', 'fused'])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_pixart_dit_matches_jax(variant, fused):
    jm, v, sd = _models(variant)
    tm = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32,
                                           **_kw(variant, fused))).eval()
    # strict: every JAX parameter has its place and nothing is left over
    tm.load_state_dict(sd)
    assert all(b.attn.fused == fused for b in tm.blocks)
    x = np.random.default_rng(1).standard_normal(
        (B, 8, 8, 12)).astype(np.float32)
    t = np.array([0.1, 0.73], np.float32)
    ctx = _context(variant, 2)
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(t),
                             {k: jnp.asarray(c) for k, c in ctx.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 {k: torch.from_numpy(c) for k, c in ctx.items()})
    assert got.shape == (B, 8, 8, 12) and got.dtype == torch.float32
    _close(got, want)


def test_block_layout():
    """Which norms, tables and attention pieces each variant builds."""
    _, _, sd = _models('image-pixelart')
    for key in ('blocks.0.scale_shift_table', 'blocks.0.attn.q_norm.weight',
                'blocks.0.attn.k_norm.weight', 'cap_norm.weight',
                'cap_norm.bias', 'cap_proj.weight', 'dino_proj.fc1.weight',
                'adaLN_modulation.weight', 'final_layer.scale_shift_table'):
        assert key in sd, key
    assert 'blocks.0.adaLN_modulation.weight' not in sd
    assert 'blocks.0.norm1.weight' not in sd     # parameter-free LayerNorm
    assert 'blocks.0.cross_attn.to_q.weight' in sd
    _, _, sd = _models('image-pixelart-noclip')
    assert not any('cross_attn' in k for k in sd)
    assert 'final_layer.adaLN_modulation.weight' in sd
    _, _, sd = _models('mv-pixelart')
    assert 'blocks.0.norm1.weight' in sd         # RMSNorm
    assert 'blocks.0.attn.q_norm.weight' in sd
    assert 'blocks.0.cross_attn.to_k.weight' in sd
    # the fixed 64-wide heads of the cross-attention
    assert sd['blocks.0.cross_attn.to_k.weight'].shape == (2 * 64, CTX)
    _, _, sd = _models('pixelart-text')
    assert 'blocks.0.attention_y_norm.weight' in sd
    assert 'blocks.0.attn.q_norm.weight' not in sd


def test_cap_norm_eps_is_flax():
    """``cap_norm`` is flax's LayerNorm: eps 1e-6, where torch's default
    is 1e-5."""
    tm = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32,
                                           **_kw('image-pixelart', False)))
    assert tm.cap_norm.eps == 1e-6


@pytest.mark.parametrize('name', ['i23d-pixart-l2', 'mv23d-dit-l2',
                                  't23d-dit-l2'])
def test_denoiser_presets_match_jax(name):
    j = jconfig.denoiser_preset(name)
    t = tconfig.denoiser_preset(name)
    for f in dataclasses.fields(t):
        if f.name != 'dtype':
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.bfloat16
