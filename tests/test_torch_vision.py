"""The image towers of the image→3D and multi-view→3D paths against the
JAX package: ``CLIPVisionModel`` (tokens, pooled feature, every layer's
tokens) and ``VisionTransformer`` (DINOv2 layout with layerscale and
erf-GELU, and a plain ViT with tanh-GELU and no class token), weights
carried by ``bridge.clip_vision_state_dict`` / ``bridge.vit_state_dict``.
Toy sizes, f32 on both sides; tolerance 1e-5 of each output's scale."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.conditioning import clip as jclip
from ln3diff_tpu.models import vit as jvit
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.conditioning import clip as tclip
from ln3diff_tpu_torch.models import vit as tvit

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach(), np.float64), want,
                               atol=rel * scale, rtol=0)


def _perturbed(params, seed):
    """Every leaf moved off its init (layerscale 1e-5, zero class token,
    unit norms), so that each parameter shows in the output."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape))
        .astype(np.float32), params)


def _images(B, hw, C=3, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, hw, hw, C)).astype(np.float32)


CLIP_KW = dict(image_size=28, patch_size=7, hidden_size=32, num_layers=3,
               num_heads=2, intermediate_size=64)


@functools.lru_cache(maxsize=None)
def _clip():
    jm = jclip.CLIPVisionModel(jclip.CLIPVisionConfig(**CLIP_KW))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)))
    v = {'params': _perturbed(v['params'], 1)}
    tm = tclip.CLIPVisionModel(tclip.CLIPVisionConfig(**CLIP_KW))
    tm.load_state_dict(bridge.clip_vision_state_dict(
        jax.tree_util.tree_map(np.asarray, v)))
    return jm, v, tm.eval()


def test_clip_vision_matches_jax():
    jm, v, tm = _clip()
    img = _images(2, 28)
    want = jax.jit(jm.apply, static_argnames='output_hidden_states')(
        v, jnp.asarray(img), output_hidden_states=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(img), output_hidden_states=True)
        plain = tm(torch.from_numpy(img))
    assert got['tokens'].shape == (2, 17, 32)
    assert got['pooler_output'].shape == (2, 32)
    _close(got['tokens'], want['tokens'])
    _close(got['pooler_output'], want['pooler_output'])
    assert len(got['hidden_states']) == 3
    for g, w in zip(got['hidden_states'], want['hidden_states']):
        _close(g, w)
    assert torch.equal(got['hidden_states'][-1], got['tokens'])
    assert set(plain) == {'tokens', 'pooler_output'}
    assert torch.equal(plain['tokens'], got['tokens'])


VIT_CASES = {
    # DINOv2 layout: class token, layerscale gains, erf-GELU
    'dinov2': dict(img_size=28, patch_size=14, embed_dim=48, depth=2,
                   num_heads=2, layerscale=True, exact_gelu=True),
    # plain ViT: tanh-GELU, no gains, no class token
    'plain': dict(img_size=32, patch_size=8, embed_dim=32, depth=2,
                  num_heads=4, use_cls_token=False),
}


@functools.lru_cache(maxsize=None)
def _vit(case):
    kw = VIT_CASES[case]
    jm = jvit.VisionTransformer(jvit.ViTConfig(dtype=jnp.float32, **kw))
    hw = kw['img_size']
    v = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.zeros((1, hw, hw, 3)))
    v = {'params': _perturbed(v['params'], 3)}
    tm = tvit.VisionTransformer(tvit.ViTConfig(dtype=torch.float32, **kw))
    tm.load_state_dict(bridge.vit_state_dict(
        jax.tree_util.tree_map(np.asarray, v)))
    return jm, v, tm.eval()


@pytest.mark.parametrize('case', sorted(VIT_CASES))
def test_vit_matches_jax(case):
    jm, v, tm = _vit(case)
    kw = VIT_CASES[case]
    img = _images(3, kw['img_size'], seed=4)
    want = jax.jit(jm.apply)(v, jnp.asarray(img))
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    n = (kw['img_size'] // kw['patch_size'])**2 + kw.get('use_cls_token', 1)
    assert got.shape == (3, n, kw['embed_dim'])
    _close(got, want)
    if kw.get('layerscale'):
        assert tm.blocks[0].gamma1.shape == (kw['embed_dim'],)


def test_vit_registry_matches_jax():
    """The DINOv2-B/14 tower of both serving paths, by name."""
    for name in ('dinov2-b/14', 'vit-s/16', 'dinov2-l/14'):
        j = jvit.vit_registry(name, img_size=224)
        t = tvit.vit_registry(name, img_size=224)
        for f in ('img_size', 'patch_size', 'embed_dim', 'depth',
                  'num_heads', 'mlp_ratio', 'use_cls_token', 'layerscale',
                  'exact_gelu'):
            assert getattr(j, f) == getattr(t, f), (name, f)
