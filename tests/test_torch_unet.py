"""The ShapeNet/FFHQ denoiser and its conditioning against the JAX
package: ``UNetModel`` with the triplane roll-out, ``SpatialTransformer``
cross-attention, the ``mixing_logit`` parameter and ``control`` residuals;
the ADM ``SelfAttention2D`` with the ``resblock_updown`` resampling and
plain (not scale-shift) norms; CLIP's ``text_projection`` (``text_embeds``)
and ``pooled_text_context``.  JAX's parameters (perturbed off their init)
are carried by ``bridge.py``; toy sizes, f32 on both sides; tolerance
1e-5 of each output's scale."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.conditioning import clip as jclip
from ln3diff_tpu.models import unet as junet
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.conditioning import clip as tclip
from ln3diff_tpu_torch.models import unet as tunet
from ln3diff_tpu_torch.models.layers import random_init_

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach(), np.float64), want,
                               atol=rel * scale, rtol=0)


def _perturbed(params, seed):
    """Every leaf moved off its init (zero-init output convs, unit norms,
    the mixing logit's -6), so that each parameter shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape))
        .astype(np.float32), params)


UNETS = {
    # roll-out, spatial transformer at ds 2, scale-shift norm, mixing logit
    'transformer': dict(in_channels=4, model_channels=16, out_channels=4,
                        num_res_blocks=1, attention_resolutions=(2,),
                        channel_mult=(1, 2), num_heads=2, context_dim=16,
                        use_spatial_transformer=True, roll_out=True,
                        mixed_prediction=True),
    # ADM self-attention, resblock resampling, additive emb, no roll-out
    'adm': dict(in_channels=4, model_channels=16, out_channels=8,
                num_res_blocks=2, attention_resolutions=(1, 4),
                channel_mult=(1, 2, 3), num_head_channels=8,
                use_spatial_transformer=False, use_scale_shift_norm=False,
                resblock_updown=True, roll_out=False,
                mixed_prediction=False),
}


@functools.lru_cache(maxsize=None)
def _unet(name):
    kw = UNETS[name]
    jm = junet.UNetModel(junet.UNetConfig(dtype=jnp.float32, **kw))
    c = kw['in_channels'] * (3 if kw['roll_out'] else 1)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, c)),
                         jnp.zeros((1,)), jnp.zeros((1, 1, 16)))
    v = {'params': _perturbed(v['params'], 1)}
    tm = tunet.UNetModel(tunet.UNetConfig(dtype=torch.float32, **kw))
    tm.load_state_dict(bridge.unet_state_dict(
        jax.tree_util.tree_map(np.asarray, v)))
    return jm, v, tm.eval(), c


def _inputs(c, B=2, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 8, 8, c)).astype(np.float32)
    t = np.array([3.0, 731.0][:B], np.float32)
    ctx = rng.standard_normal((B, 1, 16)).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize('name', sorted(UNETS))
def test_unet_matches_jax(name):
    jm, v, tm, c = _unet(name)
    x, t, ctx = _inputs(c)
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(ctx))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 {'crossattn': torch.from_numpy(ctx)})
    out_c = UNETS[name]['out_channels'] * (3 if UNETS[name]['roll_out']
                                           else 1)
    assert got.shape == (2, 8, 8, out_c) and got.dtype == torch.float32
    _close(got, want)


def test_unet_control_residuals_match_jax():
    """ControlNet residuals on the skips and the middle output."""
    jm, v, tm, c = _unet('transformer')
    x, t, ctx = _inputs(c, seed=3)
    rng = np.random.default_rng(4)
    # skips: conv_in, the level-0 block, its downsample, the level-1 block;
    # then the middle (roll-out: 8 × 24, then 4 × 12)
    shapes = [(2, 16, 8, 24), (2, 16, 8, 24), (2, 16, 4, 12),
              (2, 32, 4, 12), (2, 32, 4, 12)]
    control = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(ctx),
                             [jnp.asarray(a.transpose(0, 2, 3, 1))
                              for a in control])
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(ctx), [torch.from_numpy(a)
                                         for a in control])
        plain = tm(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx))
    _close(got, want)
    assert (got - plain).abs().max() > 1e-3
    with pytest.raises(ValueError, match='control'):
        tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
           [torch.from_numpy(a) for a in control[:-1]])


def test_unet_free_parameters():
    """The mixing logit has JAX's shape (1, 1, 1, 3·in_channels); the
    random init sets it to its JAX init, -6, in the quantized U-Net
    too."""
    _, v, tm, _ = _unet('transformer')
    assert tm.mixing_logit.shape == v['params']['mixing_logit'].shape \
        == (1, 1, 1, 12)
    fresh = random_init_(tunet.UNetModel(tunet.UNetConfig(
        dtype=torch.float32, **UNETS['transformer'])),
        torch.Generator().manual_seed(0))
    assert torch.equal(fresh.mixing_logit, torch.full((1, 1, 1, 12), -6.0))
    assert not hasattr(tunet.UNetModel(tunet.UNetConfig(
        **UNETS['adm'])), 'mixing_logit')
    q = random_init_(tunet.UNetModel(tunet.UNetConfig(
        dtype=torch.float32, quantized=True, **UNETS['transformer'])),
        torch.Generator().manual_seed(0))
    assert torch.equal(q.mixing_logit, torch.full((1, 1, 1, 12), -6.0))
    assert q.down_0_res_0.in_conv.kernel_q.dtype == torch.int8


def test_unet_runs_channels_last():
    """The conv weights are NHWC in memory, and stay so through the random
    init, a bridge load and the cast to bf16; the activations that the
    convs return are channels-last too."""
    _, _, tm, c = _unet('adm')
    fresh = random_init_(tunet.UNetModel(tunet.UNetConfig(
        dtype=torch.float32, **UNETS['adm'])),
        torch.Generator().manual_seed(0))
    fresh.load_state_dict(tm.state_dict())
    fresh = fresh.to(torch.bfloat16)
    convs = [m for m in fresh.modules() if isinstance(m, torch.nn.Conv2d)]
    assert convs and all(
        m.weight.is_contiguous(memory_format=torch.channels_last)
        for m in convs)
    layouts = []
    hooks = [m.register_forward_hook(lambda m, i, o: layouts.append(
        o.is_contiguous(memory_format=torch.channels_last)))
        for m in convs]
    x, t, ctx = _inputs(c)
    with torch.no_grad():
        out = fresh(torch.from_numpy(x), torch.from_numpy(t))
    for h in hooks:
        h.remove()
    assert len(layouts) == len(convs) and all(layouts)
    assert out.shape == x.shape[:3] + (8,) and out.dtype == torch.float32


def test_spatial_transformer_and_self_attention_match_jax():
    """The two attention blocks alone, NHWC in JAX, NCHW in the port."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 3, 8)).astype(np.float32)
    for jm, tm, args in (
            (junet.SpatialTransformer(2, 8, depth=2),
             tunet.SpatialTransformer(16, 2, 8, depth=2), (x, ctx)),
            (junet.SelfAttention2D(8), tunet.SelfAttention2D(16, 8), (x,))):
        v = jax.jit(jm.init)(jax.random.PRNGKey(6), *map(jnp.asarray, args))
        v = {'params': _perturbed(v['params'], 7)}
        tm.load_state_dict(bridge.unet_state_dict(v))
        want = jax.jit(jm.apply)(v, *map(jnp.asarray, args))
        targs = [torch.from_numpy(x.transpose(0, 3, 1, 2).copy())] + [
            torch.from_numpy(a) for a in args[1:]]
        with torch.no_grad():
            got = tm(*targs)
        _close(got.permute(0, 2, 3, 1), want)


TEXT_KW = dict(hidden_size=32, num_layers=2, num_heads=2,
               intermediate_size=64, with_projection=True)


def test_clip_text_embeds_and_pooled_context_match_jax():
    jm = jclip.CLIPTextModel(jclip.CLIPTextConfig(**TEXT_KW))
    ids = np.zeros((2, 77), np.int32)
    ids[0, :5] = [49406, 320, 1125, 539, 49407]
    ids[1, :2] = [49406, 49407]
    v = jax.jit(jm.init)(jax.random.PRNGKey(8), jnp.asarray(ids))
    v = {'params': _perturbed(v['params'], 9)}
    tm = tclip.CLIPTextModel(tclip.CLIPTextConfig(**TEXT_KW))
    tm.load_state_dict(bridge.clip_text_state_dict(v))
    want = jax.jit(jm.apply)(v, jnp.asarray(ids))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(ids))
    assert set(got) == {'last_hidden_state', 'pooler_output', 'text_embeds'}
    _close(got['text_embeds'], want['text_embeds'])
    for kw in (dict(scale_clip_encoding=18.4), dict(n_repeat=3),
               dict(normalize=False)):
        _close(tclip.pooled_text_context(got['text_embeds'], **kw),
               jclip.pooled_text_context(want['text_embeds'], **kw))
    assert tclip.pooled_text_context(got['text_embeds']).shape == (2, 1, 32)
    with pytest.raises(ValueError, match='normalize'):
        tclip.pooled_text_context(got['text_embeds'], normalize=False,
                                  scale_clip_encoding=18.4)
    plain = tclip.CLIPTextModel(tclip.CLIPTextConfig(
        **dict(TEXT_KW, with_projection=False)))
    assert not hasattr(plain, 'text_projection')
