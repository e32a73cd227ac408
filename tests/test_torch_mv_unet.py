"""The port's LGM multi-view U-Net family against the JAX package:
``MVAttention`` (joint attention over the views' tokens, its qkv and proj
``DenseGeneral`` kernels reshaped by the bridge), ``ResnetBlock`` (plain,
nearest 2x up and 2x2 mean down, with the 1x1 shortcut), the asymmetric
``MVUNet`` of ``tests/test_mv_unet.py``, ``LGMMVEncoder`` and the
``'lgm'`` encoder of ``TriplaneVAE.encode`` (``small_vae_cfg`` of
``tests/test_models.py``).  JAX's weights, every leaf perturbed off its
init (the GroupNorm scales included), are carried by ``bridge.py``;
inputs channels-last from a numpy seed; f32 on both sides; tolerance 1e-5
of each output's scale.  The query-chunked attention equals the
unchunked one within 1e-6 of scale."""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from ln3diff_tpu.models import mv_unet as jmv
from ln3diff_tpu.models import vae as jvae
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import mv_unet as tmv
from ln3diff_tpu_torch.models.dit import DiT2Config
from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
from tests.test_models import small_vae_cfg

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach(), np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(jmodule, tmodule, x, seed, nchw=False):
    """JAX's jitted init (perturbed) and apply on ``x`` (channels-last),
    and the port module with the same weights on the same input."""
    v = jax.jit(jmodule.init)(jax.random.PRNGKey(seed), x)
    rng = np.random.default_rng(seed + 1)
    v = {'params': jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape))
        .astype(np.float32), v['params'])}
    tmodule.load_state_dict(bridge.unet_state_dict(v))
    want = jax.jit(jmodule.apply)(v, x)
    t = torch.from_numpy(x)
    with torch.no_grad():
        if nchw:
            got = tmodule.eval()(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            got = tmodule.eval()(t)
    return got, want


def test_mv_attention_matches_jax():
    """Two instances of two views of 8²; 4 heads of 16."""
    x = _rand((4, 8, 8, 64), 0)
    got, want = _pair(jmv.MVAttention(64, num_heads=4, num_frames=2,
                                      skip_scale=0.7),
                      tmv.MVAttention(64, num_heads=4, num_frames=2,
                                      skip_scale=0.7), x, 1, nchw=True)
    _close(got, want)


def test_mv_attention_chunked_equals_unchunked():
    """Query chunks of 24 (the last one short) against one chunk."""
    torch.manual_seed(0)
    m = tmv.MVAttention(32, num_heads=16, num_frames=2).eval()
    x = torch.from_numpy(_rand((2, 32, 8, 8), 2))
    with torch.no_grad():
        m.query_chunk = 10**9
        whole = m(x)
        m.query_chunk = 24
        chunked = m(x)
    _close(chunked, whole.numpy(), rel=1e-6)


@pytest.mark.parametrize('resample', ['default', 'up', 'down'])
def test_resnet_block_matches_jax(resample):
    """32 → 64 channels (the 1x1 shortcut) with each resample."""
    x = _rand((2, 8, 8, 32), 3)
    got, want = _pair(jmv.ResnetBlock(64, resample=resample,
                                      skip_scale=0.7),
                      tmv.ResnetBlock(32, 64, resample=resample,
                                      skip_scale=0.7), x, 4, nchw=True)
    _close(got, want)


def _unet_cfg(cls):
    return cls(in_channels=9, out_channels=14, down_channels=(32, 64, 128),
               down_attention=(False, False, True), up_channels=(128, 64),
               up_attention=(True, False), layers_per_block=1, num_frames=2)


def test_mv_unet_asymmetric_matches_jax():
    """Three down levels, two up: the output at half the input's size."""
    x = _rand((4, 16, 16, 9), 5)
    got, want = _pair(jmv.MVUNet(_unet_cfg(jmv.MVUNetConfig)),
                      tmv.MVUNet(_unet_cfg(tmv.MVUNetConfig)), x, 6)
    assert tuple(got.shape) == (4, 8, 8, 14)
    _close(got, want)


def test_lgm_encoder_matches_jax():
    """Four views fused into 2·12 moment channels at a quarter of the
    input's size."""
    kw = dict(in_channels=10, down_channels=(32, 64, 128),
              down_attention=(False, False, True), num_frames=4)
    x = _rand((4, 16, 16, 10), 7)
    got, want = _pair(jmv.LGMMVEncoder(jmv.MVUNetConfig(**kw),
                                       z_channels=12),
                      tmv.LGMMVEncoder(tmv.MVUNetConfig(**kw),
                                       z_channels=12), x, 8)
    assert tuple(got.shape) == (1, 4, 4, 24)
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _lgm_vae():
    lgm = dict(encoder_type='lgm', lgm_down_channels=(32, 64),
               lgm_down_attention=(False, True))
    jm = jvae.TriplaneVAE(small_vae_cfg(**lgm))
    tcfg = TriplaneVAEConfig(
        encoder_in_channels=10, encoder_ch=8, encoder_ch_mult=(1, 2),
        encoder_res_blocks=1, img_resolution=32, num_views=2,
        ldm_z_channels=4, latent_size=16,
        dit2=DiT2Config(tokens_per_plane=64, hidden_size=32, depth=2,
                        num_heads=2, dtype=torch.float32),
        patch_size=2, conv_sr_ch=8, conv_sr_ch_mult=(1, 2),
        conv_sr_res_blocks=1, plane_channels=8, decoder_output_dim=8,
        dtype=torch.float32, **lgm)
    return jm, TriplaneVAE(tcfg, encoder=True)


def test_triplane_vae_lgm_encode_matches_jax():
    """``TriplaneVAE(encoder_type='lgm').encode``: two instances of two
    views of 32² × 10 → moments (2, 16, 16, 8, 3); the encoder and
    ``quant_conv`` through ``bridge.vae_state_dict``."""
    jm, tm = _lgm_vae()
    x = _rand((4, 32, 32, 10), 9) * 0.5
    v = jax.jit(lambda k, x: jm.init(k, x, method=jm.encode))(
        jax.random.PRNGKey(10), x)
    rng = np.random.default_rng(11)
    v = {'params': jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape))
        .astype(np.float32), v['params'])}
    sd = bridge.vae_state_dict(v)
    enc_keys = {k for k in tm.state_dict()
                if k.startswith(('encoder.', 'quant_conv.'))}
    assert set(sd) == enc_keys
    tm.load_state_dict(sd, strict=False)
    want = jax.jit(lambda v, x: jm.apply(v, x, method=jm.encode))(v, x)
    with torch.no_grad():
        got = tm.eval().encode(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 16, 16, 8, 3)
    _close(got, want)
