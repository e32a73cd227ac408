"""The fg/bg FFHQ VAE of the port and the remaining SR and decoder
variants against the JAX package, f32 on the CPU.

* ``render/background.py``: ``depth2pts_outside``, ``render_background``
  and ``render_rays_fg_bg`` (midpoint sampling, JAX's ``key=None``);
* ``models/stylegan.py``: ``SynthesisLayerLite`` (plain and 2x up),
  ``ToRGB``, ``SuperresolutionHybrid``, ``upfirdn2d(down=)``,
  ``downsample2d``, ``filtered_lrelu`` and ``PixelUnshuffleUpsample``;
  ``ops/bias_act.py`` for every activation; ``models/sr.py``
  ``NearestConvSRResidual``; ``models/vit.py`` ``TriplaneFusionBlock``
  and ``TriplaneViTDecoder``: each within 1e-5 of scale (f32 sums in
  another order);
* the toy fg/bg VAE of ``tests/test_ffhq_vae.py`` (``'stylegan'`` SR head,
  background planes): decode and render within 1e-4 of scale (whole
  networks), ``query_points`` on the fg half, and the fused fg path
  (kernel 1's plain version on the CPU) equal to the plain one.

JAX's parameters are drawn with numpy in the shapes of ``jax.eval_shape``
of each init and carried by ``bridge.py``.
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models import osg_decoder as josg
from ln3diff_tpu.models import sr as jsr
from ln3diff_tpu.models import stylegan as jsg
from ln3diff_tpu.models import vit as jvit
from ln3diff_tpu.ops import bias_act as jbias
from ln3diff_tpu.render import background as jbg
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import osg_decoder as tosg
from ln3diff_tpu_torch.models import sr as tsr
from ln3diff_tpu_torch.models import stylegan as tsg
from ln3diff_tpu_torch.models import vit as tvit
from ln3diff_tpu_torch.ops import bias_act as tbias
from ln3diff_tpu_torch.render import background as tbg
from ln3diff_tpu_torch.render.renderer import (RenderOptions,
                                               pack_corner_table)
from test_torch_unet_families import _params

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load(module, params):
    module.load_state_dict(bridge.vae_state_dict(params))
    return module.eval()


def _rays(B=2, R=12, seed=0):
    """Rays from points on a sphere of radius 2.7 towards the origin."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((B, R, 3))
    o = 2.7 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + 0.3 * rng.standard_normal((B, R, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


# -- render/background.py ---------------------------------------------------

def test_depth2pts_outside_matches_jax():
    o, d = _rays()
    depth = np.random.default_rng(1).uniform(0, 1, o.shape[:2]) \
        .astype(np.float32)
    jpts, jreal = jbg.depth2pts_outside(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(depth))
    tpts, treal = tbg.depth2pts_outside(torch.from_numpy(o),
                                        torch.from_numpy(d),
                                        torch.from_numpy(depth))
    assert tpts.shape == (2, 12, 4)
    _close(tpts, jpts)
    _close(treal, jreal)


OPTS = dict(depth_resolution=4, depth_resolution_importance=4,
            ray_start=2.25, ray_end=3.3, box_warp=1.0, white_back=False)


@functools.lru_cache(maxsize=None)
def _decoders(C=4, out=8):
    """A JAX OSGDecoder pair (fg, bg) over C plane channels and the port's
    copies."""
    feats = jnp.zeros((1, 3, 5, C))
    pair = []
    for seed in (1, 2):
        jm = josg.OSGDecoder(decoder_output_dim=out)
        v = _params(jm.init, feats, None, seed=seed)
        tm = tosg.OSGDecoder(in_features=C, decoder_output_dim=out)
        pair.append((lambda f, d, jm=jm, v=v: jm.apply(v, f, d),
                     _load(tm, v)))
    return pair


def _planes(C=8, seed=3):
    return (np.random.default_rng(seed).standard_normal((2, 3, 8, 8, C))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize('white_back', [False, True])
def test_render_background_matches_jax(white_back):
    (_, _), (jbg_dec, tbg_dec) = _decoders()
    o, d = _rays(seed=4)
    planes = _planes(C=4)
    opts = dict(OPTS, white_back=white_back)
    want = jax.jit(lambda p, o, d: jbg.render_background(
        None, p, jbg_dec, o, d, JOpts(**opts), bg_depth_resolution=6))(
            jnp.asarray(planes), jnp.asarray(o), jnp.asarray(d))
    with torch.no_grad():
        got = tbg.render_background(torch.from_numpy(planes), tbg_dec,
                                    torch.from_numpy(o), torch.from_numpy(d),
                                    RenderOptions(**opts),
                                    bg_depth_resolution=6)
    for g, w in zip(got, want):
        _close(g, w)


def test_render_rays_fg_bg_matches_jax():
    (jfg, tfg), (jbg_dec, tbg_dec) = _decoders()
    o, d = _rays(seed=5)
    planes = _planes()
    want = jax.jit(lambda p, o, d: jbg.render_rays_fg_bg(
        None, p, jfg, jbg_dec, o, d, JOpts(**OPTS), bg_depth_resolution=4))(
            jnp.asarray(planes), jnp.asarray(o), jnp.asarray(d))
    with torch.no_grad():
        got = tbg.render_rays_fg_bg(torch.from_numpy(planes), tfg, tbg_dec,
                                    torch.from_numpy(o), torch.from_numpy(d),
                                    RenderOptions(**OPTS),
                                    bg_depth_resolution=4)
    assert got.feature_samples.shape == (2, 12, 8)
    for g, w in zip(got, want):
        _close(g, w)
    # the fg half is a channel slice; its gather table is a fresh
    # contiguous tensor, as kernel 1 takes it
    fg = torch.from_numpy(planes)[..., :4]
    assert not fg.is_contiguous()
    assert pack_corner_table(fg).is_contiguous()


def test_render_rays_fg_bg_with_jax_draws():
    """Jittered sampling: JAX splits the key into the fg and bg passes'
    keys, the fg key into the stratified and importance keys; the port
    takes those uniforms as ``draws`` and ``bg_u``."""
    from ln3diff_tpu_torch.render.renderer import RenderDraws
    (jfg, tfg), (jbg_dec, tbg_dec) = _decoders()
    o, d = _rays(seed=6)
    planes = _planes(seed=7)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda p, o, d, k: jbg.render_rays_fg_bg(
        k, p, jfg, jbg_dec, o, d, JOpts(**OPTS), bg_depth_resolution=4))(
            jnp.asarray(planes), jnp.asarray(o), jnp.asarray(d), key)
    k_fg, k_bg = jax.random.split(key)
    k_strat, k_imp = jax.random.split(k_fg)
    B, R = o.shape[:2]
    draws = RenderDraws(
        torch.from_numpy(np.array(jax.random.uniform(k_strat, (B, R, 4, 1)))),
        torch.from_numpy(np.array(jax.random.uniform(k_imp, (B * R, 4)))))
    bg_u = torch.from_numpy(np.array(jax.random.uniform(k_bg, (B, R, 4, 1))))
    with torch.no_grad():
        got = tbg.render_rays_fg_bg(torch.from_numpy(planes), tfg, tbg_dec,
                                    torch.from_numpy(o), torch.from_numpy(d),
                                    RenderOptions(**OPTS),
                                    bg_depth_resolution=4, draws=draws,
                                    bg_u=bg_u)
    for g, w in zip(got, want):
        _close(g, w)


# -- models/stylegan.py -----------------------------------------------------

def _img(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize('up', [1, 2])
def test_synthesis_layer_lite_matches_jax(up):
    x, w = _img((2, 6, 6, 8), 1), _img((2, 512), 2)
    jm = jsg.SynthesisLayerLite(12, up=up)
    v = _params(jm.init, jnp.asarray(x), jnp.asarray(w), seed=3)
    tm = _load(tsg.SynthesisLayerLite(8, 12, up=up), v)
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(w))
    got = tm(_nchw(x), torch.from_numpy(w))
    assert got.shape == (2, 12, 6 * up, 6 * up)
    _close(_nhwc(got), want)


def test_to_rgb_matches_jax():
    x, w = _img((2, 6, 6, 8), 4), _img((2, 512), 5)
    jm = jsg.ToRGB()
    v = _params(jm.init, jnp.asarray(x), jnp.asarray(w), seed=6)
    tm = _load(tsg.ToRGB(8), v)
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(w))
    _close(_nhwc(tm(_nchw(x), torch.from_numpy(w))), want)


@pytest.mark.parametrize('sr_ratio', [2, 4])
def test_superresolution_hybrid_matches_jax(sr_ratio):
    feat, rgb = _img((2, 8, 8, 16), 7), _img((2, 8, 8, 3), 8)
    w = _img((2, 512), 9) * 0.02
    jm = jsg.SuperresolutionHybrid(sr_ratio=sr_ratio, hidden=32)
    args = tuple(jnp.asarray(a) for a in (feat, rgb, w))
    v = _params(jm.init, *args, seed=10)
    tm = _load(tsg.SuperresolutionHybrid(16, sr_ratio=sr_ratio, hidden=32),
               v)
    want = jax.jit(jm.apply)(v, *args)
    got = tm(*(torch.from_numpy(a) for a in (feat, rgb, w)))
    assert got.shape == (2, 8 * sr_ratio, 8 * sr_ratio, 3)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize('down', [2, 4])
def test_upfirdn2d_down_and_downsample2d_match_jax(down):
    x = _img((2, 16, 12, 3), 11)
    jf = jsg.setup_filter()
    tf = tsg.setup_filter()
    want = jsg.upfirdn2d(jnp.asarray(x), jf, up=2, down=down,
                         padding=(1, 2, 2, 1), gain=1.5)
    got = tsg.upfirdn2d(_nchw(x), tf, up=2, down=down, padding=(1, 2, 2, 1),
                        gain=1.5)
    _close(_nhwc(got), want)
    want = jsg.downsample2d(jnp.asarray(x), jf, down=down)
    got = tsg.downsample2d(_nchw(x), tf, down=down)
    assert got.shape == (2, 3, 16 // down, 12 // down)
    _close(_nhwc(got), want)


@pytest.mark.parametrize('kw', [dict(), dict(up=4, down=2, clamp=0.5,
                                             slope=0.1, gain=1.0)],
                         ids=['default', 'up4_clamp'])
def test_filtered_lrelu_matches_jax(kw):
    x = _img((2, 8, 8, 5), 12)
    b = _img((5,), 13)
    want = jsg.filtered_lrelu(jnp.asarray(x), bias=jnp.asarray(b), **kw)
    got = tsg.filtered_lrelu(_nchw(x), bias=torch.from_numpy(b), **kw)
    _close(_nhwc(got), want)


@pytest.mark.parametrize('act', sorted(jbias._ACTS))
def test_bias_act_matches_jax(act):
    x = _img((2, 5, 7), 14) * 3
    b = _img((7,), 15)
    for kw in (dict(), dict(gain=0.7, clamp=1.5)):
        want = jbias.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, **kw)
        got = tbias.bias_act(torch.from_numpy(x), torch.from_numpy(b),
                             act=act, **kw)
        _close(got, want)
    want = jbias.bias_act(jnp.asarray(x), jnp.asarray(_img((5,), 16)),
                          act=act, axis=1)
    got = tbias.bias_act(torch.from_numpy(x),
                         torch.from_numpy(_img((5,), 16)), act=act, dim=1)
    _close(got, want)


@pytest.mark.parametrize('sr_ratio', [2, 4])
def test_pixel_unshuffle_upsample_matches_jax(sr_ratio):
    x = _img((2, 6, 6, 8), 17)
    jm = jsg.PixelUnshuffleUpsample(num_feat=16, sr_ratio=sr_ratio)
    v = _params(jm.init, jnp.asarray(x), seed=18)
    tm = _load(tsg.PixelUnshuffleUpsample(8, num_feat=16,
                                          sr_ratio=sr_ratio), v)
    for skip in (True, False):
        want = jm.apply(v, jnp.asarray(x), skip)
        got = tm(torch.from_numpy(x), skip)
        assert got.shape == (2, 6 * sr_ratio, 6 * sr_ratio, 3)
        _close(got, want)


@pytest.mark.parametrize('sr_ratio', [2, 4])
def test_nearest_conv_sr_residual_matches_jax(sr_ratio):
    x, base = _img((2, 6, 6, 8), 19), _img((2, 6, 6, 3), 20)
    jm = jsr.NearestConvSRResidual(num_feat=16, sr_ratio=sr_ratio)
    v = _params(jm.init, jnp.asarray(x), jnp.asarray(base), seed=21)
    tm = _load(tsr.NearestConvSRResidual(8, num_feat=16, sr_ratio=sr_ratio),
               v)
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(base))
    got = tm(torch.from_numpy(x), torch.from_numpy(base))
    assert got.shape == (2, 6 * sr_ratio, 6 * sr_ratio, 3)
    _close(got, want)


# -- models/vit.py ------------------------------------------------------------

def test_triplane_fusion_block_matches_jax():
    x = _img((2, 3, 10, 32), 22)
    jm = jvit.TriplaneFusionBlock(num_heads=4)
    v = _params(jm.init, jnp.asarray(x), seed=23)
    tm = _load(tvit.TriplaneFusionBlock(32, 4), v)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)), want)


@pytest.mark.parametrize('uvit_skips,depth', [(True, 4), (True, 3),
                                              (False, 2)])
def test_triplane_vit_decoder_matches_jax(uvit_skips, depth):
    x = _img((2, 3, 16, 32), 24)
    kw = dict(tokens_per_plane=16, embed_dim=32, depth=depth, num_heads=4,
              uvit_skips=uvit_skips)
    jm = jvit.TriplaneViTDecoder(jvit.TriplaneViTDecoderConfig(**kw))
    v = _params(jm.init, jnp.asarray(x), seed=25)
    tm = _load(tvit.TriplaneViTDecoder(tvit.TriplaneViTDecoderConfig(**kw)),
               v)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)), want)
    # the sin-cos table that reset_free_parameters restores is JAX's init
    init = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    with torch.no_grad():
        tm.reset_free_parameters()
    _close(tm.pos_embed, init['params']['pos_embed'])


# -- the toy fg/bg VAE of tests/test_ffhq_vae.py ---------------------------

RES = 8


def _cams(B=2):
    cam = np.zeros((B, 25), np.float32)
    cam[:, [0, 5, 10, 15, 16, 20, 24]] = 1.0
    cam[:, 11] = 2.7
    cam[1, 3] = 0.2                       # the second camera off-axis
    return cam


@functools.lru_cache(maxsize=None)
def _vae():
    from ln3diff_tpu.models.vae import TriplaneVAE as JVAE
    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
    from test_ffhq_vae import ffhq_small_cfg
    jcfg = ffhq_small_cfg()
    jm = JVAE(jcfg)
    jopts = JOpts(**OPTS, deterministic=True)
    v = _params(lambda k, *a: jm.init(k, *a, jopts, RES,
                                      method=jm.init_decoder_paths),
                jnp.zeros((1, 16, 16, 12)), jnp.zeros((1, 25)), seed=26)
    tcfg = TriplaneVAEConfig(
        latent_size=16, dit2=DiT2Config(tokens_per_plane=64, hidden_size=32,
                                        depth=2, num_heads=2,
                                        dtype=torch.float32),
        conv_sr_ch=8, conv_sr_ch_mult=(1, 2), plane_channels=8,
        decoder_output_dim=8, use_sr=True, sr_ratio=2, sr_module='stylegan',
        use_background=True, bg_depth_resolution=4, dtype=torch.float32)
    return jm, v, _load(TriplaneVAE(tcfg), v), jopts


def test_fgbg_vae_decode_and_render_match_jax():
    jm, v, tm, jopts = _vae()
    latent = _img((2, 16, 16, 12), 27)
    cam = _cams()
    jplanes = jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode_latent))(
        v, jnp.asarray(latent))
    want = jax.jit(lambda p, pl, c: jm.apply(
        p, pl, c, jopts, RES, None, method=jm.render))(v, jplanes,
                                                      jnp.asarray(cam))
    opts = RenderOptions(**OPTS, deterministic=True)
    with torch.no_grad():
        planes = tm.decode_latent(torch.from_numpy(latent))
        got = tm.render(planes, torch.from_numpy(cam), opts, RES)
    assert planes.shape == (2, 3, 16, 16, 8)
    _close(planes, jplanes, 1e-4)
    assert got['image_raw'].shape == (2, RES, RES, 3)
    assert got['image_sr'].shape == (2, 2 * RES, 2 * RES, 3)
    for key in ('image_raw', 'image_sr', 'image_depth', 'image_mask',
                'feature_image'):
        _close(got[key], want[key], 1e-4)
    # the fused fg path (kernel 1's plain version on the CPU)
    with torch.no_grad():
        fused = tm.render(planes, torch.from_numpy(cam), opts, RES,
                          use_fused_osg=True)
    for key in ('image_raw', 'image_sr', 'image_depth', 'image_mask'):
        torch.testing.assert_close(fused[key], got[key], atol=1e-5,
                                   rtol=1e-5)
    with pytest.raises(ValueError, match='foreground'):
        tm.render_rays_flat(planes, torch.zeros(2, 4, 3),
                            torch.ones(2, 4, 3), opts)


def test_fgbg_vae_query_points_use_fg_half():
    jm, v, tm, _ = _vae()
    rng = np.random.default_rng(28)
    planes = rng.standard_normal((1, 3, 8, 8, 8)).astype(np.float32)
    coords = rng.uniform(-0.4, 0.4, (1, 16, 3)).astype(np.float32)
    jrgb, jsigma = jm.apply(v, jnp.asarray(planes), jnp.asarray(coords), 1.0,
                            method=jm.query_points)
    with torch.no_grad():
        rgb, sigma = tm.query_points(torch.from_numpy(planes),
                                     torch.from_numpy(coords), 1.0)
        zeroed = torch.from_numpy(planes).clone()
        zeroed[..., 4:] = 0.0
        rgb2, sigma2 = tm.query_points(zeroed, torch.from_numpy(coords), 1.0)
        frgb, fsigma = tm.query_points(torch.from_numpy(planes),
                                       torch.from_numpy(coords), 1.0,
                                       use_fused_osg=True)
    _close(rgb, jrgb)
    _close(sigma, jsigma)
    assert torch.equal(rgb2, rgb) and torch.equal(sigma2, sigma)
    torch.testing.assert_close(frgb, rgb, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(fsigma, sigma, atol=1e-5, rtol=1e-5)


def test_fgbg_preset_and_sr_ws_init():
    """The 'ffhq-fgbg' preset builds (fg and bg point decoders over 32
    channels each, the ×4 ``SuperresolutionHybrid``), and ``random_init_``
    draws ``sr_ws`` as JAX does: N(0, 0.02²), not the 8XDC head's zeros."""
    from ln3diff_tpu_torch.config import vae_preset
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.vae import TriplaneVAE
    cfg = vae_preset('ffhq-fgbg', dtype=torch.float32)
    with torch.device('meta'):
        vae = TriplaneVAE(cfg)
    assert vae.osg_decoder.EqualDense_0.weight.shape == (64, 32)
    assert vae.bg_decoder.EqualDense_0.weight.shape == (64, 32)
    assert isinstance(vae.superresolution, tsg.SuperresolutionHybrid)
    assert vae.superresolution.n_blocks == 2
    tm = copy.deepcopy(_vae()[2])
    random_init_(tm, torch.Generator().manual_seed(0))
    std = float(tm.sr_ws.detach().std())
    assert 0.01 < std < 0.03, std
