"""The ShapeNet/FFHQ VAE slice of the port against the JAX package: the
fusion decoders (``XYGridCrossAttention``, the v4 and v3 fusion blocks,
``DinoFusionDecoder``, ``unpatchify_triplane``), the Rodin SR (lite and
non-lite), ``NearestConvSR``, the StyleGAN pieces (``upfirdn2d``,
``modulated_conv2d``, ``SynthesisBlockSG2``, ``SuperresolutionHybrid8XDC``)
and ``ShapeNetVAE`` / ``FFHQVAE`` ``encode``, ``decode_latent`` and
``render`` with ``image_sr``.  JAX's parameters (perturbed off their init)
are carried by ``bridge.py``; toy sizes, f32 on both sides; tolerance
1e-5 of each output's scale.  The 8XDC head has fixed widths (256 and 128
channels up to 512²), so it runs twice in this file."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models import rodin as jrodin
from ln3diff_tpu.models import sr as jsr
from ln3diff_tpu.models import stylegan as jsg
from ln3diff_tpu.models import vae_shapenet as jvs
from ln3diff_tpu.models import vit as jvit
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import rodin as trodin
from ln3diff_tpu_torch.models import sr as tsr
from ln3diff_tpu_torch.models import stylegan as tsg
from ln3diff_tpu_torch.models import vae_shapenet as tvs
from ln3diff_tpu_torch.models import vit as tvit
from ln3diff_tpu_torch.render.camera import orbit_cameras
from ln3diff_tpu_torch.render.renderer import RenderOptions

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach(), np.float64), want,
                               atol=rel * scale, rtol=0)


def _perturbed(params, seed, amount=0.1):
    """Every leaf moved off its init (zero-init skips and sr_ws,
    layerscale 1e-5, unit norms), so that each parameter shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + amount * rng.standard_normal(p.shape))
        .astype(np.float32), params)


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _pair(jmodule, tmodule, *init_args, seed=0, state_dict=None, **kw):
    """A JAX module's jitted init (perturbed) and the port module with the
    same weights."""
    v = jax.jit(jmodule.init)(jax.random.PRNGKey(seed),
                              *map(jnp.asarray, init_args), **kw)
    v = {'params': _perturbed(v['params'], seed + 1)}
    convert = state_dict or (lambda p: bridge._convert(p, {}))
    tmodule.load_state_dict(convert(v))
    return v, tmodule.eval()


def _run(jmodule, v, tmodule, *args):
    want = jax.jit(jmodule.apply)(v, *map(jnp.asarray, args))
    with torch.no_grad():
        got = tmodule(*map(torch.from_numpy, args))
    return got, want


# -- fusion decoder ----------------------------------------------------------

D, HEADS = 32, 2


def test_xygrid_cross_attention_matches_jax():
    x = _rand((2, 3, 16, D), 1)
    jm = jvit.XYGridCrossAttention(HEADS)
    v, tm = _pair(jm, tvit.XYGridCrossAttention(D, HEADS), x)
    got, want = _run(jm, v, tm, x)
    assert got.shape == (2, 3, 16, D)
    _close(got, want)


@pytest.mark.parametrize('variant', ['v4', 'v3'])
def test_fusion_block_matches_jax(variant):
    x = _rand((2, 3, 16, D), 2)
    jcls, tcls = {'v4': (jvit.DinoFusionBlock, tvit.DinoFusionBlock),
                  'v3': (jvit.DinoFusionBlockV3, tvit.DinoFusionBlockV3)}[
                      variant]
    jm = jcls(HEADS)
    v, tm = _pair(jm, tcls(D, HEADS), x, seed=3)
    got, want = _run(jm, v, tm, x)
    _close(got, want)


@pytest.mark.parametrize('variant', ['v4', 'v3'])
def test_fusion_decoder_matches_jax(variant):
    """Depth 4: two uvit skips, popped in the reference's ``half - 1``
    order; the sin-cos ``pos_embed`` is a carried parameter."""
    x = _rand((2, 3 * 16, D), 4)
    jm = jvit.DinoFusionDecoder(depth=4, num_heads=HEADS, tokens_per_plane=16,
                                block_variant=variant)
    tm = tvit.DinoFusionDecoder(D, depth=4, num_heads=HEADS,
                                tokens_per_plane=16, block_variant=variant)
    init = tm.pos_embed.detach().clone()
    v, tm = _pair(jm, tm, x, seed=5)
    jinit = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    np.testing.assert_allclose(init.numpy(),
                               np.asarray(jinit['params']['pos_embed']),
                               atol=1e-6)
    got, want = _run(jm, v, tm, x)
    _close(got, want)


def test_unpatchify_triplane_matches_jax():
    x = _rand((2, 3, 16, 4 * 4 * 5), 6)
    want = jvit.unpatchify_triplane(jnp.asarray(x), 4, 5)
    got = tvit.unpatchify_triplane(torch.from_numpy(x), 4, 5)
    assert got.shape == (2, 3, 16, 16, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- Rodin and NearestConvSR -------------------------------------------------

@pytest.mark.parametrize('lite', [True, False], ids=['lite', 'rollout'])
def test_rodin_matches_jax(lite):
    """in 3·8 → out 3·4 channels (the linear shortcut), 8² → 32²: the
    bilinear resize held at the borders too."""
    x = _rand((2, 8, 8, 24), 7)
    jm = jrodin.RodinConv3D4XResidual(24, 12, input_resolution=32, lite=lite)
    v, tm = _pair(jm, trodin.RodinConv3D4XResidual(24, 12, 32, lite=lite),
                  x, seed=8)
    got, want = _run(jm, v, tm, x)
    assert got.shape == (2, 32, 32, 12)
    _close(got, want)
    _close(got[:, [0, -1]], np.asarray(want)[:, [0, -1]])
    _close(got[:, :, [0, -1]], np.asarray(want)[:, :, [0, -1]])


def test_rodin_equal_channels_matches_jax():
    x = _rand((1, 8, 8, 12), 9)
    jm = jrodin.RodinConv3D4XResidual(12, 12, input_resolution=16, lite=True)
    v, tm = _pair(jm, trodin.RodinConv3D4XResidual(12, 12, 16, lite=True),
                  x, seed=10)
    _close(*_run(jm, v, tm, x))


@pytest.mark.parametrize('sr_ratio', [2, 4])
def test_nearest_conv_sr_matches_jax(sr_ratio):
    """Unbounded output: no clamp to [-1, 1]."""
    x = _rand((2, 6, 6, 8), 11, -3, 3)
    jm = jsr.NearestConvSR(num_feat=16, sr_ratio=sr_ratio)
    v, tm = _pair(jm, tsr.NearestConvSR(8, num_feat=16, sr_ratio=sr_ratio),
                  x, seed=12)
    got, want = _run(jm, v, tm, x)
    assert got.shape == (2, 6 * sr_ratio, 6 * sr_ratio, 3)
    _close(got, want)


# -- StyleGAN ----------------------------------------------------------------

def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize('up,padding', [
    (1, (1, 2, 0, 1)), (2, (2, 1, 2, 1)), (1, (1, 1, 1, 1)),
    (2, (-1, 2, 1, -1))])
def test_upfirdn2d_matches_jax(up, padding):
    """The 2x zero-stuffing path and the filter-only path (padding (1, 1,
    1, 1) is the one ``modulated_conv2d``'s up path runs)."""
    x = _rand((2, 7, 9, 3), 13)
    f = jsg.setup_filter()
    want = jsg.upfirdn2d(jnp.asarray(x), f, up=up, padding=padding,
                         gain=1.5)
    got = tsg.upfirdn2d(_nchw(x), tsg.setup_filter(), up=up,
                        padding=padding, gain=1.5)
    _close(got.permute(0, 2, 3, 1), want)
    _close(tsg.upsample2d(_nchw(x), tsg.setup_filter()).permute(0, 2, 3, 1),
           jsg.upsample2d(jnp.asarray(x), f))


@pytest.mark.parametrize('demodulate', [True, False])
@pytest.mark.parametrize('up', [1, 2])
def test_modulated_conv2d_matches_jax(up, demodulate):
    x = _rand((3, 6, 5, 4), 14)
    w = np.random.default_rng(15).standard_normal((3, 3, 4, 6)).astype(
        np.float32)
    styles = _rand((3, 4), 16, 0.5, 1.5)
    want = jsg.modulated_conv2d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(styles), demodulate=demodulate,
                                up=up)
    got = tsg.modulated_conv2d(
        _nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(styles), demodulate=demodulate, up=up)
    assert got.shape == (3, 6, 6 * up, 5 * up)
    _close(got.permute(0, 2, 3, 1), want)


def test_modulated_conv2d_1x1_matches_jax():
    x = _rand((2, 5, 5, 4), 17)
    w = np.random.default_rng(18).standard_normal((1, 1, 4, 3)).astype(
        np.float32)
    styles = _rand((2, 4), 19)
    want = jsg.modulated_conv2d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(styles), demodulate=False)
    got = tsg.modulated_conv2d(
        _nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(styles), demodulate=False)
    _close(got.permute(0, 2, 3, 1), want)


def test_synthesis_block_matches_jax():
    """conv0 (2x up) → conv1 → ToRGB plus the FIR-upsampled image skip,
    at toy widths; noise_const and noise_strength are carried and unused
    (``noise_mode='none'``)."""
    x, img = _rand((2, 6, 6, 8), 20), _rand((2, 6, 6, 3), 21)
    ws = _rand((2, 512), 22)
    jm = jsg.SynthesisBlockSG2(16, 12)
    tm = tsg.SynthesisBlockSG2(8, 16, 12)
    v = jax.jit(jm.init)(jax.random.PRNGKey(23), *map(jnp.asarray,
                                                      (x, img, ws)))
    v = {'params': _perturbed(v['params'], 24)}
    tm.load_state_dict(bridge._convert(v, {}))
    jx, jimg = jax.jit(jm.apply)(v, *map(jnp.asarray, (x, img, ws)))
    with torch.no_grad():
        tx, timg = tm(_nchw(x), _nchw(img), torch.from_numpy(ws))
    _close(tx.permute(0, 2, 3, 1), jx)
    _close(timg.permute(0, 2, 3, 1), jimg)


@functools.lru_cache(maxsize=None)
def _sr8x():
    feat, rgb = _rand((1, 64, 64, 8), 25), _rand((1, 64, 64, 3), 26)
    ws = _rand((1, 512), 27)
    jm = jsg.SuperresolutionHybrid8XDC()
    v, tm = _pair(jm, tsg.SuperresolutionHybrid8XDC(8), feat, rgb, ws,
                  seed=28)
    return jm, v, tm, (feat, rgb, ws)


def test_superresolution_hybrid_8xdc_matches_jax():
    """One sample, a 64² feature input: the antialiased resize to 128²,
    then both synthesis blocks to 512²."""
    jm, v, tm, args = _sr8x()
    got, want = _run(jm, v, tm, *args)
    assert got.shape == (1, 512, 512, 3) and got.dtype == torch.float32
    _close(got, want)


# -- the VAEs ----------------------------------------------------------------

OPTS = dict(depth_resolution=4, depth_resolution_importance=4)
RES = 8


def _enc(registry, img_size):
    return dict(encoder_vit=registry('dinov2-s/14', img_size=img_size,
                                     embed_dim=32, depth=2, num_heads=2))


FAMILIES = {
    # ShapeNet: 4x4 latent, 2x2 tokens per plane, planes 8² → 32², 8²
    # rays → NearestConvSR 16²; FFHQ: 4x4 latent (vae_p 1), 16 tokens per
    # plane, planes 16² → 32², 8² rays → 8XDC 512²
    'shapenet': dict(img=28, kw=dict(token_size=2, vae_p=2, decoder_embed_dim=32,
                             decoder_fusion_depth=4, decoder_num_heads=2,
                             channel_multiplier=2, plane_channels=8,
                             triplane_resolution=32, decoder_output_dim=8),
                     opts=dict(ray_start=0.6, ray_end=1.8, box_warp=1.2,
                               white_back=True),
                     camera=dict(radius=1.2, fov=50.0, pitch_deg=20.0)),
    'ffhq': dict(img=56, kw=dict(token_size=4, decoder_embed_dim=32,
                         decoder_fusion_depth=2, decoder_num_heads=2,
                         channel_multiplier=2, plane_channels=8,
                         triplane_resolution=32, decoder_output_dim=8),
                 opts=dict(ray_start=2.25, ray_end=3.3, box_warp=1.0,
                           white_back=False),
                 camera=dict(radius=2.7, fov=12.6, pitch_deg=0.0)),
}


@functools.lru_cache(maxsize=None)
def _vae(family):
    fam = FAMILIES[family]
    jcls, jcfg, tcls, tcfg = {
        'shapenet': (jvs.ShapeNetVAE, jvs.ShapeNetVAEConfig,
                     tvs.ShapeNetVAE, tvs.ShapeNetVAEConfig),
        'ffhq': (jvs.FFHQVAE, jvs.FFHQVAEConfig, tvs.FFHQVAE,
                 tvs.FFHQVAEConfig)}[family]
    jm = jcls(jcfg(**_enc(jvit.vit_registry, fam['img']), **fam['kw']))
    tm = tcls(tcfg(**_enc(tvit.vit_registry, fam['img']), **fam['kw']),
              encoder=True)
    jopts = JOpts(**OPTS, **fam['opts'], deterministic=True)
    v = jax.jit(lambda k, i, c: jm.init(k, i, c, jopts, RES))(
        jax.random.PRNGKey(30), jnp.zeros((1, fam['img'], fam['img'], 3)),
        jnp.zeros((1, 25)))
    v = {'params': _perturbed(v['params'], 31)}
    tm.load_state_dict(bridge.vae_state_dict(v))
    return jm, v, tm.eval(), jopts, RenderOptions(**OPTS, **fam['opts'])


@pytest.mark.parametrize('family', ['shapenet', 'ffhq'])
def test_vae_encode_matches_jax(family):
    jm, v, tm, _, _ = _vae(family)
    hw = FAMILIES[family]['img']
    imgs = _rand((2, hw, hw, 3), 32)
    want = jax.jit(lambda v, i: jm.apply(v, i, method=jm.encode))(
        v, jnp.asarray(imgs))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(imgs))
    assert got.shape == (2, 4, 4, 8, 3)
    _close(got, want)


@pytest.mark.parametrize('family', ['shapenet', 'ffhq'])
def test_vae_decode_and_render_match_jax(family):
    """``decode_latent`` to (B, 3, 32, 32, 8) planes, then ``render`` of
    one orbit camera with ``image_sr`` (ShapeNet 16², FFHQ 512²)."""
    jm, v, tm, jopts, topts = _vae(family)
    latent = _rand((1, 4, 4, 12), 33, -2, 2)
    cam = orbit_cameras(1, **FAMILIES[family]['camera'])
    want_planes = jax.jit(
        lambda v, z: jm.apply(v, z, method=jm.decode_latent))(
            v, jnp.asarray(latent))
    want = jax.jit(lambda v, p, c: jm.apply(
        v, p, c, jopts, RES, None, method=jm.render))(
            v, want_planes, jnp.asarray(cam))
    with torch.no_grad():
        planes = tm.decode_latent(torch.from_numpy(latent))
        got = tm.render(torch.from_numpy(np.array(want_planes)),
                        torch.from_numpy(cam), topts, RES)
    assert planes.shape == (1, 3, 32, 32, 8)
    _close(planes, want_planes)
    sr = 16 if family == 'shapenet' else 512
    assert got['image_sr'].shape == (1, sr, sr, 3)
    for key in ('image_raw', 'image_depth', 'image_mask', 'image_sr'):
        _close(got[key], want[key])
