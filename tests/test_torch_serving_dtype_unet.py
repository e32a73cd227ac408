"""The serving dtype of the ShapeNet/FFHQ models: the U-Net-320's toy
twin and both VAE decoders with their SR heads, run in bf16.

XLA and torch round bf16 in different places, so the port's bf16 output
is held to JAX's f32 output no further than twice JAX's own bf16 output
is, the bar of ``test_torch_serving_dtype.py``.  Both sides load the same
weights (the toy models of ``test_torch_unet_families.py``).  As the
bench runs them, the JAX U-Net has bf16 weights and computes in bf16; the
JAX VAE keeps f32 weights and computes in bf16, its planes are rendered in
bf16 through the fused point route, and the 8XDC head computes in f32.
The port casts the U-Net whole and the VAE decoder's layers
(``cast_decoder``)."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models import unet as junet
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
from ln3diff_tpu.utils.misc import cast_floating
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.config import CAMERA_PRESETS
from ln3diff_tpu_torch.models import unet as tunet
from ln3diff_tpu_torch.models import vae_shapenet as tvs
from ln3diff_tpu_torch.models import vit as tvit
from ln3diff_tpu_torch.render.camera import orbit_cameras
from ln3diff_tpu_torch.render.renderer import RenderOptions
from test_torch_unet_families import (FAMILIES, OPTS, RES, UNET_KW, VAE_KW,
                                      _enc, _params)
from ln3diff_tpu.models import vit as jvit

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _gaps(want32, want16, got):
    want32 = np.asarray(want32, np.float32)
    jax_gap = np.abs(np.asarray(want16, np.float32) - want32).max()
    port_gap = np.abs(got.float().numpy() - want32).max()
    return port_gap, jax_gap


def test_unet_bf16_gap():
    jm32 = junet.UNetModel(junet.UNetConfig(dtype=jnp.float32, **UNET_KW))
    jm16 = junet.UNetModel(junet.UNetConfig(dtype=jnp.bfloat16, **UNET_KW))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 4, 12)).astype(np.float32)
    t = np.array([12.0, 640.0], np.float32)
    ctx = rng.standard_normal((2, 1, 32)).astype(np.float32)
    args = tuple(map(jnp.asarray, (x, t, ctx)))
    v = _params(jm32.init, *args, seed=2)
    want32 = jax.jit(jm32.apply)(v, *args)
    want16 = jax.jit(jm16.apply)(cast_floating(v, jnp.bfloat16), *args)
    tm = tunet.UNetModel(tunet.UNetConfig(dtype=torch.bfloat16, **UNET_KW))
    tm.load_state_dict(bridge.unet_state_dict(v))
    tm = tm.to(torch.bfloat16).eval()
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (x, t, ctx)))
    assert got.dtype == torch.float32
    port_gap, jax_gap = _gaps(want32, want16, got)
    assert port_gap <= 2 * jax_gap, (port_gap, jax_gap)


@functools.lru_cache(maxsize=None)
def _vaes(family):
    fam = FAMILIES[family]
    jopts = JOpts(**OPTS, **fam['opts'])
    jm = {dt: fam['jvae'](fam['jcfg'](encoder_vit=_enc(jvit.vit_registry),
                                      **VAE_KW, **fam['vae'], dtype=dt))
          for dt in (jnp.float32, jnp.bfloat16)}
    hw = jm[jnp.float32].cfg.latent_size
    v = _params(lambda k, *a: jm[jnp.float32].init(
        k, *a, jopts, RES, method=jm[jnp.float32].init_decoder_paths),
        jnp.zeros((1, hw, hw, 12)), jnp.zeros((1, 25)), seed=3)
    tcfg = fam['tcfg'](encoder_vit=_enc(tvit.vit_registry), **VAE_KW,
                       **fam['vae'], dtype=torch.bfloat16)
    tm = getattr(tvs, fam['jvae'].__name__)(tcfg)
    tm.load_state_dict(bridge.vae_state_dict(v))
    return jm, v, tm.cast_decoder().eval(), jopts, hw


@pytest.mark.parametrize('family', ['shapenet', 'ffhq'])
def test_vae_decoder_and_sr_bf16_gap(family):
    """The decode to planes, then the SR frame of one orbit camera from
    the bf16 planes, each within twice JAX's bf16 gap."""
    jm, v, tm, jopts, hw = _vaes(family)
    topts = RenderOptions(**OPTS, **FAMILIES[family]['opts'])
    latent = np.random.default_rng(4).standard_normal(
        (1, hw, hw, 12)).astype(np.float32)
    cam = orbit_cameras(1, **CAMERA_PRESETS[family])
    planes, frames = {}, {}
    for dt, m in jm.items():
        planes[dt] = jax.jit(lambda v, z: m.apply(
            v, z, method=m.decode_latent))(v, jnp.asarray(latent))
        rp = planes[dt].astype(jnp.float32 if dt == jnp.float32
                               else jnp.bfloat16)
        frames[dt] = jax.jit(lambda v, p, c: m.apply(
            v, p, c, jopts, RES, None, use_fused_osg=True,
            method=m.render)['image_sr'])(v, rp, jnp.asarray(cam))
    with torch.no_grad():
        got_planes = tm.decode_latent(torch.from_numpy(latent))
        got_frames = tm.render(got_planes.to(torch.bfloat16),
                               torch.from_numpy(cam), topts, RES,
                               use_fused_osg=True)['image_sr']
    assert got_planes.dtype == torch.bfloat16
    for got, want in ((got_planes, planes), (got_frames, frames)):
        port_gap, jax_gap = _gaps(want[jnp.float32], want[jnp.bfloat16],
                                  got)
        assert port_gap <= 2 * jax_gap, (port_gap, jax_gap)
