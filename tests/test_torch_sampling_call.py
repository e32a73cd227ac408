"""The serving call's options against ``ln3diff_tpu.pipeline``: ``__call__``
at batch 2 for the text→3D, image→3D and multi-view→3D families; the
DPM-Solver++ and PLMS kinds and the LSGM mixing logit through the call;
explicit ``cameras`` read back by ``load_pose_asset``; ``render_orbit``'s
``frames_per_call`` and ``samples_per_ray``; and the flat-ray orbit
(``render_rays_fn`` with ``TriplaneVAE.render_rays_flat``) against the
per-frame orbit and against JAX's.

The toy models, weights and conditioning are those of
``test_torch_pipeline.py`` (text→3D) and ``test_torch_i23d.py`` (the
image families), carried by the bridge; the port gets JAX's start noise
as ``x_init``.  Whole-call tolerance 1e-4 of each output's scale (the
slices' bar); renders of the same planes 1e-5.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.conditioning import clip as jclip
from ln3diff_tpu.diffusion.gaussian import make_diffusion as jmake
from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.models.vae import TriplaneVAE as JVAE
from ln3diff_tpu.models.vae import TriplaneVAEConfig as JVAEConfig
from ln3diff_tpu.pipeline import SamplerSpec as JSamplerSpec
from ln3diff_tpu.pipeline import TextTo3DPipeline as JPipeline
from ln3diff_tpu.render import camera as jcamera
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.conditioning import clip as tclip
from ln3diff_tpu_torch.diffusion.gaussian import make_diffusion as tmake
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
from ln3diff_tpu_torch.pipeline import SamplerSpec, build_t23d_pipeline
from ln3diff_tpu_torch.render import camera as tcamera
from ln3diff_tpu_torch.render.renderer import RenderOptions
from test_torch_i23d import (D2_KW, OPTS, RES, TEXT_KW, VAE_KW, _family,
                             _images, _perturbed)
from test_torch_pipeline import _salt_free_ids

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

LATENT = (8, 8, 12)
DEN_KW = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
              depth=2, num_heads=2, context_dim=32, exact_gelu=False)


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


@functools.lru_cache(maxsize=None)
def _models():
    """A toy text→3D model on both sides: JAX's jitted inits with every
    leaf moved off its init by a numpy draw, the port's modules loaded
    through the bridge."""
    jden = jdit.DiT_TriLatent(jdit.DiTConfig(dtype=jnp.float32, **DEN_KW))
    jvae = JVAE(JVAEConfig(encoder_ch=8, encoder_ch_mult=(1, 2),
                           img_resolution=32, num_views=2,
                           dit2=jdit.DiT2Config(dtype=jnp.float32, **D2_KW),
                           dtype=jnp.float32, **VAE_KW))
    jtext = jclip.CLIPTextModel(jclip.CLIPTextConfig(**TEXT_KW))
    den_v = jax.jit(jden.init)(jax.random.PRNGKey(0), jnp.zeros((2,) + LATENT),
                               jnp.zeros((2,)),
                               {'crossattn': jnp.zeros((2, 77, 32))})
    den_v = {'params': _perturbed(den_v['params'], 20),
             'constants': den_v['constants']}
    opts = JOpts(**OPTS)
    vae_v = jax.jit(lambda k: jvae.init(
        k, jnp.zeros((1,) + LATENT), jnp.zeros((1, 25)), opts, 4,
        method=jvae.init_decoder_paths))(jax.random.PRNGKey(1))
    vae_v = {'params': _perturbed(vae_v['params'], 21)}
    text_v = {'params': _perturbed(jax.jit(jtext.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))['params'],
        22, 0.1)}
    tcfgs = dict(den_cfg=tdit.DiTConfig(dtype=torch.float32, **DEN_KW),
                 vae_cfg=TriplaneVAEConfig(
                     dit2=tdit.DiT2Config(dtype=torch.float32, **D2_KW),
                     dtype=torch.float32, **VAE_KW),
                 text_cfg=tclip.CLIPTextConfig(**TEXT_KW))
    tden = tdit.DiT_TriLatent(tcfgs['den_cfg'])
    tden.load_state_dict(bridge.dit_state_dict(den_v))
    tvae = TriplaneVAE(tcfgs['vae_cfg'])
    tvae.load_state_dict(bridge.vae_state_dict(vae_v))
    ttext = tclip.CLIPTextModel(tcfgs['text_cfg'])
    ttext.load_state_dict(bridge.clip_text_state_dict(text_v))
    return dict(jden=jden, jvae=jvae, jtext=jtext, den_v=den_v,
                vae_v=vae_v, text_v=text_v, tcfgs=tcfgs,
                tmods=dict(denoiser=tden.eval(), vae=tvae.eval(),
                           text_model=ttext.eval()))


@functools.lru_cache(maxsize=None)
def _jax_t23d(kind='ddim', steps=6, flat=False):
    """JAX's text→3D pipeline as ``bench.py`` builds it (``kind='dpm'``
    over the unspaced schedule); with ``flat``, it folds the orbit's
    frames into the ray axis.  Cached: JAX compiles once per instance."""
    m = _models()
    jden, jvae, opts = m['jden'], m['jvae'], JOpts(**OPTS)
    jflat = None
    if flat:
        def jflat(p, planes, o, d):
            return jvae.apply(p, planes, o, d, opts, use_fused_osg=True,
                              method=jvae.render_rays_flat)
    jpipe = JPipeline(
        lambda p, x, t, c: jden.apply(p, x, t, c), m['den_v'],
        lambda p, lat: jvae.apply(p, lat, method=jvae.decode_latent),
        m['vae_v'],
        lambda p, planes, cam: jvae.apply(
            p, planes, cam, opts, RES, None, use_fused_osg=True,
            method=jvae.render)['image_raw'],
        lambda p, planes, coords: jvae.apply(
            p, planes, coords, opts.box_warp, use_fused_osg=True,
            method=jvae.query_points),
        sampler=JSamplerSpec(kind=kind, num_steps=steps, cfg_scale=6.5,
                             latent_shape=LATENT),
        diffusion=jmake(steps=1000, timestep_respacing=None if kind == 'dpm'
                        else f'ddim{steps}'),
        render_rays_fn=jflat)
    return jpipe


def _t23d(kind='ddim', steps=6, flat=False):
    """JAX's pipeline (``_jax_t23d``) and the port's, from
    ``build_t23d_pipeline`` on the same weights."""
    m = _models()
    jpipe = _jax_t23d(kind, steps, flat)
    tpipe, _, mods = build_t23d_pipeline(
        'cpu', modules=m['tmods'], render_opts=RenderOptions(**OPTS),
        render_resolution=RES, render_dtype=None,
        sampler=SamplerSpec(kind=kind, num_steps=steps, cfg_scale=6.5,
                            latent_shape=LATENT), **m['tcfgs'])
    if flat:
        vae, topts = mods['vae'], RenderOptions(**OPTS)
        tpipe.render_rays_fn = lambda planes, o, d: vae.render_rays_flat(
            planes, o, d, topts, use_fused_osg=True)
    return jpipe, tpipe


def _t23d_context():
    """(cond, uncond) on both sides from salt-free token ids."""
    m = _models()
    ids = _salt_free_ids('a red wooden chair')
    both = jax.jit(m['jtext'].apply)(m['text_v'], jnp.asarray(ids))[
        'last_hidden_state']
    with torch.no_grad():
        tboth = m['tmods']['text_model'](torch.from_numpy(ids))[
            'last_hidden_state']
    return (({'crossattn': both[:1]}, {'crossattn': both[1:]}),
            ({'crossattn': tboth[:1]}, {'crossattn': tboth[1:]}))


def _start(k_sample, kind, batch):
    """The start noise JAX's ``sample_latents`` draws from ``k_sample``
    for ``kind``: DDIM and PLMS split it once more, DPM and flow matching
    draw from it as it is."""
    if kind in ('ddim', 'plms'):
        _, k_sample = jax.random.split(k_sample)
    return torch.from_numpy(np.array(jax.random.normal(
        k_sample, (batch,) + LATENT)))


def _noise(key, kind, batch):
    """The start noise of JAX's ``__call__(key, ...)``."""
    return _start(jax.random.split(key)[0], kind, batch)


def _check_call(got, want, batch, frames):
    assert got['video'].shape == (batch, frames, RES, RES, 3)
    for k in ('latents', 'planes', 'video'):
        _close(got[k], want[k])


def test_t23d_call_at_batch_2():
    jpipe, tpipe = _t23d()
    (jc, ju), (tc, tu) = _t23d_context()
    key = jax.random.PRNGKey(3)
    want = jpipe(key, jc, ju, batch=2, num_frames=2, render_resolution=RES)
    got = tpipe(tc, tu, batch=2, num_frames=2, render_resolution=RES,
                x_init=_noise(key, 'ddim', 2))
    _check_call(got, want, 2, 2)
    # the two samples differ: the batch is not one sample repeated
    assert not torch.allclose(got['latents'][0], got['latents'][1])


@pytest.mark.parametrize('name', ['i23d', 'mv23d'])
def test_image_families_call_at_batch_2(name):
    jpipe, jencode, tpipe, tencode = _family(name)
    imgs = _images(1 if name == 'i23d' else 4, seed=5)
    jc, ju = jencode(jnp.asarray(imgs))
    tc, tu = tencode(torch.from_numpy(imgs))
    key = jax.random.PRNGKey(4)
    want = jpipe(key, jc, ju, batch=2, num_frames=3, render_resolution=RES)
    got = tpipe(tc, tu, batch=2, num_frames=3, render_resolution=RES,
                x_init=_noise(key, 'flow_matching', 2))
    _check_call(got, want, 2, 3)


@pytest.mark.parametrize('kind', ['dpm', 'plms'])
def test_t23d_call_with_dpm_and_plms(kind):
    """``kind='dpm'`` (bench.py's ``dpm25``, here 6 solver steps over the
    unspaced schedule) and ``kind='plms'`` (over ``ddim6``) through the
    builder and ``__call__``; the denoiser runs steps + 1 times."""
    jpipe, tpipe = _t23d(kind)
    assert tpipe.diffusion.num_timesteps == (1000 if kind == 'dpm' else 6)
    (jc, ju), (tc, tu) = _t23d_context()
    calls = []
    den = tpipe.denoiser_fn
    tpipe.denoiser_fn = lambda *a: calls.append(1) or den(*a)
    key = jax.random.PRNGKey(5)
    want = jpipe(key, jc, ju, num_frames=2, render_resolution=RES)
    got = tpipe(tc, tu, num_frames=2, render_resolution=RES,
                x_init=_noise(key, kind, 1))
    _check_call(got, want, 1, 2)
    assert len(calls) == 7


@pytest.mark.parametrize('kind', ['ddim', 'plms', 'dpm'])
def test_mixing_logit_through_the_call(kind):
    """The LSGM logit reaches each DDPM-family sampler of the call
    (v-prediction, mixed in eps space after the v → eps conversion)."""
    _, tpipe = _t23d(kind, steps=4)
    jpipe = JPipeline(*(getattr(_jax_t23d(kind, 4), k) for k in (
        'denoiser_fn', 'denoiser_params', 'decode_fn', 'vae_params',
        'render_fn', 'point_decoder_fn')), sampler=_jax_t23d(kind, 4).spec)
    resp = None if kind == 'dpm' else 'ddim4'
    jpipe.diffusion = jmake(timestep_respacing=resp, mean_type='v',
                            mixed_prediction=True)
    tpipe.diffusion = tmake(timestep_respacing=resp, mean_type='v',
                            mixed_prediction=True)
    logit = np.random.default_rng(2).standard_normal(
        (1, 1, 1, 12)).astype(np.float32)
    jpipe.mixing_logit = jnp.asarray(logit)
    tpipe.mixing_logit = torch.from_numpy(logit)
    (jc, ju), (tc, tu) = _t23d_context()
    k_sample = jax.random.PRNGKey(6)
    want = jpipe.sample_latents(k_sample, 1, jc, ju)
    noise = _start(k_sample, kind, 1)
    got = tpipe.sample_latents(1, tc, tu, x_init=noise)
    _close(got, want)
    tpipe.mixing_logit = None
    assert not torch.allclose(tpipe.sample_latents(1, tc, tu, x_init=noise),
                              got)


def _pose_file(tmp_path):
    """Three views of the 24-view orbit at pitch 13.73°, radius 1.772 (the
    release asset's first rows), saved as the asset is: a torch tensor."""
    cams = jcamera.orbit_cameras(24, 1.772, 30.0, 13.73)[::8]
    path = tmp_path / 'poses.pt'
    torch.save(torch.from_numpy(cams), path)
    return path, cams


def test_load_pose_asset(tmp_path):
    path, cams = _pose_file(tmp_path)
    got = tcamera.load_pose_asset(str(path))
    assert got.dtype == np.float32 and got.shape == (3, 25)
    np.testing.assert_array_equal(got, jcamera.load_pose_asset(str(path)))
    np.testing.assert_array_equal(got, cams)
    np.testing.assert_allclose(
        tcamera.orbit_cameras(24, 1.772, 30.0, 13.73)[::8], cams, atol=0)
    torch.save(torch.zeros(4, 16), tmp_path / 'bad.pt')
    with pytest.raises(ValueError, match='25'):
        tcamera.load_pose_asset(str(tmp_path / 'bad.pt'))


def test_call_with_explicit_cameras(tmp_path):
    """``__call__(cameras=...)`` with the cameras of a pose file, with and
    without a mesh: the orbit takes their count and poses."""
    path, _ = _pose_file(tmp_path)
    jcams = jcamera.load_pose_asset(str(path))
    tcams = tcamera.load_pose_asset(str(path))
    jpipe, tpipe = _t23d(steps=3)
    (jc, ju), (tc, tu) = _t23d_context()
    key = jax.random.PRNGKey(7)
    want = jpipe(key, jc, ju, render_resolution=RES, cameras=jcams)
    got = tpipe(tc, tu, render_resolution=RES, cameras=tcams,
                x_init=_noise(key, 'ddim', 1))
    _check_call(got, want, 1, 3)
    with torch.no_grad():
        ring = tpipe.render_orbit(got['planes'], 3, render_resolution=RES)
    assert not torch.allclose(ring, got['video'])
    meshed = tpipe(tc, tu, render_resolution=RES, cameras=tcams,
                   x_init=_noise(key, 'ddim', 1), mesh_grid=12,
                   mesh_path=str(tmp_path / 'm.obj'))
    torch.testing.assert_close(meshed['video'], got['video'], atol=0,
                               rtol=0)


def _planes(batch=1, seed=8):
    m = _models()
    lat = np.random.default_rng(seed).standard_normal(
        (batch,) + LATENT).astype(np.float32)
    jplanes = jax.jit(lambda v, x: m['jvae'].apply(
        v, x, method=m['jvae'].decode_latent))(m['vae_v'], jnp.asarray(lat))
    with torch.no_grad():
        tplanes = m['tmods']['vae'].decode_latent(torch.from_numpy(lat))
    return jplanes, tplanes


def test_render_rays_flat_matches_jax():
    """A non-square bundle (two frames' rays and five more) through the
    flat renderer, plain and through the fused point pipeline."""
    m = _models()
    jplanes, tplanes = _planes()
    cams = jcamera.orbit_cameras(3, 1.8, 30.0, 20.0)
    from ln3diff_tpu.render.ray_sampler import sample_full_rays as jrays
    from ln3diff_tpu.render.ray_sampler import unpack_25d_camera as junpack
    c2w, intr = junpack(jnp.asarray(cams))
    o, d = jrays(c2w, intr, RES)
    o = np.array(o).reshape(1, -1, 3)[:, :2 * RES * RES + 5]
    d = np.array(d).reshape(1, -1, 3)[:, :2 * RES * RES + 5]
    for fused in (False, True):
        want = jax.jit(lambda v, p, o, d: m['jvae'].apply(
            v, p, o, d, JOpts(**OPTS), use_fused_osg=fused,
            method=m['jvae'].render_rays_flat))(
                m['vae_v'], jplanes, jnp.asarray(o), jnp.asarray(d))
        with torch.no_grad():
            got = m['tmods']['vae'].render_rays_flat(
                tplanes, torch.from_numpy(o), torch.from_numpy(d),
                RenderOptions(**OPTS), use_fused_osg=fused)
        assert got.shape == (1, 2 * RES * RES + 5, want.shape[-1])
        _close(got, want, 1e-5)


@pytest.mark.parametrize('frames_per_call', [None, 1, 2])
def test_flat_ray_orbit_matches_per_frame_and_jax(frames_per_call):
    """The orbit with frames folded into the ray axis equals the per-frame
    orbit (mirroring ``tests/test_pipeline.py::
    test_ray_folded_orbit_matches_per_frame``) and JAX's folded orbit;
    ``frames_per_call`` and ``samples_per_ray`` set the chunks as in
    JAX."""
    jflat, tflat = _t23d(flat=True)
    jbase, tbase = _t23d()
    jplanes, tplanes = _planes()
    kw = dict(render_resolution=RES, frames_per_call=frames_per_call,
              samples_per_ray=64)
    calls = []
    fn = tflat.render_rays_fn
    tflat.render_rays_fn = lambda *a: calls.append(a[1].shape[1]) or fn(*a)
    with torch.no_grad():
        v_flat = tflat.render_orbit(tplanes, 4, **kw)
        v_base = tbase.render_orbit(tplanes, 4, **kw)
    assert v_flat.shape == (1, 4, RES, RES, 3)
    fpc = frames_per_call or 4
    assert calls == [fpc * RES * RES] * (4 // fpc)
    _close(v_flat, v_base, 1e-5)
    _close(v_flat, jflat.render_orbit(jplanes, 4, **kw), 1e-5)
    _close(v_base, jbase.render_orbit(jplanes, 4, **kw), 1e-5)


def test_flat_ray_orbit_only_at_batch_1():
    """At batch 2 the folded path does not apply: both pipelines render
    per frame, and equal JAX's."""
    jflat, tflat = _t23d(flat=True)
    jplanes, tplanes = _planes(batch=2)
    with torch.no_grad():
        got = tflat.render_orbit(tplanes, 2, render_resolution=RES,
                                 frames_per_call=1)
    want = jflat.render_orbit(jplanes, 2, render_resolution=RES,
                              frames_per_call=1)
    assert got.shape == (2, 2, RES, RES, 3)
    _close(got, want, 1e-5)


def test_frame_slice_with_cameras():
    """``frame_slice`` cuts explicit cameras as it cuts the ring."""
    _, tpipe = _t23d()
    _, tplanes = _planes()
    cams = tcamera.orbit_cameras(4, 1.7, 30.0, 10.0)
    with torch.no_grad():
        full = tpipe.render_orbit(tplanes, cameras=cams,
                                  render_resolution=RES)
        part = tpipe.render_orbit(tplanes, cameras=cams,
                                  render_resolution=RES, frame_slice=(1, 3))
    assert full.shape[1] == 4 and part.shape[1] == 2
    torch.testing.assert_close(part, full[:, 1:3], atol=1e-6, rtol=0)

