"""DPM-Solver++ and PLMS for the U-Net families: the ShapeNet text→3D
call of the port (``build_shapenet_pipeline`` with ``kind='dpm'``, 4
solver steps over the unspaced 1000-step schedule, and ``kind='plms'``,
4 steps over ``ddim4``; v-prediction with the mixing logit, CFG 1.0)
against JAX's ``TextTo3DPipeline`` built as JAX's sample script builds
any ``--objective`` over the LSGM U-Net
(``scripts/vit_triplane_diffusion_sample.py:201-220``), on the toy models
and bridged weights of ``tests/test_torch_unet_families.py`` and JAX's
start noise fed in as ``x_init``: latents, planes and frames within 1e-4
of scale, f32 on the CPU, at batch 1 and 2; the denoiser runs steps + 1
times.  Flow matching stays refused for the U-Net.  The port's sample
CLI with ``--objective dpm`` and ``plms`` on the U-Net route gives the
latents of ``build_shapenet_pipeline`` on the CLI's own modules, bit
for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ln3diff_tpu.diffusion.gaussian import make_diffusion
from ln3diff_tpu.pipeline import SamplerSpec as JSamplerSpec
from ln3diff_tpu.pipeline import TextTo3DPipeline as JPipeline
from ln3diff_tpu_torch.conditioning import clip as tclip
from ln3diff_tpu_torch.config import CAMERA_PRESETS
from ln3diff_tpu_torch.pipeline import SamplerSpec, build_shapenet_pipeline
from ln3diff_tpu_torch.render.camera import orbit_cameras
from ln3diff_tpu_torch.render.renderer import RenderOptions
from ln3diff_tpu_torch.scripts import vit_triplane_diffusion_sample as tsample
from test_torch_pipeline import _salt_free_ids
from test_torch_unet_families import (FAMILIES, OPTS, RES, STEPS, TEXT_KW,
                                      _close, _family)

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _pipelines(kind):
    """JAX's and the port's toy ShapeNet pipelines for ``kind`` on the
    weights of ``_family('shapenet')``."""
    jbase, tbase, jctx, tctx, hw = _family('shapenet')
    fam = FAMILIES['shapenet']
    latent = (hw, hw, 12)
    jpipe = JPipeline(
        jbase.denoiser_fn, jbase.denoiser_params, jbase.decode_fn,
        jbase.vae_params, jbase.render_fn, jbase.point_decoder_fn,
        sampler=JSamplerSpec(kind=kind, num_steps=STEPS, cfg_scale=1.0,
                             triplane_scaling_divider=1.0,
                             latent_shape=latent),
        diffusion=make_diffusion(
            steps=1000, mean_type='v', mixed_prediction=True,
            timestep_respacing=None if kind == 'dpm' else f'ddim{STEPS}'),
        mixing_logit=jbase.mixing_logit)
    den = tbase.denoiser_fn
    vae = tbase.decode_fn.__self__
    text_cfg = tclip.CLIPTextConfig(**TEXT_KW)
    tpipe, _, _ = build_shapenet_pipeline(
        'cpu', modules=dict(denoiser=den, vae=vae,
                            text_model=tclip.CLIPTextModel(text_cfg)),
        den_cfg=den.cfg, vae_cfg=vae.cfg, text_cfg=text_cfg,
        render_opts=RenderOptions(**OPTS, **fam['opts']),
        render_resolution=RES, render_dtype=None,
        sampler=SamplerSpec(kind=kind, num_steps=STEPS, cfg_scale=1.0,
                            triplane_scaling_divider=1.0,
                            latent_shape=latent))
    return jpipe, tpipe, jctx, tctx, hw


def _start(key, kind, shape):
    """The start noise of JAX's ``__call__(key, ...)`` for ``kind``: DDIM
    and PLMS split ``k_sample`` once more, DPM draws from it as it is."""
    k_sample = jax.random.split(key)[0]
    if kind != 'dpm':
        k_sample = jax.random.split(k_sample)[1]
    return torch.from_numpy(np.array(jax.random.normal(k_sample, shape)))


@pytest.mark.parametrize('batch', [1, 2])
@pytest.mark.parametrize('kind', ['dpm', 'plms'])
def test_shapenet_call_matches_jax(kind, batch):
    jpipe, tpipe, jctx, tctx, hw = _pipelines(kind)
    assert tpipe.diffusion.num_timesteps == (1000 if kind == 'dpm'
                                             else STEPS)
    assert tpipe.mixing_logit is not None
    calls = []
    den = tpipe.denoiser_fn
    tpipe.denoiser_fn = lambda *a: calls.append(1) or den(*a)
    cams = orbit_cameras(2, **CAMERA_PRESETS['shapenet'])
    key = jax.random.PRNGKey(11 + batch)
    want = jpipe(key, *jctx, batch=batch, cameras=jnp.asarray(cams))
    got = tpipe(*tctx, batch=batch, cameras=cams, render_resolution=RES,
                x_init=_start(key, kind, (batch, hw, hw, 12)))
    assert len(calls) == STEPS + 1
    sr = FAMILIES['shapenet']['sr']
    assert got['video'].shape == (batch, 2, sr, sr, 3)
    for k in ('latents', 'planes', 'video'):
        _close(got[k], want[k])


def test_flow_matching_stays_refused():
    with pytest.raises(ValueError, match='DDPM-family'):
        _pipelines('flow_matching')


def _cli_cfgs():
    """The toy U-Net, ShapeNet VAE and CLIP text configs of the families
    test, as the sample CLI's ``model_configs`` would give them."""
    _, tbase, _, _, _ = _family('shapenet')
    return (tbase.denoiser_fn.cfg, tbase.decode_fn.__self__.cfg,
            tclip.CLIPTextConfig(**TEXT_KW))


class _SaltFree:
    def __call__(self, texts):
        return np.stack([_salt_free_ids(t)[0] for t in texts])


@pytest.mark.parametrize('kind', ['dpm', 'plms'])
def test_sample_cli_unet_route(kind, monkeypatch, tmp_path):
    from ln3diff_tpu_torch import config as tconfig
    den_cfg, vae_cfg, text_cfg = _cli_cfgs()
    hw = vae_cfg.latent_size
    noise = torch.randn((1, hw, hw, 12),
                        generator=torch.Generator().manual_seed(5))
    monkeypatch.setattr(tsample, 'model_configs',
                        lambda args: (den_cfg, vae_cfg, text_cfg))
    monkeypatch.setattr(tsample, 'start_noise',
                        lambda shape, gen, device: noise.clone())
    monkeypatch.setattr(tclip, 'default_tokenizer',
                        lambda *a, **k: _SaltFree())
    opts = RenderOptions(**OPTS, **FAMILIES['shapenet']['opts'])
    preset = 'shapenet_tuneray_aug_resolution_64_64_nearestSR'
    monkeypatch.setitem(tconfig.RENDER_PRESETS, preset, opts)
    prompt = 'a red sports car'
    res = tsample.main([
        '--prompts', prompt, '--outdir', str(tmp_path), '--vae', 'shapenet',
        '--objective', kind, '--num_steps', str(STEPS),
        '--unconditional_guidance_scale', '1.0', '--num_frames', '2',
        '--render_resolution', str(RES), '--export_mesh', 'false',
        '--video_format', 'png', '--device', 'cpu'])
    out = res['outputs'][0]
    mods = res['modules']
    assert out['video'].shape == (2, RES, RES, 3)
    assert np.isfinite(out['video']).all()

    pipe, _, _ = build_shapenet_pipeline(
        'cpu', modules=mods, den_cfg=den_cfg, vae_cfg=vae_cfg,
        text_cfg=text_cfg, render_opts=opts, render_resolution=RES,
        render_dtype=None, render_key='image_raw',
        sampler=SamplerSpec(kind=kind, num_steps=STEPS, cfg_scale=1.0,
                            latent_shape=(hw, hw, 12)))
    assert pipe.diffusion.num_timesteps == (1000 if kind == 'dpm'
                                            else STEPS)
    ids = torch.as_tensor(_SaltFree()([prompt, '']))
    with torch.no_grad():
        ctx = mods['text_model'](ids)['last_hidden_state']
    want = pipe.sample_latents(1, {'crossattn': ctx[:1]},
                               {'crossattn': ctx[1:]}, x_init=noise)
    assert torch.equal(out['latents'], want)
