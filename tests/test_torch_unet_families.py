"""The ShapeNet and FFHQ text→3D calls of the port against JAX's
bench-style pipelines (``bench.py`` ``_build_unet_family``) on toy
models: pooled CLIP text with ``text_projection`` (L2-normalised × 18.4
or × 1.0) → the U-Net LSGM (v-prediction and the mixing logit) under 4
DDIM steps, CFG 1.0 (the conditional half only) or 6.5 → the ShapeNet or
FFHQ VAE decode → the ``image_sr`` frames of an explicit 2-camera ring
(``NearestConvSR`` to 16², ``SuperresolutionHybrid8XDC`` to 512²).

Both sides load the same weights (drawn in the shapes of JAX's init,
through ``bridge.py``), get the same token ids (a salt-free digest) and JAX's
start noise as ``x_init``, in f32 on the CPU, at batch 1 and 2.
Latents, planes and frames are held within 1e-4 of scale, and so is
ShapeNet's toy σ grid (the f32 point query on the 192³ grid's points at
toy size).  The 8XDC head has fixed widths, so the FFHQ frames cost full
SR compute: the head runs twice here, once per batch."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.conditioning import clip as jclip
from ln3diff_tpu.diffusion.gaussian import make_diffusion
from ln3diff_tpu.models import unet as junet
from ln3diff_tpu.models import vae_shapenet as jvs
from ln3diff_tpu.models import vit as jvit
from ln3diff_tpu.pipeline import SamplerSpec as JSamplerSpec
from ln3diff_tpu.pipeline import TextTo3DPipeline as JPipeline
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.conditioning import clip as tclip
from ln3diff_tpu_torch.config import CAMERA_PRESETS
from ln3diff_tpu_torch.models import unet as tunet
from ln3diff_tpu_torch.models import vae_shapenet as tvs
from ln3diff_tpu_torch.models import vit as tvit
from ln3diff_tpu_torch.pipeline import (SamplerSpec, build_ffhq_pipeline,
                                        build_shapenet_pipeline)
from ln3diff_tpu_torch.render.camera import orbit_cameras
from ln3diff_tpu_torch.render.mesh import grid_points
from ln3diff_tpu_torch.render.renderer import RenderOptions
from test_torch_pipeline import _jax_noise, _salt_free_ids

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-4
RES, STEPS = 8, 4
TEXT_KW = dict(hidden_size=32, num_layers=2, num_heads=2,
               intermediate_size=64, with_projection=True)
UNET_KW = dict(in_channels=4, model_channels=16, out_channels=4,
               num_res_blocks=1, attention_resolutions=(2,),
               channel_mult=(1, 2), num_heads=2, context_dim=32,
               use_spatial_transformer=True, roll_out=True,
               mixed_prediction=True)
VAE_KW = dict(decoder_embed_dim=32, decoder_num_heads=2,
              channel_multiplier=2, plane_channels=8, triplane_resolution=32,
              decoder_output_dim=8)
FAMILIES = {
    'shapenet': dict(
        build=build_shapenet_pipeline, cfg_scale=1.0, clip_scale=18.4,
        jvae=jvs.ShapeNetVAE, jcfg=jvs.ShapeNetVAEConfig,
        tcfg=tvs.ShapeNetVAEConfig, sr=16,
        vae=dict(token_size=2, vae_p=2, decoder_fusion_depth=4),
        opts=dict(ray_start=0.6, ray_end=1.8, box_warp=1.2, white_back=True)),
    'ffhq': dict(
        build=build_ffhq_pipeline, cfg_scale=6.5, clip_scale=1.0,
        jvae=jvs.FFHQVAE, jcfg=jvs.FFHQVAEConfig, tcfg=tvs.FFHQVAEConfig,
        sr=512, vae=dict(token_size=4, decoder_fusion_depth=2),
        opts=dict(ray_start=2.25, ray_end=3.3, box_warp=1.0,
                  white_back=False)),
}
OPTS = dict(depth_resolution=4, depth_resolution_importance=4)


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


def _params(init, *args, seed):
    """Parameters of the shapes that ``init`` creates, drawn with numpy
    (no compile of the init): kernels ~ N(0, 1/fan_in), StyleGAN's raw
    weights and noise ~ N(0, 1), norm scales 1 ± 0.1, everything else
    (biases, layerscale gains, sin-cos tables, ``sr_ws``, the mixing
    logit) ~ N(0, 0.1²) — a mixing logit near 0 weighs the U-Net's
    prediction and the analytic one alike."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)['params']
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape)
        if name == 'kernel':
            x = x / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == 'scale':
            x = 1.0 + 0.1 * x
        elif name not in ('weight', 'noise_const'):
            x = 0.1 * x
        return x.astype(np.float32)

    return {'params': jax.tree_util.tree_map_with_path(draw, shapes)}


def _enc(registry):
    return registry('dinov2-s/14', img_size=28, embed_dim=32, depth=2,
                    num_heads=2)


@functools.lru_cache(maxsize=None)
def _family(name, quantized=False):
    """JAX's and the port's toy pipelines of family ``name`` on the same
    weights; with ``quantized`` both U-Nets are the int8 twins (JAX's
    ``quantize_unet``, the port's strict load of the bridge's copy)."""
    fam = FAMILIES[name]
    jden = junet.UNetModel(junet.UNetConfig(dtype=jnp.float32, **UNET_KW))
    jvae = fam['jvae'](fam['jcfg'](encoder_vit=_enc(jvit.vit_registry),
                                   **VAE_KW, **fam['vae']))
    jtext = jclip.CLIPTextModel(jclip.CLIPTextConfig(**TEXT_KW))
    hw = jvae.cfg.latent_size
    jopts = JOpts(**OPTS, **fam['opts'])
    den_v = _params(jden.init, jnp.zeros((2, hw, hw, 12)), jnp.zeros((2,)),
                    jnp.zeros((2, 1, 32)), seed=3)
    vae_v = _params(lambda k, *a: jvae.init(
        k, *a, jopts, RES, method=jvae.init_decoder_paths),
        jnp.zeros((1, hw, hw, 12)), jnp.zeros((1, 25)), seed=4)
    text_v = _params(jtext.init, jnp.zeros((1, 77), jnp.int32), seed=5)
    if quantized:
        from ln3diff_tpu.ops.int8 import quantize_unet
        jden, den_v = quantize_unet(
            jden.cfg, den_v, jnp.zeros((2, hw, hw, 12)), jnp.zeros((2,)),
            jnp.zeros((2, 1, 32)))
        den_v = jax.tree_util.tree_map(np.asarray, den_v)

    jpipe = JPipeline(
        lambda p, x, t, c: jden.apply(p, x, t, c['crossattn']), den_v,
        lambda p, lat: jvae.apply(p, lat, method=jvae.decode_latent), vae_v,
        lambda p, planes, cam: jvae.apply(
            p, planes, cam, jopts, RES, None, use_fused_osg=True,
            method=jvae.render)['image_sr'],
        lambda p, planes, coords: jvae.apply(
            p, planes, coords, jopts.box_warp, use_fused_osg=True,
            method=jvae.query_points),
        sampler=JSamplerSpec(kind='ddim', num_steps=STEPS,
                             cfg_scale=fam['cfg_scale'],
                             triplane_scaling_divider=1.0,
                             latent_shape=(hw, hw, 12)),
        diffusion=make_diffusion(steps=1000, mean_type='v',
                                 mixed_prediction=True,
                                 timestep_respacing=f'ddim{STEPS}'),
        mixing_logit=den_v['params']['mixing_logit'])

    den_cfg = tunet.UNetConfig(dtype=torch.float32, quantized=quantized,
                               **UNET_KW)
    vae_cfg = fam['tcfg'](encoder_vit=_enc(tvit.vit_registry), **VAE_KW,
                          **fam['vae'])
    text_cfg = tclip.CLIPTextConfig(**TEXT_KW)
    tden = tunet.UNetModel(den_cfg)
    tvae = getattr(tvs, fam['jvae'].__name__)(vae_cfg)
    ttext = tclip.CLIPTextModel(text_cfg)
    tden.load_state_dict(bridge.unet_state_dict(den_v))
    tvae.load_state_dict(bridge.vae_state_dict(vae_v))
    ttext.load_state_dict(bridge.clip_text_state_dict(text_v))
    tpipe, _, _ = fam['build'](
        'cpu', modules=dict(denoiser=tden, vae=tvae, text_model=ttext),
        den_cfg=den_cfg, vae_cfg=vae_cfg, text_cfg=text_cfg,
        render_opts=RenderOptions(**OPTS, **fam['opts']),
        render_resolution=RES, render_dtype=None,
        sampler=SamplerSpec(kind='ddim', num_steps=STEPS,
                            cfg_scale=fam['cfg_scale'],
                            triplane_scaling_divider=1.0,
                            latent_shape=(hw, hw, 12)))

    ids = _salt_free_ids('a red sports car')
    jboth = jclip.pooled_text_context(
        jtext.apply(text_v, jnp.asarray(ids))['text_embeds'],
        scale_clip_encoding=fam['clip_scale'])
    with torch.no_grad():
        tboth = tclip.pooled_text_context(
            ttext(torch.from_numpy(ids))['text_embeds'],
            scale_clip_encoding=fam['clip_scale'])
    _close(tboth, jboth)
    jctx = ({'crossattn': jboth[:1]}, {'crossattn': jboth[1:]})
    tctx = ({'crossattn': tboth[:1]}, {'crossattn': tboth[1:]})
    return jpipe, tpipe, jctx, tctx, hw


@pytest.mark.parametrize('batch', [1, 2])
@pytest.mark.parametrize('family', ['shapenet', 'ffhq'])
def test_family_call_matches_jax(family, batch):
    jpipe, tpipe, jctx, tctx, hw = _family(family)
    cams = orbit_cameras(2, **CAMERA_PRESETS[family])
    key = jax.random.PRNGKey(7 + batch)
    want = jpipe(key, *jctx, batch=batch, cameras=jnp.asarray(cams))
    noise = torch.from_numpy(np.array(_jax_noise(key, (batch, hw, hw, 12))))
    got = tpipe(*tctx, batch=batch, cameras=cams, render_resolution=RES,
                x_init=noise)
    sr = FAMILIES[family]['sr']
    assert got['latents'].shape == (batch, hw, hw, 12)
    assert got['planes'].shape == (batch, 3, 32, 32, 8)
    assert got['video'].shape == (batch, 2, sr, sr, 3)
    for key_ in ('latents', 'planes', 'video'):
        _close(got[key_], want[key_])


def test_shapenet_sigma_grid_matches_jax():
    """The point query on the σ grid's points (a 12³ grid over ±0.45)
    from the decoded planes of one shared latent, f32 through the fused
    route's plain version on both sides."""
    jpipe, tpipe, _, _, hw = _family('shapenet')
    latent = np.random.default_rng(8).standard_normal(
        (1, hw, hw, 12)).astype(np.float32)
    jplanes = jax.jit(jpipe.decode_fn)(jpipe.vae_params,
                                       jnp.asarray(latent))
    with torch.no_grad():
        tplanes = tpipe.decode_fn(torch.from_numpy(latent))
    _close(tplanes, jplanes)
    pts = grid_points(12, 0.45)[None]
    _, want = jax.jit(jpipe.point_decoder_fn)(jpipe.vae_params, jplanes,
                                              jnp.asarray(pts.numpy()))
    with torch.no_grad():
        _, got = tpipe.point_decoder_fn(torch.from_numpy(np.array(jplanes)),
                                        pts)
    assert got.shape == (1, 12**3, 1)
    _close(got, want)


def test_presets_match_jax():
    """The port's copies of the ShapeNet/FFHQ presets (and of the fg/bg
    FFHQ preset) equal JAX's field for field (dtypes aside), ``build_vae``
    picks the same classes, and the ``'stylegan'`` SR head and the
    background planes build."""
    import dataclasses
    from ln3diff_tpu import config as jconfig
    from ln3diff_tpu_torch import config as tconfig
    from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig

    def fields(cfg):
        return {f.name: (fields(getattr(cfg, f.name))
                         if dataclasses.is_dataclass(getattr(cfg, f.name))
                         else getattr(cfg, f.name))
                for f in dataclasses.fields(cfg) if f.name != 'dtype'}

    def common(want, got):
        return {k: common(v, got[k]) if isinstance(v, dict) else v
                for k, v in want.items() if k in got}

    for name in ('shapenet_tuneray_aug_resolution_64_64_nearestSR', 'ffhq'):
        got = dataclasses.asdict(tconfig.RENDER_PRESETS[name])
        want = dataclasses.asdict(jconfig.RENDER_PRESETS[name])
        assert got == {k: want[k] for k in got}
    for family in ('objaverse', 'shapenet', 'ffhq'):
        assert tconfig.CAMERA_PRESETS[family] == \
            jconfig.CAMERA_PRESETS[family]
    for family in ('shapenet', 'ffhq', 'ffhq-fgbg'):
        tcfg, jcfg = tconfig.vae_preset(family), jconfig.vae_preset(family)
        assert fields(tcfg) == common(fields(jcfg), fields(tcfg))
        assert type(tconfig.build_vae(tcfg)).__name__ == \
            type(jconfig.build_vae(jcfg)).__name__
    assert fields(tconfig.denoiser_preset('shapenet-unet')) == \
        fields(jconfig.denoiser_preset('shapenet-unet'))
    assert type(tconfig.build_vae(TriplaneVAEConfig())) is TriplaneVAE
    from ln3diff_tpu_torch.models.stylegan import SuperresolutionHybrid
    vae = TriplaneVAE(TriplaneVAEConfig(use_sr=True, sr_module='stylegan'))
    assert isinstance(vae.superresolution, SuperresolutionHybrid)
    vae = TriplaneVAE(TriplaneVAEConfig(use_background=True,
                                        plane_channels=64))
    assert vae.bg_decoder.EqualDense_0.weight.shape == (64, 32)


def test_unet_family_entry_points_need_a_card():
    """No silent CPU fallback: the builders ask for CUDA by default."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    for build in (build_shapenet_pipeline, build_ffhq_pipeline):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build()
