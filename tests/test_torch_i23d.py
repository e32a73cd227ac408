"""The image→3D and multi-view→3D slices end to end, and the
GeneralConditioner: ``ln3diff_tpu_torch`` against ``ln3diff_tpu`` on toy
models.

The JAX side is built as ``bench.py`` ``_build_i23d_family`` /
``_build_mv23d_family`` build theirs (CLIP vision tokens and pooled
feature, DINO tokens, the flow-matching ODE with CFG 4.0), at toy sizes;
the port's is ``build_i23d_pipeline`` / ``build_mv23d_pipeline`` over the
same weights (carried by the bridge) and the same images (numpy, seeded).
The port gets JAX's start noise as ``x_init``.  The VAE's σ output bias is
shifted to put the σ = 10 iso-surface inside the grid, so the calls march
a real mesh.  Whole-slice tolerance: 1e-4 of each output's scale (the
text→3D slice's bar); the conditioning towers 1e-5.
"""

import dataclasses
import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.conditioning import clip as jclip
from ln3diff_tpu.conditioning import conditioner as jcond
from ln3diff_tpu.diffusion.transport import Transport as JTransport
from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.models import vit as jvit
from ln3diff_tpu.models.vae import TriplaneVAE as JVAE
from ln3diff_tpu.models.vae import TriplaneVAEConfig as JVAEConfig
from ln3diff_tpu.pipeline import SamplerSpec as JSamplerSpec
from ln3diff_tpu.pipeline import TextTo3DPipeline as JPipeline
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.conditioning import clip as tclip
from ln3diff_tpu_torch.conditioning import conditioner as tcond
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models import vit as tvit
from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
from ln3diff_tpu_torch.pipeline import (SamplerSpec, build_i23d_pipeline,
                                        build_mv23d_pipeline,
                                        build_t23d_pipeline)
from ln3diff_tpu_torch.render.renderer import RenderOptions

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

RES, HW, STEPS, GRID = 8, 28, 4, 20
OPTS = dict(depth_resolution=6, depth_resolution_importance=6,
            ray_start='auto', ray_end='auto', box_warp=0.9,
            filter_out_of_bbox=True, sampler_bbox_min=-0.45,
            sampler_bbox_max=0.45)
CLIP_KW = dict(image_size=HW, patch_size=14, hidden_size=32, num_layers=2,
               num_heads=2, intermediate_size=64)
TEXT_KW = dict(hidden_size=32, num_layers=1, num_heads=2,
               intermediate_size=64)
DINO_KW = dict(img_size=HW, patch_size=14, embed_dim=48, depth=2,
               num_heads=2, layerscale=True, exact_gelu=True)
D2_KW = dict(tokens_per_plane=16, hidden_size=32, depth=2, num_heads=2)
VAE_KW = dict(ldm_z_channels=4, latent_size=8, patch_size=2, conv_sr_ch=8,
              conv_sr_ch_mult=(1, 2), conv_sr_res_blocks=1,
              plane_channels=8, decoder_output_dim=8)
DEN_KW = {
    # bench: crossattn = CLIP tokens, vector = pooled, dino = DINO tokens
    'i23d': dict(variant='image-pixelart', context_dim=32,
                 pooled_vector_dim=32, dino_dim=48, t2i_final=True,
                 fused_attention=True),
    # bench: crossattn = the views' DINO tokens, flattened
    'mv23d': dict(variant='mv-pixelart', context_dim=48),
}
SIGMA_SHIFT = 10.3


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


def _perturbed(params, seed, scale=0.05):
    """flax zero-inits adaLN and the final layers, and sets layerscale
    to 1e-5: move every leaf so that each one shows in the output."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + scale * rng.standard_normal(p.shape))
        .astype(np.float32), params)


def _images(n, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, HW, HW, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _towers():
    """JAX CLIP vision and DINO towers (toy), their params and the port's
    copies."""
    jv = jclip.CLIPVisionModel(jclip.CLIPVisionConfig(**CLIP_KW))
    jd = jvit.VisionTransformer(jvit.ViTConfig(dtype=jnp.float32,
                                               **DINO_KW))
    zeros = jnp.zeros((1, HW, HW, 3))
    vv = {'params': _perturbed(jax.jit(jv.init)(
        jax.random.PRNGKey(3), zeros)['params'], 13, 0.1)}
    dv = {'params': _perturbed(jax.jit(jd.init)(
        jax.random.PRNGKey(4), zeros)['params'], 14, 0.1)}
    tv = tclip.CLIPVisionModel(tclip.CLIPVisionConfig(**CLIP_KW))
    tv.load_state_dict(bridge.clip_vision_state_dict(vv))
    td = tvit.VisionTransformer(tvit.ViTConfig(dtype=torch.float32,
                                               **DINO_KW))
    td.load_state_dict(bridge.vit_state_dict(dv))
    return dict(jv=jv, jd=jd, vv=vv, dv=dv, tv=tv.eval(), td=td.eval())


@functools.lru_cache(maxsize=None)
def _family(name):
    """Both pipelines of one family and both encoders."""
    tw = _towers()
    den_kw = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
                  depth=2, num_heads=2, exact_gelu=False, **DEN_KW[name])
    jden = jdit.DiT_TriLatent(jdit.DiTConfig(dtype=jnp.float32, **den_kw))
    if name == 'i23d':
        ctx0 = {'crossattn': jnp.zeros((2, 5, 32)),
                'vector': jnp.zeros((2, 32)), 'dino': jnp.zeros((2, 5, 48))}
    else:
        ctx0 = {'crossattn': jnp.zeros((2, 4 * 5, 48))}
    den_v = jax.jit(jden.init)(jax.random.PRNGKey(0),
                               jnp.zeros((2, 8, 8, 12)), jnp.zeros((2,)),
                               ctx0)
    den_v = {'params': _perturbed(den_v['params'], 10),
             'constants': den_v['constants']}
    jvae = JVAE(JVAEConfig(encoder_ch=8, encoder_ch_mult=(1, 2),
                           img_resolution=32, num_views=2,
                           dit2=jdit.DiT2Config(dtype=jnp.float32, **D2_KW),
                           dtype=jnp.float32, **VAE_KW))
    opts = JOpts(**OPTS)
    vae_v = jax.jit(lambda k: jvae.init(
        k, jnp.zeros((1, 8, 8, 12)), jnp.zeros((1, 25)), opts, 4,
        method=jvae.init_decoder_paths))(jax.random.PRNGKey(1))
    vae_v = {'params': _perturbed(vae_v['params'], 11)}
    vae_v['params']['osg_decoder']['EqualDense_1']['bias'][0] += SIGMA_SHIFT

    jpipe = JPipeline(
        lambda p, x, t, c: jden.apply(p, x, t, c), den_v,
        lambda p, lat: jvae.apply(p, lat, method=jvae.decode_latent), vae_v,
        lambda p, planes, cam: jvae.apply(
            p, planes, cam, opts, RES, None, use_fused_osg=True,
            method=jvae.render)['image_raw'],
        lambda p, planes, coords: jvae.apply(
            p, planes, coords, opts.box_warp, use_fused_osg=True,
            method=jvae.query_points),
        sampler=JSamplerSpec(kind='flow_matching', num_steps=STEPS,
                             cfg_scale=4.0, latent_shape=(8, 8, 12)),
        transport=JTransport())

    tden = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32, **den_kw))
    tden.load_state_dict(bridge.dit_state_dict(den_v))
    vae_cfg = TriplaneVAEConfig(
        dit2=tdit.DiT2Config(dtype=torch.float32, **D2_KW),
        dtype=torch.float32, **VAE_KW)
    tvae = TriplaneVAE(vae_cfg)
    tvae.load_state_dict(bridge.vae_state_dict(vae_v))
    kw = dict(den_cfg=tden.cfg, vae_cfg=vae_cfg,
              render_opts=RenderOptions(**OPTS), render_resolution=RES,
              sampler=SamplerSpec(num_steps=STEPS, cfg_scale=4.0,
                                  latent_shape=(8, 8, 12)),
              render_dtype=None)
    if name == 'i23d':
        tpipe, tencode, _ = build_i23d_pipeline(
            'cpu', modules=dict(denoiser=tden, vae=tvae,
                                vision_model=tw['tv'], dino=tw['td']),
            vision_cfg=tw['tv'].cfg, dino_cfg=tw['td'].cfg, **kw)

        @jax.jit
        def jencode(img):
            # bench.py _build_i23d_family's encode
            enc = tw['jv'].apply(tw['vv'], img)
            cond = {'crossattn': enc['tokens'][:, :, :1024],
                    'vector': enc['pooler_output'][:, :768],
                    'dino': tw['jd'].apply(tw['dv'], img)[:, :257]}
            return cond, {k: jnp.zeros_like(v) for k, v in cond.items()}
    else:
        tpipe, tencode, _ = build_mv23d_pipeline(
            'cpu', modules=dict(denoiser=tden, vae=tvae, dino=tw['td']),
            dino_cfg=tw['td'].cfg, **kw)

        @jax.jit
        def jencode(imgs):
            # bench.py _build_mv23d_family's encode
            tok = tw['jd'].apply(tw['dv'], imgs)[:, :257]
            flat = tok.reshape(1, -1, tok.shape[-1])
            return {'crossattn': flat}, {'crossattn': jnp.zeros_like(flat)}
    return jpipe, jencode, tpipe, tencode


def _read_obj(path):
    lines = Path(path).read_text().splitlines()
    v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines
                  if ln.startswith('v ')]).reshape(-1, 6)
    f = np.array([[int(x) for x in ln.split()[1:]] for ln in lines
                  if ln.startswith('f ')], np.int64).reshape(-1, 3)
    return v, f


@pytest.mark.parametrize('name', ['i23d', 'mv23d'])
def test_call_with_mesh_matches_jax(name, tmp_path):
    """Images → conditioning → the FM ODE with CFG 4.0 → planes → orbit
    frames and the mesh, JAX's ``__call__(..., mesh_path=...)`` against the
    port's.  The conditioning to 1e-5 of scale; latents, planes and frames
    to 1e-4; the smoothed f16 σ grids to the σ-grid tests' tolerance (6e-3
    relative); the port's mesh is the march of its own σ grid, the port's
    march of JAX's σ grid gives JAX's triangles exactly, and the OBJ
    written parses back to the returned mesh."""
    jpipe, jencode, tpipe, tencode = _family(name)
    imgs = _images(1 if name == 'i23d' else 4, seed=5)
    jc, ju = jencode(jnp.asarray(imgs))
    tc, tu = tencode(torch.from_numpy(imgs))
    assert set(tc) == set(jc) and set(tu) == set(ju)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        _close(tc[k], jc[k], rel=1e-5)
        assert not tu[k].any()

    key = jax.random.PRNGKey(3)
    jpath, tpath = str(tmp_path / 'jax.obj'), str(tmp_path / 'port.obj')
    want = jpipe(key, jc, ju, num_frames=3, render_resolution=RES,
                 mesh_path=jpath, mesh_grid=GRID)
    # the FM sampler draws its start from JAX's k_sample, unsplit
    k_sample, _ = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.normal(k_sample,
                                                        (1, 8, 8, 12))))
    got = tpipe(tc, tu, num_frames=3, render_resolution=RES, x_init=noise,
                mesh_path=tpath, mesh_grid=GRID)
    assert got['video'].shape == (1, 3, RES, RES, 3)
    for k in ('latents', 'planes', 'video'):
        _close(got[k], want[k])

    from ln3diff_tpu.render.mesh import march_grid as jmarch
    from ln3diff_tpu_torch.render.mesh import march_grid, rotate_x
    jsig = np.asarray(jpipe.dispatch_mesh_sigma(want['planes'], GRID,
                                                smooth=True), np.float32)
    tsig = tpipe.dispatch_mesh_sigma(got['planes'], GRID, smooth=True)
    np.testing.assert_allclose(tsig.float().numpy(), jsig, rtol=6e-3,
                               atol=1e-3)
    assert (jsig > 10).any() and (jsig < 10).any()
    verts, faces = got['mesh']
    mv, mf = march_grid(tsig.numpy(), GRID)
    assert len(faces) > 0
    np.testing.assert_array_equal(verts, rotate_x(mv, -90.0))
    np.testing.assert_array_equal(faces, mf)
    jv, jf = jmarch(jsig, GRID)
    tv, tf = march_grid(jsig, GRID)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    v, f = _read_obj(tpath)
    np.testing.assert_allclose(v[:, :3], verts, atol=1e-6)
    np.testing.assert_array_equal(f - 1, faces)


def test_cfg_one_runs_conditional_half_only():
    """Flow matching at cfg 1.0 runs the conditional half alone: equal to
    JAX's shortcut, and to a doubled batch whose uncond is cond."""
    jpipe, jencode, tpipe, tencode = _family('mv23d')
    imgs = _images(4, seed=6)
    jc, ju = jencode(jnp.asarray(imgs))
    tc, tu = tencode(torch.from_numpy(imgs))
    k_sample = jax.random.PRNGKey(8)
    noise = torch.from_numpy(np.array(jax.random.normal(k_sample,
                                                        (1, 8, 8, 12))))
    one = dataclasses.replace(jpipe.spec, cfg_scale=1.0)
    jone = JPipeline(jpipe.denoiser_fn, jpipe.denoiser_params, None, None,
                     None, None, sampler=one, transport=JTransport())
    want = jone.sample_latents(k_sample, 1, jc, ju)
    spec = tpipe.spec
    try:
        tpipe.spec = dataclasses.replace(spec, cfg_scale=1.0)
        single = tpipe.sample_latents(1, tc, tu, x_init=noise)
        tpipe.spec = dataclasses.replace(spec, cfg_scale=3.0)
        double = tpipe.sample_latents(1, tc, tc, x_init=noise)
    finally:
        tpipe.spec = spec
    _close(single, want)
    torch.testing.assert_close(single, double, atol=2e-5, rtol=1e-5)


def test_sampler_kinds():
    """The default kind is JAX's flow matching; DDIM, PLMS and DPM need a
    diffusion; an unknown kind raises; ``build_t23d_pipeline`` takes the
    DDPM-family kinds only, so no caller of it changes sampler by
    default."""
    assert SamplerSpec().kind == JSamplerSpec().kind == 'flow_matching'
    with pytest.raises(ValueError, match='DDIM'):
        build_t23d_pipeline('cpu', sampler=SamplerSpec())
    _, _, tpipe, tencode = _family('mv23d')
    tc, tu = tencode(torch.from_numpy(_images(4, seed=7)))
    spec = tpipe.spec
    try:
        for kind, err in (('ddim', ValueError), ('dpm', ValueError),
                          ('plms', ValueError),
                          ('edm', NotImplementedError)):
            tpipe.spec = dataclasses.replace(spec, kind=kind)
            with pytest.raises(err):
                tpipe.sample_latents(1, tc, tu)
    finally:
        tpipe.spec = spec


@pytest.fixture
def small_default_towers(monkeypatch):
    """The JAX embedders build their towers with the default (full-size)
    configs; give them the toy configs of the params under test (after
    the toy towers themselves are built)."""
    _towers()
    monkeypatch.setattr(jclip, 'CLIPVisionModel', functools.partial(
        jclip.CLIPVisionModel, jclip.CLIPVisionConfig(**CLIP_KW)))
    monkeypatch.setattr(jclip, 'CLIPTextModel', functools.partial(
        jclip.CLIPTextModel, jclip.CLIPTextConfig(**TEXT_KW)))



def _embedders(side, text):
    tw = _towers()
    if side == 'jax':
        tok = jclip.SimpleCLIPTokenizer()
        return [jcond.make_clip_text_embedder(text, tokenizer=tok,
                                              ucg_rate=0.5),
                jcond.make_clip_image_embedder(tw['vv'], ucg_rate=0.5),
                jcond.make_dino_embedder(tw['dv'], tw['jd'], ucg_rate=0.3)]
    tok = tclip.SimpleCLIPTokenizer()
    return [tcond.make_clip_text_embedder(text, tokenizer=tok, ucg_rate=0.5),
            tcond.make_clip_image_embedder(tw['tv'], ucg_rate=0.5),
            tcond.make_dino_embedder(tw['td'], ucg_rate=0.3)]


def test_general_conditioner_matches_jax(small_default_towers):
    """A batch of captions and images through the text, CLIP image and
    DINO embedders: the same context dicts as JAX's (token keys joined on
    the token axis, 'vector' on the channel axis), with the same ucg drops
    from one numpy seed, and the same (c, uc) pair."""
    jtext = jclip.CLIPTextModel()
    text_v = {'params': _perturbed(jax.jit(jtext.init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 77), jnp.int32))['params'],
        15, 0.1)}
    ttext = tclip.CLIPTextModel(tclip.CLIPTextConfig(**TEXT_KW))
    ttext.load_state_dict(bridge.clip_text_state_dict(text_v))
    jc = jcond.GeneralConditioner(_embedders('jax', text_v))
    tc = tcond.GeneralConditioner(_embedders('torch', ttext.eval()))
    imgs = _images(6, seed=9)
    batch = {'caption': ['a chair', 'a red car', '', 'two lamps', 'x',
                         'a dog'], 'img': imgs}
    tbatch = dict(batch, img=torch.from_numpy(imgs))
    for rng_seed in (None, 3):
        jrng = None if rng_seed is None else np.random.default_rng(rng_seed)
        trng = None if rng_seed is None else np.random.default_rng(rng_seed)
        want, got = jc(batch, rng=jrng), tc(tbatch, rng=trng)
        assert set(got) == set(want) == {'crossattn', 'vector', 'dino'}
        assert tuple(got['crossattn'].shape) == (6, 77 + 5, 32)
        assert tuple(got['vector'].shape) == (6, 64)
        for k in want:
            _close(got[k], want[k], rel=1e-5)
    # the seed drops some samples and keeps others
    dropped = tc(tbatch, rng=np.random.default_rng(3))['dino']
    kept = tc(tbatch)['dino']
    rows = [bool(torch.equal(dropped[i], kept[i])) for i in range(6)]
    assert any(rows) and not all(rows)
    jpair = jc.get_unconditional_conditioning(batch)
    tpair = tc.get_unconditional_conditioning(tbatch)
    for g, w in zip(tpair, jpair):
        assert set(g) == set(w)
        for k in w:
            _close(g[k], w[k], rel=1e-5)
    juc, tuc = jc(batch, force_uncond=True), tc(tbatch, force_uncond=True)
    for k in juc:
        _close(tuc[k], juc[k], rel=1e-5)


def test_dino_mv_embedder_matches_jax():
    tw = _towers()
    views = np.random.default_rng(10).uniform(
        -1, 1, (2, 5, HW, HW, 3)).astype(np.float32)
    je = jcond.make_dino_mv_embedder(tw['dv'], tw['jd'], n_cond_frames=4)
    te = tcond.make_dino_mv_embedder(tw['td'], n_cond_frames=4)
    want, got = je.encode(views), te.encode(torch.from_numpy(views))
    assert tuple(got['dino'].shape) == (2, 4 * 5, 48)
    _close(got['dino'], want['dino'], rel=1e-5)
    ju, tu = je.uncond(3), te.uncond(3)
    assert tuple(tu['dino'].shape) == ju['dino'].shape
    assert not tu['dino'].any()
