"""The port's checkpoint converters against the JAX package's.

Reference-named state dicts are written by ``_torch_reference_sd`` from
toy port modules (random draws, seeded).  Every ``convert_*`` of
``ln3diff_tpu_torch/conditioning/{convert,convert_ln3diff,lpips}.py`` is
held to the JAX function on the same dict: the same tree, the same
arrays bit for bit, the same dtypes — apart from the two leaves the JAX
converter leaves out although its own module has them (the PixArt
variants' shared ``adaLN_modulation``, the MV encoder's
``fusion_layer``; ``ROADMAP.md`` §3), each shown here.  Each kind is then
loaded strictly into the port's module through
``bridge.reference_state_dicts`` (or the kind's bridge function) and run
against the JAX module on the JAX-converted params: within 1e-5 of each
output's scale, f32 on both sides.  The file formats: ``.pt`` and
``.safetensors`` (held against ``safetensors.torch.load_file``, bf16 and
f16 kept) and ``split_joint_checkpoint``.
"""

import functools
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.conditioning import clip as jclip
from ln3diff_tpu.conditioning import convert as jconvert
from ln3diff_tpu.conditioning import convert_ln3diff as jconv
from ln3diff_tpu.conditioning import lpips as jlpips
from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.models import eg3d as jeg3d
from ln3diff_tpu.models import stylegan3 as jsg3
from ln3diff_tpu.models import unet as junet
from ln3diff_tpu.models import vae as jvae
from ln3diff_tpu.models import vae_shapenet as jvs
from ln3diff_tpu.models import vit as jvit
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.conditioning import clip as tclip
from ln3diff_tpu_torch.conditioning import convert as tconvert
from ln3diff_tpu_torch.conditioning import convert_ln3diff as tconv
from ln3diff_tpu_torch.conditioning import lpips as tlpips
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models import eg3d as teg3d
from ln3diff_tpu_torch.models import stylegan3 as tsg3
from ln3diff_tpu_torch.models import unet as tunet
from ln3diff_tpu_torch.models import vae as tvae
from ln3diff_tpu_torch.models import vae_shapenet as tvs
from ln3diff_tpu_torch.models import vit as tvit
from ln3diff_tpu_torch.training.checkpoint import load_state_dict_strict

sys.path.insert(0, os.path.dirname(__file__))
import _torch_reference_sd as R  # noqa: E402

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}{k}/'))
        return out
    return {prefix[:-1]: tree}


def _same_tree(got, want, extra=()):
    """``got`` is ``want`` leaf for leaf (keys, dtypes, bits), plus the
    leaves named in ``extra``, which ``want`` lacks."""
    if isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            _same_tree(g, w, extra)
        return
    g, w = _flat(got), _flat(want)
    assert sorted(set(g) - set(w)) == sorted(extra)
    assert sorted(set(w) - set(g)) == []
    for k, a in w.items():
        b = g[k]
        assert b.dtype == a.dtype and b.shape == a.shape, k
        assert np.array_equal(b, a), k


# -- toy modules and their reference dicts -----------------------------------

B = 2
DIT_KW = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
              depth=2, num_heads=2, exact_gelu=False)
DIT_VARIANTS = {
    'text': dict(context_dim=32),
    'pixelart-text': dict(context_dim=24, pooled_vector_dim=16,
                          t2i_final=True),
    'image-pixelart': dict(context_dim=24, pooled_vector_dim=16,
                           dino_dim=20, t2i_final=True),
    'image-pixelart-noclip': dict(dino_dim=20),
    'mv-pixelart': dict(context_dim=24),
}
DIT_CTX = {
    'text': dict(crossattn=(B, 7, 32)),
    'image-pixelart': dict(crossattn=(B, 5, 24), vector=(B, 16),
                           dino=(B, 9, 20)),
    'mv-pixelart': dict(concat=(B, 3, 5, 24)),
}
# the release's channel multipliers, which the convert CLI assumes
VAE_KW = dict(encoder_ch=8, encoder_ch_mult=(1, 2, 4, 4), img_resolution=32,
              num_views=2, ldm_z_channels=4, latent_size=8, patch_size=2,
              conv_sr_ch=8, conv_sr_ch_mult=(1, 2, 2, 4),
              conv_sr_res_blocks=1, plane_channels=8, decoder_output_dim=8)
D2_KW = dict(tokens_per_plane=16, hidden_size=32, depth=4, num_heads=2)
ENC = dict(embed_dim=32, depth=2, num_heads=2)
FUSION = {
    'shapenet': (28, dict(token_size=2, vae_p=2, decoder_embed_dim=32,
                          decoder_fusion_depth=4, decoder_num_heads=2,
                          channel_multiplier=2, plane_channels=8,
                          triplane_resolution=32, decoder_output_dim=8)),
    'ffhq': (56, dict(token_size=4, decoder_embed_dim=32,
                      decoder_fusion_depth=2, decoder_num_heads=2,
                      channel_multiplier=2, plane_channels=8,
                      triplane_resolution=32, decoder_output_dim=8)),
}
UNET_KW = dict(in_channels=4, model_channels=16, out_channels=4,
               num_res_blocks=1, attention_resolutions=(2,),
               channel_mult=(1, 2), num_heads=2,
               use_spatial_transformer=True, context_dim=16, roll_out=True,
               mixed_prediction=True)
GEN_KW = dict(z_dim=16, c_dim=25, w_dim=32, plane_resolution=16,
              plane_channels=8, decoder_output_dim=8)
SG3_KW = dict(w_dim=32, img_resolution=32, img_channels=3,
              channel_base=1024, channel_max=32, num_layers=6)
TEXT_KW = dict(hidden_size=32, num_layers=2, num_heads=2,
               intermediate_size=64)
VISION_KW = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
                 num_heads=2, intermediate_size=64)
DINO_KW = dict(img_size=28, patch_size=14, embed_dim=48, depth=2,
               num_heads=2, layerscale=True, exact_gelu=True)


def _dit_cfg(variant, dtype_mod, dtype):
    return dtype_mod.DiTConfig(dtype=dtype, variant=variant, **DIT_KW,
                               **DIT_VARIANTS[variant])


def _vae_cfg(mod, dtype):
    return mod.TriplaneVAEConfig(dit2=(tdit if mod is tvae else jdit)
                                 .DiT2Config(dtype=dtype, **D2_KW),
                                 dtype=dtype, **VAE_KW)


def _fusion_cfg(family, mods, dtype):
    img, kw = FUSION[family]
    vit, vs = mods
    cls = vs.FFHQVAEConfig if family == 'ffhq' else vs.ShapeNetVAEConfig
    return cls(encoder_vit=vit.vit_registry('dinov2-s/14', img_size=img,
                                            dtype=dtype, **ENC),
               dtype=dtype, **kw)


@functools.lru_cache(maxsize=None)
def _port(kind):
    """(port module, its drawn state dict, the reference dict) of a kind."""
    if kind.startswith('dit-'):
        m = tdit.DiT_TriLatent(_dit_cfg(kind[4:], tdit, torch.float32))
        sd = R.port_state_dict(m, 1)
        return m, sd, R.dit_reference(sd)
    if kind == 'vae-objaverse':
        m = tvae.TriplaneVAE(_vae_cfg(tvae, torch.float32), encoder=True)
        sd = R.port_state_dict(m, 2)
        return m, sd, R.vae_objaverse_reference(sd)
    if kind in ('vae-shapenet', 'vae-ffhq'):
        family = kind[4:]
        cfg = _fusion_cfg(family, (tvit, tvs), torch.float32)
        m = (tvs.FFHQVAE if family == 'ffhq' else tvs.ShapeNetVAE)(
            cfg, encoder=True)
        sd = R.port_state_dict(m, 3)
        # the FFHQ 8XDC head's noise strengths are drawn 0 at init
        ref = getattr(R, f'vae_{family}_reference')(sd)
        return m, sd, ref
    if kind == 'unet':
        m = tunet.UNetModel(tunet.UNetConfig(dtype=torch.float32, **UNET_KW))
        sd = R.port_state_dict(m, 4)
        sd['mixing_logit'] = torch.randn(sd['mixing_logit'].shape,
                                         generator=torch.Generator()
                                         .manual_seed(4))
        return m, sd, R.unet_reference(sd, m.cfg)
    if kind == 'eg3d':
        m = teg3d.TriPlaneGenerator(teg3d.TriPlaneGeneratorConfig(**GEN_KW))
        sd = R.port_state_dict(m, 5)
        sd['mapping.w_avg'] = torch.randn(32, generator=torch.Generator()
                                          .manual_seed(5))
        return m, sd, R.eg3d_reference(sd)
    if kind == 'sg3':
        m = tsg3.SynthesisNetworkSG3(**SG3_KW)
        sd = R.port_state_dict(m, 6)
        return m, sd, R.sg3_synthesis_reference(sd)
    if kind == 'clip-text':
        m = tclip.CLIPTextModel(tclip.CLIPTextConfig(with_projection=True,
                                                     **TEXT_KW))
        sd = R.port_state_dict(m, 7)
        return m, sd, R.clip_text_reference(sd)
    if kind == 'clip-vision':
        m = tclip.CLIPVisionModel(tclip.CLIPVisionConfig(**VISION_KW))
        sd = R.port_state_dict(m, 8)
        return m, sd, R.clip_vision_reference(sd)
    if kind in ('dinov2-hf', 'dinov2-hub'):
        m = tvit.VisionTransformer(tvit.ViTConfig(dtype=torch.float32,
                                                  **DINO_KW))
        sd = R.port_state_dict(m, 9)
        ref = (R.dinov2_hf_reference if kind == 'dinov2-hf'
               else R.dinov2_hub_reference)(sd)
        return m, sd, ref
    if kind == 'lpips':
        m = tlpips.LPIPS()
        sd = R.port_state_dict(m, 10)
        sd = {k: v.abs() + 0.1 if k.startswith('lin') else v
              for k, v in sd.items()}
        return m, sd, R.lpips_reference(sd)
    raise KeyError(kind)


def _ref(kind):
    return _port(kind)[2]


# -- every converter, bit for bit --------------------------------------------

SUP = 'decoder.superresolution.'
TRI = 'decoder.triplane_decoder.'
CASES = {
    # name: (function name, kind, args, kwargs, leaves only the port has)
    'linear': ('linear', 'clip-text',
               ('text_model.encoder.layers.0.mlp.fc1',), {}, ()),
    'conv2d': ('conv2d', 'vae-objaverse', ('encoder.conv_in',), {}, ()),
    'layer_norm': ('layer_norm', 'clip-text',
                   ('text_model.final_layer_norm',), {}, ()),
    'group_norm': ('group_norm', 'vae-objaverse', ('encoder.norm_out',), {},
                   ()),
    'embedding': ('embedding', 'clip-text',
                  ('text_model.embeddings.token_embedding',), {}, ()),
    'hf_clip_text': ('convert_hf_clip_text', 'clip-text', (),
                     dict(num_layers=2), ()),
    'hf_clip_vision': ('convert_hf_clip_vision', 'clip-vision', (),
                       dict(num_layers=2), ()),
    'hf_dinov2': ('convert_hf_dinov2', 'dinov2-hf', (), dict(depth=2), ()),
    'sd_encoder': ('convert_sd_encoder', 'vae-objaverse', (),
                   dict(prefix='encoder.', mv=True), ()),
    'sd_decoder': ('convert_sd_decoder', 'vae-objaverse', (),
                   dict(prefix=f'{SUP}conv_sr.'), ()),
    'osg_decoder': ('convert_osg_decoder', 'vae-objaverse', (),
                    dict(prefix=f'{TRI}decoder.net'), ()),
    'quant_conv': ('convert_quant_conv', 'vae-objaverse', (),
                   dict(prefix=f'{SUP}quant_conv'), ()),
    'patch_embed_triplane': ('convert_patch_embed_triplane', 'vae-objaverse',
                             (), dict(prefix=f'{SUP}ldm_upsample'), ()),
    'dit2': ('convert_dit2', 'vae-objaverse', (),
             dict(depth=4, prefix='decoder.vit_decoder.'), ()),
    'vae_objaverse': ('convert_vae_objaverse', 'vae-objaverse', (),
                      dict(dit2_depth=4),
                      ('encoder/fusion_layer/bias',
                       'encoder/fusion_layer/kernel')),
    **{f'dit_trilatent[{v}]': (
        'convert_dit_trilatent', f'dit-{v}', (), dict(depth=2, variant=v),
        () if v == 'text' else ('adaLN_modulation/bias',
                                'adaLN_modulation/kernel'))
       for v in DIT_VARIANTS},
    'unet': ('convert_unet', 'unet', ('CFG',), {}, ()),
    'hub_dinov2': ('convert_hub_dinov2', 'dinov2-hub', (), dict(depth=2),
                   ()),
    'dino_fusion_block': ('convert_dino_fusion_block', 'vae-shapenet',
                          ('decoder.vit_decoder.blocks.1',), {}, ()),
    'dino_fusion_block_v3': ('convert_dino_fusion_block_v3', 'vae-ffhq',
                             ('decoder.vit_decoder.blocks.0',), {}, ()),
    'dino_fusion_decoder[v4]': ('convert_dino_fusion_decoder', 'vae-shapenet',
                                (), dict(depth=4,
                                         prefix='decoder.vit_decoder.'), ()),
    'dino_fusion_decoder[v3]': ('convert_dino_fusion_decoder', 'vae-ffhq',
                                (), dict(depth=2, variant='v3',
                                         prefix='decoder.vit_decoder.'), ()),
    'rodin_sr[lite]': ('convert_rodin_sr', 'vae-shapenet', (),
                       dict(prefix=f'{SUP}conv_sr.'), ()),
    'rodin_sr[non-lite]': ('convert_rodin_sr', 'vae-ffhq', (),
                           dict(prefix=f'{SUP}conv_sr.'), ()),
    'nearest_conv_sr': ('convert_nearest_conv_sr', 'vae-shapenet', (),
                        dict(prefix=f'{TRI}superresolution.'), ()),
    'sr_hybrid_8xdc': ('convert_sr_hybrid_8xdc', 'vae-ffhq', (),
                       dict(prefix=f'{TRI}superresolution.'), ()),
    'vae_shapenet': ('convert_vae_shapenet', 'vae-shapenet', (),
                     dict(fusion_depth=4, encoder_depth=2), ()),
    'vae_ffhq': ('convert_vae_ffhq', 'vae-ffhq', (),
                 dict(fusion_depth=2, encoder_depth=2), ()),
    'mapping_network': ('convert_mapping_network', 'eg3d', (),
                        dict(prefix='G_ema.backbone.mapping.'), ()),
    'eg3d_generator': ('convert_eg3d_generator', 'eg3d', (), {}, ()),
    'stylegan3_synthesis': ('convert_stylegan3_synthesis', 'sg3', (), {},
                            ()),
    'lpips_torch': ('convert_lpips_torch', 'lpips', (), {}, ()),
}


def _fn(module_pair, name):
    for t, j in module_pair:
        if hasattr(t, name):
            return getattr(t, name), getattr(j, name)
    raise AttributeError(name)


@pytest.mark.parametrize('case', sorted(CASES))
def test_converter_matches_jax_bit_for_bit(case):
    name, kind, args, kwargs, extra = CASES[case]
    port_fn, jax_fn = _fn(((tconv, jconv), (tconvert, jconvert),
                           (tlpips, jlpips)), name)
    if args == ('CFG',):
        args = (_port('unet')[0].cfg,)
    ref = _ref(kind)
    _same_tree(port_fn(ref, *args, **kwargs), jax_fn(ref, *args, **kwargs),
               extra)


def test_every_converter_is_ported():
    """The 36 functions of ``convert_ln3diff.py`` and the public ones of
    ``convert.py`` exist in the port; each public converter has a case
    here."""
    import inspect
    for jmod, tmod in ((jconv, tconv), (jconvert, tconvert)):
        names = [n for n, f in inspect.getmembers(jmod, inspect.isfunction)
                 if f.__module__ == jmod.__name__]
        assert all(hasattr(tmod, n) for n in names)
    names = [n for n, f in inspect.getmembers(jconv, inspect.isfunction)
             if f.__module__ == jconv.__name__]
    assert len(names) == 36
    covered = {c[0] for c in CASES.values()}
    assert {n for n in names if n.startswith('convert_')} - covered == {
        'convert_joint_objaverse', 'convert_joint_shapenet'}


def test_joint_converters_match_jax_bit_for_bit():
    """``convert_joint_objaverse`` (with the DiT's top-level
    ``mixing_logit``) and ``convert_joint_shapenet`` (the U-Net with its
    logit inside) on reference joint dicts."""
    den, vae = _port('dit-text')[1], _port('vae-objaverse')[1]
    ml = torch.full((1, 12, 1, 1), -6.0)
    joint = R.joint_objaverse_reference(den, vae, mixing_logit=ml)
    kw = dict(dit_depth=2, dit2_depth=4)
    got = tconv.convert_joint_objaverse(joint, **kw)
    want = jconv.convert_joint_objaverse(joint, **kw)
    assert sorted(got) == sorted(want) == ['denoiser', 'mixing_logit', 'vae']
    _same_tree(got, want, ('vae/encoder/fusion_layer/bias',
                           'vae/encoder/fusion_layer/kernel'))
    unet, cfg = _port('unet')[1], _port('unet')[0].cfg
    joint = R.joint_shapenet_reference(unet, _port('vae-shapenet')[1], cfg)
    kw = dict(fusion_depth=4, encoder_depth=2)
    _same_tree(tconv.convert_joint_shapenet(joint, cfg, **kw),
               jconv.convert_joint_shapenet(joint, cfg, **kw))


def test_jax_converters_leave_out_leaves_their_modules_have():
    """The faults that the port does not copy (``ROADMAP.md`` §3): JAX's
    PixArt tree lacks the shared ``adaLN_modulation`` its
    ``DiT_TriLatent`` declares, and its Objaverse VAE tree lacks the
    ``encoder/fusion_layer`` of its 4-view ``MVEncoder``."""
    ref = _ref('dit-image-pixelart')
    tree = jconv.convert_dit_trilatent(ref, depth=2, variant='image-pixelart')
    shapes = jax.eval_shape(
        jdit.DiT_TriLatent(_dit_cfg('image-pixelart', jdit,
                                    jnp.float32)).init,
        jax.random.PRNGKey(0), jnp.zeros((B, 8, 8, 12)), jnp.zeros((B,)),
        {k: jnp.zeros(s) for k, s in DIT_CTX['image-pixelart'].items()})
    assert 'adaLN_modulation' in shapes['params']
    assert 'adaLN_modulation' not in tree
    vae_cfg = jvae.TriplaneVAEConfig(
        dit2=jdit.DiT2Config(dtype=jnp.float32, **D2_KW), dtype=jnp.float32,
        **dict(VAE_KW, num_views=4))
    jm = jvae.TriplaneVAE(vae_cfg)
    enc = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((4, 32, 32, 10)), method=jm.encode),
        jax.random.PRNGKey(0))['params']['encoder']
    jtree = jconv.convert_vae_objaverse(_ref('vae-objaverse'), dit2_depth=4)
    assert 'fusion_layer' in enc and 'fusion_layer' not in jtree['encoder']


def test_bf16_tensors_convert_to_f32():
    """JAX's ``_np`` raises on a bf16 tensor (numpy has no bf16); the
    port's gives the f32 values (``ROADMAP.md`` §3).  f16 stays f16."""
    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    sd = {'a.weight': w.bfloat16(), 'a.bias': w[0].half()}
    with pytest.raises(TypeError):
        jconvert.linear(sd, 'a')
    got = tconvert.linear(sd, 'a')
    assert got['kernel'].dtype == np.float32
    np.testing.assert_array_equal(got['kernel'],
                                  w.bfloat16().float().numpy().T)
    assert got['bias'].dtype == np.float16
    np.testing.assert_array_equal(got['bias'], w[0].half().numpy())


# -- each converted kind in a model -------------------------------------------

def _jax_params(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _loaded(kind, sd):
    m = _port(kind)[0]
    load_state_dict_strict(m, sd)
    return m.eval()


@pytest.mark.parametrize('variant', ['text', 'image-pixelart',
                                     'mv-pixelart'])
def test_dit_kinds_match_jax(variant):
    """The denoiser of a reference dict through
    ``reference_state_dicts``' bridge, strictly loaded, against JAX's
    ``DiT_TriLatent`` on JAX's tree (plus, for PixArt, the shared adaLN
    that only the port converts)."""
    ref = _ref(f'dit-{variant}')
    jtree = jconv.convert_dit_trilatent(ref, depth=2, variant=variant)
    ttree = tconv.convert_dit_trilatent(ref, depth=2, variant=variant)
    jtree.setdefault('adaLN_modulation', ttree.get('adaLN_modulation'))
    jtree = {k: v for k, v in jtree.items() if v is not None}
    tm = _loaded(f'dit-{variant}', bridge.dit_state_dict(ttree))
    jm = jdit.DiT_TriLatent(_dit_cfg(variant, jdit, jnp.float32))
    x = _rand((B, 8, 8, 12), 11)
    t = np.array([3.0, 731.0], np.float32)
    ctx = {k: _rand(s, 12 + i) for i, (k, s) in
           enumerate(DIT_CTX[variant].items())}
    consts = jax.jit(jm.init)(jax.random.PRNGKey(0), x, t, ctx)['constants']
    want = jax.jit(jm.apply)({'params': _jax_params(jtree),
                              'constants': consts}, x, t, ctx)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 {k: torch.from_numpy(v) for k, v in ctx.items()})
    _close(got, want)


def test_objaverse_vae_kind_matches_jax():
    """``vae-objaverse`` through ``reference_state_dicts``: the full VAE
    (encoder included) loads strictly; decode and point queries against
    JAX's ``TriplaneVAE`` on JAX's tree."""
    ref = _ref('vae-objaverse')
    sds = bridge.reference_state_dicts('vae-objaverse', ref, dit2_depth=4)
    tm = _loaded('vae-objaverse', sds['vae'])
    jtree = jconv.convert_vae_objaverse(ref, dit2_depth=4)
    jm = jvae.TriplaneVAE(_vae_cfg(jvae, jnp.float32))
    v = {'params': _jax_params(jtree)}
    z = _rand((1, 8, 8, 12), 13, -2, 2)
    want = jax.jit(lambda v, z: jm.apply(v, z, method=jm.decode_latent))(
        v, z)
    coords = _rand((1, 64, 3), 14, -0.5, 0.5)
    want_q = jax.jit(lambda v, p, c: jm.apply(
        v, p, c, 0.9, method=jm.query_points))(v, want, coords)
    with torch.no_grad():
        planes = tm.decode_latent(torch.from_numpy(z))
        got_q = tm.query_points(torch.from_numpy(np.array(want)),
                                torch.from_numpy(coords), 0.9)
    _close(planes, want)
    for g, w in zip(got_q, want_q):
        _close(g, w)


@pytest.mark.parametrize('family', ['shapenet', 'ffhq'])
def test_fusion_vae_kinds_match_jax(family):
    """``vae-shapenet`` / ``vae-ffhq`` through ``reference_state_dicts``:
    encode and decode against JAX's; the FFHQ case also runs the
    ``SuperresolutionHybrid8XDC`` head on 64² features to 512²."""
    img, kw = FUSION[family]
    ref = _ref(f'vae-{family}')
    depth = kw['decoder_fusion_depth']
    sds = bridge.reference_state_dicts(f'vae-{family}', ref,
                                       fusion_depth=depth, encoder_depth=2)
    tm = _loaded(f'vae-{family}', sds['vae'])
    jtree = getattr(jconv, f'convert_vae_{family}')(
        ref, fusion_depth=depth, encoder_depth=2)
    jm = (jvs.FFHQVAE if family == 'ffhq' else jvs.ShapeNetVAE)(
        _fusion_cfg(family, (jvit, jvs), jnp.float32))
    v = {'params': _jax_params(jtree)}
    imgs = _rand((1, img, img, 3), 15)
    z = _rand((1, 4, 4, 12), 16, -2, 2)
    want_e = jax.jit(lambda v, i: jm.apply(v, i, method=jm.encode))(v, imgs)
    want_d = jax.jit(lambda v, z: jm.apply(v, z, method=jm.decode_latent))(
        v, z)
    with torch.no_grad():
        _close(tm.encode(torch.from_numpy(imgs)), want_e)
        _close(tm.decode_latent(torch.from_numpy(z)), want_d)
    if family == 'ffhq':
        from ln3diff_tpu.models import stylegan as jsg
        feat, rgb = _rand((1, 64, 64, 8), 17), _rand((1, 64, 64, 3), 18)
        ws = _rand((1, 512), 19)
        want = jax.jit(jsg.SuperresolutionHybrid8XDC().apply)(
            {'params': v['params']['superresolution']}, feat, rgb, ws)
        with torch.no_grad():
            got = tm.superresolution(*map(torch.from_numpy,
                                          (feat, rgb, ws)))
        _close(got, want)


def test_unet_kind_matches_jax():
    """The U-Net with its ``mixing_logit`` (reference (1, C, 1, 1))."""
    m, sd, ref = _port('unet')
    tm = _loaded('unet', bridge.unet_state_dict(
        tconv.convert_unet(ref, m.cfg)))
    assert torch.equal(tm.mixing_logit, sd['mixing_logit'])
    jm = junet.UNetModel(junet.UNetConfig(dtype=jnp.float32, **UNET_KW))
    v = {'params': _jax_params(jconv.convert_unet(ref, m.cfg))}
    x = _rand((B, 8, 8, 12), 20)
    t = np.array([3.0, 731.0], np.float32)
    ctx = _rand((B, 1, 16), 21)
    want = jax.jit(jm.apply)(v, x, t, ctx)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 {'crossattn': torch.from_numpy(ctx)})
    _close(got, want)


def test_eg3d_generator_kind_matches_jax():
    """``convert_eg3d_generator``: params and ``w_avg`` as buffers; the
    planes at ψ = 0.7 (truncation towards ``w_avg``) and the point
    decoder against JAX's ``TriPlaneGenerator``."""
    _, sd, ref = _port('eg3d')
    params, stats = tconv.convert_eg3d_generator(ref)
    tm = _loaded('eg3d', bridge.eg3d_generator_state_dict(
        {'params': params, 'stats': stats}))
    assert torch.equal(tm.mapping.w_avg, sd['mapping.w_avg'])
    jp, js = jconv.convert_eg3d_generator(ref)
    jm = jeg3d.TriPlaneGenerator(jeg3d.TriPlaneGeneratorConfig(**GEN_KW))
    v = {'params': _jax_params(jp), 'stats': _jax_params(js)}
    z, c = _rand((B, 16), 22), _rand((B, 25), 23)
    want = jax.jit(lambda v, z, c: jm.apply(
        v, z, c, 0.7, method=jm.generate_planes))(v, z, c)
    coords = _rand((B, 32, 3), 24, -0.5, 0.5)
    want_q = jax.jit(lambda v, p, x: jm.apply(
        v, p, x, 1.0, method=jm.query_points))(v, want, coords)
    with torch.no_grad():
        got = tm.generate_planes(torch.from_numpy(z), torch.from_numpy(c),
                                 truncation_psi=0.7)
        got_q = tm.query_points(torch.from_numpy(np.array(want)),
                                torch.from_numpy(coords), 1.0)
    _close(got, want)
    for g, w in zip(got_q, want_q):
        _close(g, w)


def test_stylegan3_synthesis_kind_matches_jax():
    """``convert_stylegan3_synthesis``: the Fourier buffers and each
    layer's ``magnitude_ema`` from the dict."""
    m, _, ref = _port('sg3')
    params, stats = tconv.convert_stylegan3_synthesis(ref)
    tm = _loaded('sg3', bridge.sg3_generator_state_dict(
        {'params': params, 'stats': stats}))
    jm = jsg3.SynthesisNetworkSG3(**SG3_KW)
    jp, js = jconv.convert_stylegan3_synthesis(ref)
    ws = _rand((B, m.num_ws, 32), 25)
    want = jax.jit(jm.apply)({'params': _jax_params(jp),
                              'stats': _jax_params(js)}, ws)
    with torch.no_grad():
        got = tm(torch.from_numpy(ws))
    _close(got, want)


def test_clip_kinds_match_jax():
    """HF CLIP text (with ``text_projection``) and vision towers."""
    ref = _ref('clip-text')
    tm = _loaded('clip-text', bridge.clip_text_state_dict(
        tconvert.convert_hf_clip_text(ref, num_layers=2)))
    jm = jclip.CLIPTextModel(jclip.CLIPTextConfig(with_projection=True,
                                                  **TEXT_KW))
    ids = np.random.default_rng(26).integers(1, 49000, (B, 77)).astype(
        np.int32)
    want = jax.jit(jm.apply)({'params': _jax_params(
        jconvert.convert_hf_clip_text(ref, num_layers=2))}, ids)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    for k in ('last_hidden_state', 'text_embeds'):
        _close(got[k], want[k])
    ref = _ref('clip-vision')
    tm = _loaded('clip-vision', bridge.clip_vision_state_dict(
        tconvert.convert_hf_clip_vision(ref, num_layers=2)))
    jm = jclip.CLIPVisionModel(jclip.CLIPVisionConfig(**VISION_KW))
    img = _rand((B, 28, 28, 3), 27)
    want = jax.jit(jm.apply)({'params': _jax_params(
        jconvert.convert_hf_clip_vision(ref, num_layers=2))}, img)
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    for k in ('tokens', 'pooler_output'):
        _close(got[k], want[k])


@pytest.mark.parametrize('form', ['hf', 'hub'])
def test_dinov2_kinds_match_jax(form):
    """DINOv2 from the HF ``Dinov2Model`` dict (query/key/value fused
    into ``qkv``) and from the torch-hub dict."""
    ref = _ref(f'dinov2-{form}')
    convert = {'hf': (tconvert.convert_hf_dinov2, jconvert.convert_hf_dinov2),
               'hub': (tconv.convert_hub_dinov2, jconv.convert_hub_dinov2)}
    tfn, jfn = convert[form]
    tm = _loaded(f'dinov2-{form}', bridge.vit_state_dict(tfn(ref, depth=2)))
    jm = jvit.VisionTransformer(jvit.ViTConfig(dtype=jnp.float32, **DINO_KW))
    img = _rand((B, 28, 28, 3), 28)
    want = jax.jit(jm.apply)({'params': _jax_params(jfn(ref, depth=2))},
                             img)
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    _close(got, want)


def test_lpips_kind_matches_jax():
    """``lpips.LPIPS(net='vgg')``'s dict through ``convert_lpips_torch``
    into ``make_lpips_fn``."""
    ref = _ref('lpips')
    fn = tlpips.make_lpips_fn(bridge.lpips_state_dict(
        tlpips.convert_lpips_torch(ref)), device='cpu')
    a = _rand((B, 32, 32, 3), 29)
    b = np.clip(a + 0.3 * _rand(a.shape, 30), -1, 1)
    want = jlpips.LPIPS().apply({'params': _jax_params(
        jlpips.convert_lpips_torch(ref))}, a, b)
    with torch.no_grad():
        got = fn.model(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want)


def test_strict_load_names_the_key():
    """A missing key, an extra key and a wrong shape each raise, naming
    the key."""
    m, sd, _ = _port('dinov2-hub')
    with pytest.raises(KeyError, match='norm.bias'):
        load_state_dict_strict(m, {k: v for k, v in sd.items()
                                   if k != 'norm.bias'})
    with pytest.raises(KeyError, match='extra.weight'):
        load_state_dict_strict(m, dict(sd, **{'extra.weight': sd['cls_token']}))
    with pytest.raises(ValueError, match='cls_token'):
        load_state_dict_strict(m, dict(sd, cls_token=torch.zeros(1, 2, 48)))


# -- file formats ----------------------------------------------------------------

def test_load_torch_checkpoint_pt(tmp_path):
    sd = {'a.weight': torch.randn(3, 4), 'b': torch.arange(5)}
    torch.save(sd, tmp_path / 'plain.pt')
    torch.save({'state_dict': sd, 'step': 3}, tmp_path / 'wrapped.pt')
    for name in ('plain.pt', 'wrapped.pt'):
        got = tconvert.load_torch_checkpoint(str(tmp_path / name))
        want = jconvert.load_torch_checkpoint(str(tmp_path / name))
        assert sorted(got) == sorted(want) == sorted(sd)
        for k in sd:
            assert torch.equal(got[k], want[k])


def test_load_safetensors_matches_the_package(tmp_path):
    """The port's reader against ``safetensors.torch.load_file`` (the JAX
    package's loader): f32, f16 and bf16 kept, ints, bools, an empty
    tensor and a tensor at an offset that is not a multiple of its item
    size."""
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(31)
    sd = {'f32': torch.randn(3, 5, generator=g),
          'f16': torch.randn(7, generator=g).half(),
          'bf16': torch.randn(2, 3, 4, generator=g).bfloat16(),
          'i64': torch.arange(6).reshape(2, 3),
          'i8': torch.arange(-3, 4, dtype=torch.int8),
          'u8': torch.arange(5, dtype=torch.uint8),
          'mask': torch.tensor([True, False, True]),
          'empty': torch.zeros(0, 4),
          'scalar': torch.tensor(2.5)}
    path = str(tmp_path / 'x.safetensors')
    save_file(sd, path)
    got = tconvert.load_torch_checkpoint(path)
    want = load_file(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    # a hand-written file whose f32 tensor starts at byte offset 3
    header = {'u': {'dtype': 'U8', 'shape': [3], 'data_offsets': [0, 3]},
              'f': {'dtype': 'F32', 'shape': [2], 'data_offsets': [3, 11]}}
    blob = json.dumps(header).encode()
    data = bytes([1, 2, 3]) + np.array([1.5, -2.0], '<f4').tobytes()
    path = str(tmp_path / 'odd.safetensors')
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(blob)) + blob + data)
    got = tconvert.load_torch_checkpoint(path)
    want = load_file(path)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_split_joint_checkpoint_matches_jax():
    joint = R.joint_objaverse_reference(_port('dit-text')[1],
                                        _port('vae-objaverse')[1])
    got = tconvert.split_joint_checkpoint(joint)
    want = jconvert.split_joint_checkpoint(joint)
    assert sorted(got) == sorted(want) == ['ddpm_model', 'rec_model']
    for part in want:
        assert list(got[part]) == list(want[part])
        assert all(got[part][k] is want[part][k] for k in want[part])

