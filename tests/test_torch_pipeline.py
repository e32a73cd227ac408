"""The text→3D slice end to end: ``ln3diff_tpu_torch.pipeline`` against
``ln3diff_tpu.pipeline`` on a toy model, plus the port's import boundary.

Both pipelines get the same random init (carried by the bridge) and the
same start noise (JAX's draw, fed to the port as ``x_init``); the JAX side
runs ``FusedOSG`` through its jnp reference on the CPU, the port through
the kernel's plain version.  Whole-slice tolerance: 1e-4 relative to each
output's scale, as DDIM multiplies early-step differences by up to
√(1/ᾱ_t).
"""

import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.conditioning.clip import CLIPTextModel as JCLIP
from ln3diff_tpu.conditioning.clip import CLIPTextConfig as JCLIPConfig
from ln3diff_tpu.conditioning.clip import SimpleCLIPTokenizer
from ln3diff_tpu.diffusion.gaussian import make_diffusion
from ln3diff_tpu.models.dit import DiT_TriLatent as JDiT
from ln3diff_tpu.models.dit import DiTConfig as JDiTConfig
from ln3diff_tpu.models.dit import DiT2Config as JDiT2Config
from ln3diff_tpu.models.vae import TriplaneVAE as JVAE
from ln3diff_tpu.models.vae import TriplaneVAEConfig as JVAEConfig
from ln3diff_tpu.pipeline import SamplerSpec as JSamplerSpec
from ln3diff_tpu.pipeline import TextTo3DPipeline as JPipeline
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.conditioning.clip import (CLIPTextConfig,
                                                 CLIPTextModel)
from ln3diff_tpu_torch.models.dit import DiT2Config, DiT_TriLatent, DiTConfig
from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
from ln3diff_tpu_torch.pipeline import (SamplerSpec, build_t23d_pipeline,
                                        resolve_device)
from ln3diff_tpu_torch.render.renderer import RenderOptions

REPO = Path(__file__).resolve().parents[1]
RES = 8
OPTS = dict(depth_resolution=6, depth_resolution_importance=6,
            ray_start='auto', ray_end='auto', box_warp=0.9,
            filter_out_of_bbox=True, sampler_bbox_min=-0.45,
            sampler_bbox_max=0.45)


def _perturbed(v, seed):
    """flax zero-inits adaLN and the final layer; perturb every leaf so
    the denoiser's output is not identically zero."""
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.PRNGKey(seed),
                                               p.shape), v)


@functools.lru_cache(maxsize=None)
def _models():
    den_kw = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
                  depth=2, num_heads=2, context_dim=32, exact_gelu=False)
    clip_kw = dict(vocab_size=49408, hidden_size=32, num_layers=1,
                   num_heads=2, intermediate_size=64)
    d2_kw = dict(tokens_per_plane=16, hidden_size=32, depth=2, num_heads=2)
    vae_kw = dict(ldm_z_channels=4, latent_size=8, patch_size=2,
                  conv_sr_ch=8, conv_sr_ch_mult=(1, 2),
                  conv_sr_res_blocks=1, plane_channels=8,
                  decoder_output_dim=8)
    jden = JDiT(JDiTConfig(variant='text', dtype=jnp.float32, **den_kw))
    jvae = JVAE(JVAEConfig(encoder_ch=8, encoder_ch_mult=(1, 2),
                           img_resolution=32, num_views=2,
                           dit2=JDiT2Config(dtype=jnp.float32, **d2_kw),
                           dtype=jnp.float32, **vae_kw))
    jclip = JCLIP(JCLIPConfig(**clip_kw))
    den_v = jden.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, 8, 12)),
                      jnp.zeros((2,)), {'crossattn': jnp.zeros((2, 77, 32))})
    den_v = {'params': _perturbed(den_v['params'], 10),
             'constants': den_v['constants']}
    vae_v = jvae.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 12)),
                      jnp.zeros((1, 25)), JOpts(**OPTS), 4,
                      method=jvae.init_decoder_paths)
    vae_v = {'params': _perturbed(vae_v['params'], 11)}
    clip_v = jclip.init(jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)

    tcfgs = dict(
        den_cfg=DiTConfig(dtype=torch.float32, **den_kw),
        vae_cfg=TriplaneVAEConfig(
            dit2=DiT2Config(dtype=torch.float32, **d2_kw),
            dtype=torch.float32, **vae_kw),
        text_cfg=CLIPTextConfig(**clip_kw))
    tden = DiT_TriLatent(tcfgs['den_cfg'])
    tden.load_state_dict(bridge.dit_state_dict(np_tree(den_v)))
    tvae = TriplaneVAE(tcfgs['vae_cfg'])
    tvae.load_state_dict(bridge.vae_state_dict(np_tree(vae_v)))
    tclip = CLIPTextModel(tcfgs['text_cfg'])
    tclip.load_state_dict(bridge.clip_text_state_dict(np_tree(clip_v)))
    return dict(jden=jden, jvae=jvae, jclip=jclip, den_v=den_v, vae_v=vae_v,
                clip_v=clip_v, tcfgs=tcfgs,
                tmods=dict(denoiser=tden, vae=tvae, text_model=tclip))


def _pipelines(cfg_scale=6.5, steps=10):
    m = _models()
    jden, jvae, opts = m['jden'], m['jvae'], JOpts(**OPTS)
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
        sampler=JSamplerSpec(kind='ddim', num_steps=steps,
                             cfg_scale=cfg_scale, latent_shape=(8, 8, 12)),
        diffusion=make_diffusion(steps=1000,
                                 timestep_respacing=f'ddim{steps}'))
    tpipe, tencode, _ = build_t23d_pipeline(
        'cpu', modules=m['tmods'], render_opts=RenderOptions(**OPTS),
        render_resolution=RES,
        sampler=SamplerSpec(num_steps=steps, cfg_scale=cfg_scale,
                            latent_shape=(8, 8, 12)),
        render_dtype=None,
        **m['tcfgs'])
    return jpipe, tpipe, tencode


def _jax_context(prompt):
    m = _models()
    ids = jnp.asarray(SimpleCLIPTokenizer()([prompt, '']))
    both = m['jclip'].apply(m['clip_v'], ids)['last_hidden_state']
    return {'crossattn': both[:1]}, {'crossattn': both[1:]}


def _jax_noise(key, shape):
    """The start noise JAX's ``__call__`` draws from ``key``."""
    k_sample, _ = jax.random.split(key)
    _, k0 = jax.random.split(k_sample)
    return jax.random.normal(k0, shape)


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


def test_slice_end_to_end():
    """Text → latents → planes → orbit frames, JAX vs port (no mesh)."""
    jpipe, tpipe, tencode = _pipelines()
    prompt = 'a red wooden chair'
    jc, ju = _jax_context(prompt)
    tc, tu = tencode(prompt)
    _close(tc['crossattn'], jc['crossattn'])
    _close(tu['crossattn'], ju['crossattn'])

    key = jax.random.PRNGKey(3)
    want = jpipe(key, jc, ju, batch=1, num_frames=2, render_resolution=RES)
    noise = torch.from_numpy(np.array(_jax_noise(key, (1, 8, 8, 12))))
    got = tpipe(tc, tu, batch=1, num_frames=2, render_resolution=RES,
                x_init=noise)
    assert got['video'].shape == (1, 2, RES, RES, 3)
    for k in ('latents', 'planes', 'video'):
        _close(got[k], want[k])

    # serving format: host uint8 frames of the same video
    got8 = tpipe(tc, tu, num_frames=2, render_resolution=RES, x_init=noise,
                 video_uint8=True)
    assert isinstance(got8['video'], np.ndarray)
    np.testing.assert_array_equal(
        got8['video'],
        ((np.clip(got['video'].numpy(), -1, 1) + 1) * 127.5)
        .astype(np.uint8))


def test_sigma_grid_query_matches_jax():
    jpipe, tpipe, _ = _pipelines()
    rng = np.random.default_rng(4)
    planes = (rng.standard_normal((1, 3, 8, 8, 8)) * 0.5).astype(np.float32)
    want = jpipe.dispatch_mesh_sigma(jnp.asarray(planes), grid_size=10,
                                     smooth=False)
    got = tpipe.dispatch_mesh_sigma(torch.from_numpy(planes), grid_size=10,
                                    smooth=False)
    assert got.dtype == torch.float16 and got.shape == (1000,)
    # one f16 rounding of the same f32 σ
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-3,
                               rtol=1e-3)


def test_cfg_one_runs_conditional_half_only():
    """cfg 1.0 skips the unconditional branch: equal to JAX's shortcut,
    and to a doubled batch whose uncond is cond."""
    jpipe, tpipe, tencode = _pipelines(cfg_scale=1.0, steps=4)
    _, tpipe3, _ = _pipelines(cfg_scale=3.0, steps=4)
    jc, ju = _jax_context('a lamp')
    tc, tu = tencode('a lamp')
    key = jax.random.PRNGKey(5)
    k_sample, _ = jax.random.split(key)
    want = jpipe.sample_latents(k_sample, 1, jc, ju)
    _, k0 = jax.random.split(k_sample)
    noise = torch.from_numpy(np.array(jax.random.normal(k0, (1, 8, 8, 12))))
    single = tpipe.sample_latents(1, tc, tu, x_init=noise)
    _close(single, want)
    double = tpipe3.sample_latents(1, tc, tc, x_init=noise)
    torch.testing.assert_close(single, double, atol=2e-5, rtol=1e-5)


def test_mesh_export_is_next_slice():
    _, tpipe, tencode = _pipelines(steps=2)
    tc, tu = tencode('x')
    with pytest.raises(NotImplementedError, match='next slice'):
        tpipe(tc, tu, mesh_path='/nonexistent/out.obj')


def test_cuda_entry_points_need_a_card():
    """No silent CPU fallback: asking for CUDA without a card raises."""
    if torch.cuda.is_available():
        assert resolve_device('cuda').type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            resolve_device('cuda')
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_t23d_pipeline()
    assert resolve_device('cpu').type == 'cpu'


_PORT_MODULES = sorted(
    '.'.join(p.relative_to(REPO).with_suffix('').parts)
    for p in (REPO / 'ln3diff_tpu_torch').rglob('*.py'))


def test_port_imports_without_jax():
    """Every module of the port imports with jax, flax and the JAX package
    made unimportable, and none of them gets loaded on the way."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'ln3diff_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {_PORT_MODULES!r}:\n"
        "    __import__(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'ln3diff_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "import ln3diff_tpu_torch.pipeline\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('ok')


_FORBIDDEN = re.compile(
    r'^\s*(?:import|from)\s+(?:jax|jaxlib|flax|ln3diff_tpu)(?:[.\s]|$)'
    r'|\b(?:__import__|import_module)\(\s*[\'"](?:jax|flax|ln3diff_tpu)\b'
    r'|\bflax\b|\bln3diff_tpu\.', re.MULTILINE)


@pytest.mark.parametrize('path', _PORT_MODULES + ['chip_smoke'])
def test_no_jax_reference_in_source(path):
    """No file of the port, and not chip_smoke.py, contains ``import jax``,
    ``from jax``, ``flax`` or ``ln3diff_tpu.``."""
    src = (REPO / (path.replace('.', '/') + '.py')).read_text()
    assert not _FORBIDDEN.findall(src)
