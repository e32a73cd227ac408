"""The text→3D slice end to end: ``ln3diff_tpu_torch.pipeline`` against
``ln3diff_tpu.pipeline`` on a toy model, plus the port's import boundary.

Both pipelines get the same random init (carried by the bridge) and the
same start noise (JAX's draw, fed to the port as ``x_init``); the JAX side
runs ``FusedOSG`` through its jnp reference on the CPU, the port through
the kernel's plain version.  Whole-slice tolerance: 1e-4 relative to each
output's scale, as DDIM multiplies early-step differences by up to
√(1/ᾱ_t).  The mesh call runs a toy model whose σ output bias is shifted
to put the σ = 10 iso-surface inside the grid, and a denoiser with
``fused_attention=True``.
"""

import functools
import hashlib
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

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

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
def _models(sigma_shift=0.0, fused_attention=False):
    den_kw = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
                  depth=2, num_heads=2, context_dim=32, exact_gelu=False,
                  fused_attention=fused_attention)
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
    osg_out = vae_v['params']['osg_decoder']['EqualDense_1']
    osg_out['bias'] = osg_out['bias'].at[0].add(sigma_shift)
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


def _pipelines(cfg_scale=6.5, steps=10, **model_kw):
    m = _models(**model_kw)
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
        sampler=SamplerSpec(kind='ddim', num_steps=steps,
                            cfg_scale=cfg_scale, latent_shape=(8, 8, 12)),
        render_dtype=None,
        **m['tcfgs'])
    return jpipe, tpipe, tencode


def _jax_context(prompt, **model_kw):
    m = _models(**model_kw)
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


def _salt_free_ids(prompt):
    """``[prompt, '']`` laid out as the hash-bucket tokenizer lays them out
    (start, one id per word, end, zero padding), with a SHA-256 digest in
    place of Python's per-process salted ``hash``: the same ids in every
    run."""
    ids = np.zeros((2, 77), np.int32)
    for row, text in enumerate([prompt, '']):
        words = [int.from_bytes(hashlib.sha256(w.encode()).digest()[:8],
                                'little') % 49000 + 320
                 for w in text.lower().split()]
        toks = [49406] + words + [49407]
        ids[row, :len(toks)] = toks
    return ids


def test_slice_end_to_end():
    """Text → latents → planes → orbit frames, JAX vs port (no mesh).

    Both sides get the same token ids from a salt-free digest.  The
    latents are held end to end; the planes and frames are held from a
    decode and render of one shared latent, JAX's, so that DDIM's
    amplification of the latents' f32 differences (CFG 6.5 drives the toy
    model's latents to scale ~10²) is not charged to the decoder."""
    m = _models()
    jpipe, tpipe, _ = _pipelines()
    ids = _salt_free_ids('a red wooden chair')
    both = m['jclip'].apply(m['clip_v'], jnp.asarray(ids))[
        'last_hidden_state']
    jc, ju = {'crossattn': both[:1]}, {'crossattn': both[1:]}
    with torch.no_grad():
        tboth = m['tmods']['text_model'](torch.from_numpy(ids))[
            'last_hidden_state']
    tc, tu = {'crossattn': tboth[:1]}, {'crossattn': tboth[1:]}
    _close(tc['crossattn'], jc['crossattn'])
    _close(tu['crossattn'], ju['crossattn'])

    key = jax.random.PRNGKey(3)
    want = jpipe(key, jc, ju, batch=1, num_frames=2, render_resolution=RES)
    noise = torch.from_numpy(np.array(_jax_noise(key, (1, 8, 8, 12))))
    got = tpipe(tc, tu, batch=1, num_frames=2, render_resolution=RES,
                x_init=noise)
    assert got['video'].shape == (1, 2, RES, RES, 3)
    _close(got['latents'], want['latents'])
    with torch.no_grad():
        planes = tpipe.decode_fn(torch.from_numpy(np.array(
            want['latents'])))
        video = tpipe.render_orbit(planes, 2, render_resolution=RES)
    _close(planes, want['planes'])
    _close(video, want['video'])

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


MESH = dict(sigma_shift=10.3, fused_attention=True)


def _read_obj(path):
    lines = Path(path).read_text().splitlines()
    v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines
                  if ln.startswith('v ')]).reshape(-1, 6)
    f = np.array([[int(x) for x in ln.split()[1:]] for ln in lines
                  if ln.startswith('f ')], np.int64).reshape(-1, 3)
    return v, f


def test_mesh_export_is_next_slice(tmp_path):
    """The serving path's mesh call: ``__call__`` with a ``mesh_path``
    against JAX's, with the fused-attention denoiser.  Latents, planes and
    frames to 1e-4 of scale; the smoothed f16 σ grids to the σ-grid tests'
    tolerance (6e-3 relative); the port's mesh is the march of its own σ
    grid, and from JAX's σ grid the port's march gives JAX's triangles
    exactly; the OBJ written parses back to the returned vertices and
    faces.  (The two calls' own meshes differ by a few percent of
    triangles: the toy field hovers within 0.5 of the threshold, where one
    f16 ulp of the smoothed grid flips cells.)"""
    jpipe, tpipe, tencode = _pipelines(steps=4, **MESH)
    jc, ju = _jax_context('a red wooden chair', **MESH)
    tc, tu = tencode('a red wooden chair')
    key = jax.random.PRNGKey(3)
    jpath, tpath = str(tmp_path / 'jax.obj'), str(tmp_path / 'port.obj')
    want = jpipe(key, jc, ju, num_frames=4, render_resolution=RES,
                 mesh_path=jpath, mesh_grid=24)
    noise = torch.from_numpy(np.array(_jax_noise(key, (1, 8, 8, 12))))
    got = tpipe(tc, tu, num_frames=4, render_resolution=RES, x_init=noise,
                mesh_path=tpath, mesh_grid=24)
    assert got['video'].shape == (1, 4, RES, RES, 3)
    for k in ('latents', 'planes', 'video'):
        _close(got[k], want[k])

    from ln3diff_tpu.render.mesh import march_grid as jmarch
    from ln3diff_tpu_torch.render.mesh import march_grid, rotate_x
    jsig = np.asarray(jpipe.dispatch_mesh_sigma(want['planes'], 24,
                                                smooth=True), np.float32)
    tsig = tpipe.dispatch_mesh_sigma(got['planes'], 24, smooth=True)
    np.testing.assert_allclose(tsig.float().numpy(), jsig, rtol=6e-3,
                               atol=1e-3)
    assert (jsig > 10).any() and (jsig < 10).any()
    verts, faces = got['mesh']
    mv, mf = march_grid(tsig.numpy(), 24)
    assert len(faces) > 0
    np.testing.assert_array_equal(verts, rotate_x(mv, -90.0))
    np.testing.assert_array_equal(faces, mf)
    jv, jf = jmarch(jsig, 24)
    tv, tf = march_grid(jsig, 24)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    v, f = _read_obj(tpath)
    np.testing.assert_allclose(v[:, :3], verts, atol=1e-6)
    assert ((v[:, 3:] >= 0) & (v[:, 3:] <= 1)).all()
    np.testing.assert_array_equal(f - 1, faces)


def test_mesh_call_empty_surface_and_ply(tmp_path):
    """A field with no crossing skips the σ pull and the march and still
    writes a valid (empty) mesh; ``.ply`` selects the PLY writer;
    ``export_mesh`` exports the first instance."""
    _, tpipe, tencode = _pipelines(steps=2)
    tc, tu = tencode('x')
    path = tmp_path / 'empty.ply'
    out = tpipe(tc, tu, num_frames=2, render_resolution=RES,
                mesh_path=str(path), mesh_grid=12)
    assert len(out['mesh'][0]) == 0 and len(out['mesh'][1]) == 0
    assert out['video'].shape == (1, 2, RES, RES, 3)
    assert path.read_text().startswith('ply\n')
    _, tpipe, _ = _pipelines(steps=2, **MESH)
    verts, faces = tpipe.export_mesh(out['planes'], str(tmp_path / 'm.obj'),
                                     grid_size=12)
    v, f = _read_obj(tmp_path / 'm.obj')
    assert len(v) == len(verts) and len(f) == len(faces)


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
        "sys.path.insert(0, 'tests')\n"
        "import _torch_reference_sd\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'ln3diff_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
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


def test_boundary_covers_the_entry_layer():
    """The checks here cover the entry layer: the CLIs under
    ``ln3diff_tpu_torch/scripts/`` (the data CLIs among them), the console
    wrappers, the converters, the utilities, the parallel layer, the data
    layer with its native reader's binding, evaluation, the sgm configs,
    profiling, the evaluator and demo CLIs, and the reference-dict writer
    that ``chip_smoke.py`` imports from ``tests/``."""
    for m in ('ln3diff_tpu_torch.cli',
              'ln3diff_tpu_torch.parallel.mesh',
              'ln3diff_tpu_torch.parallel.pipeline',
              'ln3diff_tpu_torch.parallel.serving',
              'ln3diff_tpu_torch.scripts._lib',
              'ln3diff_tpu_torch.scripts.vit_triplane_train',
              'ln3diff_tpu_torch.scripts.vit_triplane_diffusion_train',
              'ln3diff_tpu_torch.scripts.vit_triplane_sit_train',
              'ln3diff_tpu_torch.scripts.vit_triplane_cvD_train',
              'ln3diff_tpu_torch.scripts.vit_triplane_cldm_train',
              'ln3diff_tpu_torch.conditioning.convert',
              'ln3diff_tpu_torch.conditioning.convert_ln3diff',
              'ln3diff_tpu_torch.scripts.convert_checkpoint',
              'ln3diff_tpu_torch.scripts.legacy_pkl_to_npz',
              'ln3diff_tpu_torch.scripts.vit_triplane_diffusion_sample',
              'ln3diff_tpu_torch.scripts.'
              'vit_triplane_diffusion_sample_objaverse',
              'ln3diff_tpu_torch.utils.legacy_pkl',
              'ln3diff_tpu_torch.utils.logger',
              'ln3diff_tpu_torch.utils.misc',
              'ln3diff_tpu_torch.utils.video',
              'ln3diff_tpu_torch.parallel.fsdp',
              'ln3diff_tpu_torch.data.wds',
              'ln3diff_tpu_torch.data.exr',
              'ln3diff_tpu_torch.data.objaverse_raw',
              'ln3diff_tpu_torch.data.lmdb_reader',
              'ln3diff_tpu_torch.data.eg3d',
              'ln3diff_tpu_torch.native.build',
              'ln3diff_tpu_torch.scripts.wds_create',
              'ln3diff_tpu_torch.scripts.lmdb_create',
              'ln3diff_tpu_torch.scripts.profile_dataloading',
              'ln3diff_tpu_torch.evaluation.inception',
              'ln3diff_tpu_torch.evaluation.metrics',
              'ln3diff_tpu_torch.utils.profiling',
              'ln3diff_tpu_torch.sgm_config',
              'ln3diff_tpu_torch.scripts.evaluator',
              'ln3diff_tpu_torch.scripts.demo_two_stage',
              'ln3diff_tpu_torch.scripts.gradio_app'):
        assert m in _PORT_MODULES, m
    src = (REPO / 'chip_smoke.py').read_text()
    assert '_torch_reference_sd' in src


@pytest.mark.parametrize('path', _PORT_MODULES + [
    'chip_smoke', 'tests._torch_reference_sd', 'tests._torch_ranks',
    'tests._torch_parallel_tasks', 'scripts.parallel_card_check'])
def test_no_jax_reference_in_source(path):
    """No file of the port, not chip_smoke.py, not the reference-dict
    writer it imports, not the gloo ranks' task modules and not the
    multi-card check that runs them contains ``import jax``, ``from
    jax``, ``flax`` or ``ln3diff_tpu.``."""
    src = (REPO / (path.replace('.', '/') + '.py')).read_text()
    assert not _FORBIDDEN.findall(src)


def test_save_video_frames_matches_jax(tmp_path):
    """The PNG dump of an orbit: the same files, byte for byte, as the
    JAX package's for the same frames."""
    from ln3diff_tpu.pipeline import save_video_frames as jsave
    from ln3diff_tpu_torch.pipeline import save_video_frames
    frames = np.random.default_rng(6).uniform(-1.2, 1.2, (3, 8, 8, 3)) \
        .astype(np.float32)
    got = save_video_frames(torch.from_numpy(frames), str(tmp_path / 'p'))
    want = jsave(frames, str(tmp_path / 'j'))
    assert [Path(p).name for p in got] == ['p_000.png', 'p_001.png',
                                           'p_002.png']
    for a, b in zip(got, want):
        assert Path(a).read_bytes() == Path(b).read_bytes()
