"""The port's entry points against the JAX package's, on the CPU.

* ``ln3diff_tpu_torch.scripts.convert_checkpoint``: a toy reference joint
  checkpoint (``_torch_reference_sd``) converted by the port's CLI and by
  the JAX package's ``scripts/convert_checkpoint.py``: the same
  ``denoiser.npz`` and ``mixing_logit.npy`` byte for byte, the same
  ``vae.npz`` arrays (the port's adds the MV encoder's ``fusion_layer``,
  ``ROADMAP.md`` §3); ``.pt`` and ``.safetensors`` give the same files;
  ``--verify`` passes on the toy modules and fails on a corrupted tree,
  naming EXTRA, MISSING and SHAPE.
* ``ln3diff_tpu_torch.scripts.vit_triplane_diffusion_sample``: that
  conversion through ``main([... '--device', 'cpu'])`` with toy configs
  patched in, against JAX's ``TextTo3DPipeline`` on the JAX-converted
  npz with the same start noise (``start_noise`` patched to JAX's draw)
  and the same text tower: the 24 frames within 1e-4 of scale; the
  ``.avi`` holds 24 frames and the ``.obj`` parses.
* ``legacy_pkl_to_npz`` on a persistence pickle written here, whose
  ``module_src`` would create a flag file if it were executed, against
  JAX's ``flatten_state_dict``; the EG3D warm-up teacher loaded from its
  ``.npz`` against JAX's ``load_teacher_state_dict``, and through the
  warm-up's ``main``.
"""

import functools
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
from ln3diff_tpu.diffusion.gaussian import make_diffusion as jmake
from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.models import eg3d as jeg3d
from ln3diff_tpu.models import vae as jvae
from ln3diff_tpu.pipeline import SamplerSpec as JSamplerSpec
from ln3diff_tpu.pipeline import TextTo3DPipeline as JPipeline
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
from ln3diff_tpu.training import checkpoint as jckpt
from ln3diff_tpu.training import eg3d_warmup as jwarm
from ln3diff_tpu.utils import legacy_pkl as jlegacy
from ln3diff_tpu.utils.misc import cast_floating as jcast
from ln3diff_tpu_torch.conditioning import clip as tclip
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models import eg3d as teg3d
from ln3diff_tpu_torch.models import vae as tvae
from ln3diff_tpu_torch.scripts import convert_checkpoint as tcli
from ln3diff_tpu_torch.scripts import legacy_pkl_to_npz as tlegacy_cli
from ln3diff_tpu_torch.scripts import vit_triplane_diffusion_sample as tsample
from ln3diff_tpu_torch.training import eg3d_warmup as twarm

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, '..', 'scripts'))
import _torch_reference_sd as R  # noqa: E402
import convert_checkpoint as jcli  # noqa: E402
from test_torch_pipeline import _salt_free_ids  # noqa: E402

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

DEN_KW = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
              depth=2, num_heads=2, context_dim=32, exact_gelu=True)
D2_KW = dict(tokens_per_plane=16, hidden_size=32, depth=2, num_heads=2)
VAE_KW = dict(encoder_ch=8, encoder_ch_mult=(1, 2, 4, 4), img_resolution=32,
              num_views=4, ldm_z_channels=4, latent_size=8, patch_size=2,
              conv_sr_ch=8, conv_sr_ch_mult=(1, 2, 2, 4),
              conv_sr_res_blocks=1, plane_channels=8, decoder_output_dim=8)
TEXT_KW = dict(hidden_size=32, num_layers=1, num_heads=2,
               intermediate_size=64)
OPTS = dict(depth_resolution=4, depth_resolution_importance=4,
            ray_start='auto', ray_end='auto', box_warp=0.9,
            white_back=True, filter_out_of_bbox=True,
            sampler_bbox_min=-0.45, sampler_bbox_max=0.45)
RES, STEPS, LATENT = 8, 4, (8, 8, 12)
DEPTHS = ['--dit_depth', '2', '--dit2_depth', '2']


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


def _toy_cfgs():
    return (tdit.DiTConfig(dtype=torch.float32, **DEN_KW),
            tvae.TriplaneVAEConfig(dit2=tdit.DiT2Config(
                dtype=torch.float32, **D2_KW), dtype=torch.float32,
                **VAE_KW),
            tclip.CLIPTextConfig(**TEXT_KW))


def _toy_module(kind, which, args):
    den_cfg, vae_cfg, _ = _toy_cfgs()
    with torch.device('meta'):
        if which == 'denoiser':
            return tdit.DiT_TriLatent(den_cfg)
        return tvae.TriplaneVAE(vae_cfg, encoder=True)


@pytest.fixture(scope='module')
def joint(tmp_path_factory):
    """A toy reference joint checkpoint as ``.pt`` and ``.safetensors``,
    the port's modules it was drawn from, and both CLIs' outputs."""
    from safetensors.torch import save_file
    d = tmp_path_factory.mktemp('joint')
    den_cfg, vae_cfg, _ = _toy_cfgs()
    den = R.port_state_dict(tdit.DiT_TriLatent(den_cfg), 40)
    vae = R.port_state_dict(tvae.TriplaneVAE(vae_cfg, encoder=True), 41)
    ref = R.joint_objaverse_reference(den, vae,
                                      mixing_logit=torch.full((1, 12, 1, 1),
                                                              -6.0))
    torch.save(ref, d / 'joint.pt')
    save_file(ref, str(d / 'joint.safetensors'))
    return dict(dir=d, ref=ref, den=den, vae=vae)


def _port_cli(monkeypatch, src, out, *extra):
    monkeypatch.setattr(tcli, 'target_module', _toy_module)
    return tcli.main(['--src', str(src), '--kind', 'joint-objaverse',
                      '--outdir', str(out), *DEPTHS, *extra])


@functools.lru_cache(maxsize=None)
def _jax_cli_outdir(src, out):
    argv = sys.argv
    sys.argv = ['convert_checkpoint.py', '--src', src, '--kind',
                'joint-objaverse', '--outdir', out, *DEPTHS]
    try:
        jcli.main()
    finally:
        sys.argv = argv
    return out


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_convert_cli_writes_the_jax_cli_files(joint, monkeypatch, capsys):
    d = joint['dir']
    written = _port_cli(monkeypatch, d / 'joint.pt', d / 'port', '--verify')
    out = capsys.readouterr().out
    assert f'[denoiser] {len(joint["den"])} leaves, 0 mismatches' in out
    assert f'[vae] {len(joint["vae"])} leaves, 0 mismatches' in out
    jdir = _jax_cli_outdir(str(d / 'joint.pt'), str(d / 'jax'))
    assert sorted(written) == ['denoiser', 'mixing_logit', 'vae']
    for name in ('denoiser.npz', 'mixing_logit.npy'):
        assert (d / 'port' / name).read_bytes() == \
            open(os.path.join(jdir, name), 'rb').read(), name
    got, want = _npz(d / 'port' / 'vae.npz'), _npz(
        os.path.join(jdir, 'vae.npz'))
    assert [k for k in got if k in want] == list(want)
    assert sorted(set(got) - set(want)) == [
        'encoder/fusion_layer/bias', 'encoder/fusion_layer/kernel']
    for k, a in want.items():
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k


def test_convert_cli_reads_safetensors_as_pt(joint, monkeypatch):
    d = joint['dir']
    _port_cli(monkeypatch, d / 'joint.pt', d / 'pt')
    _port_cli(monkeypatch, d / 'joint.safetensors', d / 'st')
    for name in ('denoiser.npz', 'vae.npz', 'mixing_logit.npy'):
        assert (d / 'pt' / name).read_bytes() == \
            (d / 'st' / name).read_bytes(), name


def test_convert_cli_verify_fails_on_a_corrupted_tree(joint, monkeypatch,
                                                      capsys):
    """One leaf dropped, one added, one reshaped: three mismatches, each
    named, and a non-zero exit."""
    real = tcli.convert

    def corrupted(kind, sd, args):
        out = real(kind, sd, args)
        den = out['denoiser']
        den['x_embedder']['proj'].pop('bias')
        den['stray'] = {'kernel': np.zeros((2, 3), np.float32)}
        den['final_layer']['linear']['bias'] = np.zeros(5, np.float32)
        return {'denoiser': den}

    monkeypatch.setattr(tcli, 'convert', corrupted)
    with pytest.raises(SystemExit, match='3 tree mismatches'):
        _port_cli(monkeypatch, joint['dir'] / 'joint.pt',
                  joint['dir'] / 'bad', '--verify')
    out = capsys.readouterr().out
    assert '[denoiser] EXTRA     stray.weight (3, 2)' in out
    assert '[denoiser] MISSING   x_embedder.proj.bias (32,)' in out
    assert ('[denoiser] SHAPE     final_layer.linear.bias converted (5,) '
            '!= model (16,)') in out


# -- the sample entry ------------------------------------------------------------

def _avi_frames(path):
    """The number of '00dc' frame chunks in an AVI's idx1 index."""
    data = open(path, 'rb').read()
    assert data[:4] == b'RIFF' and data[8:12] == b'AVI '
    i = data.rindex(b'idx1')
    (n,) = struct.unpack('<I', data[i + 4:i + 8])
    entries = [data[i + 8 + 16 * e:i + 12 + 16 * e] for e in range(n // 16)]
    return sum(e == b'00dc' for e in entries)


def _obj_counts(path):
    v = f = 0
    for line in open(path):
        if line.startswith('v '):
            assert len(line.split()) in (4, 7)
            v += 1
        elif line.startswith('f '):
            idx = [int(t.split('/')[0]) for t in line.split()[1:]]
            assert len(idx) == 3 and all(1 <= i <= v for i in idx)
            f += 1
    return v, f


class _SaltFree:
    """The tokenizer as the hash-bucket fallback lays out ids, with a
    salt-free digest (``test_torch_pipeline._salt_free_ids``)."""

    def __call__(self, texts):
        return np.stack([_salt_free_ids(t)[0] for t in texts])


def _jax_models(text_sd):
    jden = jdit.DiT_TriLatent(jdit.DiTConfig(dtype=jnp.float32, **DEN_KW))
    jv = jvae.TriplaneVAE(jvae.TriplaneVAEConfig(
        dit2=jdit.DiT2Config(dtype=jnp.float32, **D2_KW), dtype=jnp.float32,
        **VAE_KW))
    jtext = jclip.CLIPTextModel(jclip.CLIPTextConfig(**TEXT_KW))
    text_params = jconvert.convert_hf_clip_text(
        R.clip_text_reference(text_sd), num_layers=1)
    return jden, jv, jtext, {'params': text_params}


def test_sample_entry_matches_jax_pipeline(joint, monkeypatch, tmp_path):
    d = joint['dir']
    _port_cli(monkeypatch, d / 'joint.pt', d / 'port_s')
    jdir = _jax_cli_outdir(str(d / 'joint.pt'), str(d / 'jax'))
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    k_sample, _ = jax.random.split(key)
    noise = np.array(jax.random.normal(jax.random.split(k_sample)[1],
                                       (1,) + LATENT))
    monkeypatch.setattr(tsample, 'model_configs', lambda args: _toy_cfgs())
    monkeypatch.setattr(tsample, 'start_noise',
                        lambda shape, gen, device: torch.from_numpy(noise))
    monkeypatch.setattr(tclip, 'default_tokenizer',
                        lambda *a, **k: _SaltFree())
    from ln3diff_tpu_torch import config as tconfig
    monkeypatch.setitem(tconfig.RENDER_PRESETS,
                        'objverse_tuneray_aug_resolution_64_64_auto',
                        tconfig.RenderOptions(**OPTS))
    prompt = 'a red wooden chair'
    res = tsample.main([
        '--prompts', prompt, '--outdir', str(tmp_path), '--vae', 'objaverse',
        '--denoiser_ckpt', str(d / 'port_s' / 'denoiser.npz'),
        '--vae_ckpt', str(d / 'port_s' / 'vae.npz'),
        '--num_steps', str(STEPS), '--render_resolution', str(RES),
        '--mesh_grid', '24', '--device', 'cpu'])
    out = res['outputs'][0]
    text_sd = {k: v.detach() for k, v in
               res['modules']['text_model'].state_dict().items()}

    jden, jv, jtext, text_v = _jax_models(text_sd)
    x0 = jnp.zeros((2,) + LATENT)
    den_v = jax.jit(jden.init)(jax.random.PRNGKey(1), x0, jnp.zeros((2,)),
                               {'crossattn': jnp.zeros((2, 77, 32))})
    den_v = jcast({'params': jckpt.load_numpy_checkpoint(
        os.path.join(jdir, 'denoiser.npz'), den_v['params']),
        'constants': den_v['constants']}, jnp.bfloat16)
    vae_like = jax.eval_shape(lambda k: jv.init(
        k, jnp.zeros((1,) + LATENT), jnp.zeros((1, 25)), JOpts(**OPTS), 4,
        method=jv.init_decoder_paths), jax.random.PRNGKey(2))
    vae_v = {'params': jckpt.load_numpy_checkpoint(
        os.path.join(jdir, 'vae.npz'), vae_like['params'])}
    opts = JOpts(**OPTS)
    jpipe = JPipeline(
        lambda p, x, t, c: jden.apply(p, x, t, c), den_v,
        lambda p, lat: jv.apply(p, lat, method=jv.decode_latent), vae_v,
        lambda p, planes, cam: jv.apply(
            p, planes, cam, opts, RES, None, use_fused_osg=True,
            method=jv.render)['image_raw'],
        lambda p, planes, coords: jv.apply(
            p, planes, coords, opts.box_warp, use_fused_osg=True,
            method=jv.query_points),
        sampler=JSamplerSpec(kind='ddim', num_steps=STEPS, cfg_scale=6.5,
                             latent_shape=LATENT),
        diffusion=jmake(steps=1000, timestep_respacing=f'ddim{STEPS}'))
    ids = _salt_free_ids(prompt)
    ctx = jax.jit(jtext.apply)(text_v, jnp.asarray(ids))['last_hidden_state']
    want = jpipe(key, {'crossattn': ctx[:1]}, {'crossattn': ctx[1:]},
                 batch=1, num_frames=24, render_resolution=RES)

    assert out['video'].shape == (24, RES, RES, 3)
    _close(out['latents'], want['latents'], 1e-4)
    _close(out['video'], np.asarray(want['video'][0]), 1e-4)
    assert _avi_frames(out['video_path']) == 24
    v, f = _obj_counts(out['mesh_path'])
    assert (v, f) == (len(out['mesh'][0]), len(out['mesh'][1]))
    assert out['sample_wall_s'] > 0
    assert os.path.exists(tmp_path / 'progress.csv')
    # the JAX CLI's vae.npz (no fusion_layer) serves the port's entry too:
    # the decode side loads strictly
    args = tsample.apply_preset(tsample.build_parser().parse_args([
        '--vae_ckpt', os.path.join(jdir, 'vae.npz'), '--device', 'cpu']))
    mods, _ = tsample._modules(args, *_toy_cfgs(), torch.device('cpu'),
                               print)
    for k, t in mods['vae'].state_dict().items():
        assert torch.equal(t, res['modules']['vae'].state_dict()[k]), k


def test_sample_parser_matches_the_script():
    """The same flags and defaults as ``scripts/vit_triplane_diffusion_
    sample.py``, with ``--device`` (default 'cuda') added and the output
    directory under the temporary directory."""
    import ast
    src = open(os.path.join(HERE, '..', 'scripts',
                            'vit_triplane_diffusion_sample.py')).read()
    want = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and getattr(
                node.func, 'attr', '') == 'add_argument':
            want.add(node.args[0].value)
    parser = tsample.build_parser()
    got = {a.option_strings[0] for a in parser._actions
           if a.option_strings and a.option_strings[0] != '-h'}
    assert got == want | {'--device'}
    args = parser.parse_args([])
    assert args.device == 'cuda' and args.vae == 'objaverse-s'
    assert (args.num_steps, args.render_resolution, args.mesh_grid,
            args.num_frames) == (250, 128, 192, 24)
    assert os.path.basename(args.outdir) == 'ln3diff-samples'


def test_sample_preset_resolves_the_release():
    """``--preset objaverse/t23d-dit`` gives DDIM 250 at CFG 6.5 with
    divider 0.96806 and the Objaverse VAE; the ShapeNet preset conditions
    on the pooled CLIP feature × 18.4."""
    args = tsample.apply_preset(tsample.build_parser().parse_args(
        ['--preset', 'objaverse/t23d-dit', '--num_steps', '7']))
    assert (args.denoiser, args.vae, args.objective, args.num_steps,
            args.unconditional_guidance_scale, args.triplane_scaling_divider,
            args.clip_scale) == ('t23d-dit-l2', 'objaverse', 'ddim', 250,
                                 6.5, 0.96806, None)
    args = tsample.apply_preset(tsample.build_parser().parse_args(
        ['--preset', 'shapenet/car-t23d']))
    assert (args.denoiser, args.vae, args.clip_scale,
            args.unconditional_guidance_scale) == ('shapenet-unet',
                                                   'shapenet', 18.4, 1.0)
    den_cfg, vae_cfg, text_cfg = tsample.model_configs(args)
    assert text_cfg.with_projection and vae_cfg.latent_size == 32


def test_sample_entry_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tsample.main(['--prompts', 'x'])


# -- legacy pickles and the warm-up teacher -------------------------------------

GEN_KW = dict(z_dim=16, c_dim=25, w_dim=16, plane_resolution=16,
              plane_channels=8, decoder_output_dim=8)


@pytest.fixture(scope='module')
def teacher_pickle(tmp_path_factory):
    """A persistence-format pickle of a toy EG3D generator (reference
    names, random ``w_avg``), its ``.npz`` from the port's CLI, and a flag
    path that executing the pickled source would create."""
    d = tmp_path_factory.mktemp('pkl')
    m = teg3d.TriPlaneGenerator(teg3d.TriPlaneGeneratorConfig(**GEN_KW))
    sd = R.port_state_dict(m, 42)
    sd['mapping.w_avg'] = torch.randn(16, generator=torch.Generator()
                                      .manual_seed(43))
    flag = d / 'EXECUTED'
    src = f'open({str(flag)!r}, "w").write("pickled source ran")\n'
    R.write_persistence_pickle(
        str(d / 'net.pkl'), {'G_ema': R.eg3d_reference(sd, prefix=''),
                             'G': None, 'D': None}, src)
    flat = tlegacy_cli.main([str(d / 'net.pkl'), str(d / 'net.npz'),
                             '--keys', 'G_ema'])
    return dict(dir=d, sd=sd, flag=flag, flat=flat)


def test_legacy_pkl_matches_jax_without_running_source(teacher_pickle,
                                                       capsys):
    d, flat = teacher_pickle['dir'], teacher_pickle['flat']
    want = jlegacy.flatten_state_dict(
        jlegacy.load_stubbed(str(d / 'net.pkl'))['G_ema'])
    assert sorted(flat) == sorted(f'G_ema.{k}' for k in want)
    for k, v in want.items():
        assert flat[f'G_ema.{k}'].dtype == v.dtype
        assert np.array_equal(flat[f'G_ema.{k}'], v), k
    saved = _npz(d / 'net.npz')
    assert all(np.array_equal(saved[k], flat[k]) for k in flat)
    info = tlegacy_cli.main([str(d / 'net.pkl'), '--describe'])
    assert info['G_ema']['class_name'] == 'TriPlaneGenerator'
    assert not teacher_pickle['flag'].exists()


def _stub_jax_trainer():
    """An object carrying JAX's ``load_teacher_state_dict`` without the
    trainer's init (its method reads and writes ``teacher_variables``)."""
    class Stub:
        teacher_variables = {'params': {}}
    stub = Stub()
    stub.load = functools.partial(jwarm.EG3DWarmupTrainer
                                  .load_teacher_state_dict, stub)
    return stub


def test_warmup_teacher_from_pickle_matches_jax(teacher_pickle):
    """The pickle's npz through the port trainer's
    ``load_teacher_state_dict`` and through JAX's: the parameters and
    ``w_avg`` equal the pickle's, the planes at ψ = 0.7 and the point
    decoder agree within 1e-5 of scale."""
    from test_torch_eg3d_warmup import OPTS as WOPTS
    from test_torch_eg3d_warmup import WARM, _students
    from ln3diff_tpu_torch.render.renderer import RenderOptions
    _, _, tcfg, _, _ = _students('tiny')
    data = _npz(teacher_pickle['dir'] / 'net.npz')
    tr = twarm.EG3DWarmupTrainer(
        tcfg, teg3d.TriPlaneGeneratorConfig(**GEN_KW),
        twarm.WarmupConfig(**WARM), render_opts=RenderOptions(**WOPTS),
        device='cpu')
    tr.load_teacher_state_dict(data)
    got_sd = tr.teacher.state_dict()
    for k, v in teacher_pickle['sd'].items():
        assert torch.equal(got_sd[k], v), k
    stub = _stub_jax_trainer()
    stub.load(data)
    jm = jeg3d.TriPlaneGenerator(jeg3d.TriPlaneGeneratorConfig(**GEN_KW))
    v = stub.teacher_variables
    np.testing.assert_array_equal(np.asarray(v['stats']['mapping']['w_avg']),
                                  teacher_pickle['sd']['mapping.w_avg'])
    rng = np.random.default_rng(44)
    z = rng.standard_normal((2, 16)).astype(np.float32)
    c = np.zeros((2, 25), np.float32)
    want = jax.jit(lambda v, z, c: jm.apply(
        v, z, c, 0.7, method=jm.generate_planes))(v, z, c)
    coords = rng.uniform(-0.5, 0.5, (2, 32, 3)).astype(np.float32)
    want_q = jax.jit(lambda v, p, x: jm.apply(
        v, p, x, 1.0, method=jm.query_points))(v, want, coords)
    with torch.no_grad():
        got = tr.teacher.generate_planes(torch.from_numpy(z),
                                         torch.from_numpy(c),
                                         truncation_psi=0.7)
        got_q = tr.teacher.query_points(torch.from_numpy(np.array(want)),
                                        torch.from_numpy(coords), 1.0)
    _close(got, want, 1e-5)
    for g, w in zip(got_q, want_q):
        _close(g, w, 1e-5)


def test_warmup_main_takes_the_pickle_npz(teacher_pickle, monkeypatch,
                                          tmp_path):
    """``main --teacher_ckpt`` on the torch-named npz (``G_ema.`` keys)
    converts it: the teacher holds the pickle's tensors and a step's loss
    is finite."""
    from test_torch_eg3d_warmup import _students
    from ln3diff_tpu_torch import config as tconfig
    _, _, tcfg, _, _ = _students('tiny')
    monkeypatch.setattr(tconfig, 'vae_preset', lambda name: tcfg)
    monkeypatch.setattr(twarm, 'EG3DWarmupTrainer', functools.partial(
        twarm.EG3DWarmupTrainer,
        gen_cfg=teg3d.TriPlaneGeneratorConfig(**GEN_KW)))
    tr = twarm.main([
        '--outdir', str(tmp_path), '--teacher_ckpt',
        str(teacher_pickle['dir'] / 'net.npz'), '--total_steps', '1',
        '--save_interval', '1', '--batch_size', '1',
        '--render_resolution', '8', '--device', 'cpu'])
    got_sd = tr.teacher.state_dict()
    for k, v in teacher_pickle['sd'].items():
        assert torch.equal(got_sd[k], v), k
    assert tr.state.step == 1
    for p in tr.state.params.values():
        assert bool(torch.isfinite(p).all())
