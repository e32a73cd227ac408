"""The port's profiling hooks, demos and package surface, on the CPU.

* ``utils/profiling.py``: ``trace`` writes a Chrome trace holding an
  ``annotate`` range; ``timed`` reaches the KV logger; ``benchmark_fn``
  and ``profile_dataloading`` run.
* ``scripts/demo_two_stage.py`` at toy size: the port's VAE and diffusion
  training entries run 2 steps each into temporary log directories, then
  ``two_stage`` restores both checkpoints (steps and every weight equal
  to the entries' last), samples with JAX's start noise, renders and
  writes the mesh; the same weights — carried to JAX's trees through the
  reference names (``_torch_reference_sd``) and JAX's converters — in
  JAX's ``TextTo3DPipeline`` give the same latents and frames within 1e-4
  of scale.
* ``scripts/gradio_app.py`` at toy widths: the image → condition step
  against JAX's ``run_i23d`` preprocessing (growing and shrinking; 1e-5
  of scale); the command-line fallback over ``--image``, ``--image_dir``
  and a synthetic render, bf16 and ``--int8_dit``, writing frames, an AVI
  and an OBJ; a stub ``gradio`` module checks the ``Interface`` wiring.
* The package surface: ``__all__`` equals JAX's, each name resolves, an
  unknown name raises, ``release_preset`` gives JAX's configs, a bare
  ``import ln3diff_tpu_torch`` loads no submodule.
* Each new CLI's ``--help`` in a subprocess with no JAX importable, and
  its flags and defaults against the JAX script's.
"""

import ast
import dataclasses
import json
import os
import struct
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ln3diff_tpu
from ln3diff_tpu import config as jconfig
from ln3diff_tpu.conditioning import clip as jclip
from ln3diff_tpu.conditioning import convert_ln3diff as jconv
from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.models import vae as jvae
from ln3diff_tpu.pipeline import SamplerSpec as JSamplerSpec
from ln3diff_tpu.pipeline import TextTo3DPipeline as JPipeline
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
import ln3diff_tpu_torch
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch import config as tconfig
from ln3diff_tpu_torch.conditioning import clip as tclip
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models import vae as tvae
from ln3diff_tpu_torch.scripts import demo_two_stage as tdemo
from ln3diff_tpu_torch.scripts import gradio_app as tgradio
from ln3diff_tpu_torch.scripts import (vit_triplane_diffusion_train,
                                       vit_triplane_train)
from ln3diff_tpu_torch.utils import logger as tlogger
from ln3diff_tpu_torch.utils import profiling as tprof

HERE = Path(__file__).parent
REPO = HERE.parent
sys.path.insert(0, str(HERE))
import _torch_reference_sd as R  # noqa: E402

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


# -- profiling -----------------------------------------------------------------

def test_trace_writes_the_annotated_range(tmp_path):
    a = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate('ln3diff_probe'):
            (a @ a).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    events = json.loads(Path(prof.trace_path).read_text())['traceEvents']
    assert any(e.get('name') == 'ln3diff_probe' for e in events)


def test_timed_reaches_the_logger(tmp_path):
    tlogger.configure(str(tmp_path), format_strs=['json'])
    try:
        for sync in (False, True):
            with tprof.timed('probe', sync=sync):
                torch.randn(8).sum()
        kvs = tlogger.dumpkvs()
    finally:
        tlogger.configure(str(tmp_path), format_strs=())
    assert kvs['time_probe'] > 0


def test_benchmark_fn_and_profile_dataloading():
    calls = []
    t = tprof.benchmark_fn(lambda x: calls.append(x) or x * 2, 3,
                           warmup=2, iters=4)
    assert t >= 0 and calls == [3] * 6
    out = tprof.profile_dataloading(iter(range(100)), num_batches=10)
    assert out['batches_per_sec'] > 0
    assert out['sec_per_batch'] == pytest.approx(1 / out['batches_per_sec'])


# -- the two-stage demo -------------------------------------------------------------

DEN_KW = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
              depth=2, num_heads=2, context_dim=32, exact_gelu=True)
D2_KW = dict(tokens_per_plane=16, hidden_size=32, depth=2, num_heads=2)
VAE_KW = dict(encoder_ch=8, encoder_ch_mult=(1, 2, 4, 4), img_resolution=64,
              num_views=4, ldm_z_channels=4, latent_size=8, patch_size=2,
              conv_sr_ch=8, conv_sr_ch_mult=(1, 2, 2, 4),
              conv_sr_res_blocks=1, plane_channels=8, decoder_output_dim=8)
OPTS = dict(depth_resolution=4, depth_resolution_importance=4,
            ray_start='auto', ray_end='auto', box_warp=0.9,
            white_back=True, filter_out_of_bbox=True,
            sampler_bbox_min=-0.45, sampler_bbox_max=0.45)
RES, STEPS, FRAMES, LATENT = 8, 3, 2, (8, 8, 12)


def _toy_cfgs():
    return (tvae.TriplaneVAEConfig(dit2=tdit.DiT2Config(
                dtype=torch.float32, **D2_KW), dtype=torch.float32,
                **VAE_KW),
            tdit.DiTConfig(dtype=torch.float32, **DEN_KW),
            tconfig.RenderOptions(**OPTS))


def _port_sd(module):
    return {k: v.detach().float().contiguous()
            for k, v in module.state_dict().items()}


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """The two training entries, 2 steps each, at toy size."""
    d = tmp_path_factory.mktemp('two_stage')
    vae_cfg, den_cfg, _ = _toy_cfgs()
    common = ['--device', 'cpu', '--total_steps', '2', '--save_interval',
              '2', '--log_interval', '1', '--seed', '3']
    vae_tr, _ = vit_triplane_train.run(
        common + ['--logdir', str(d / 'vae'), '--vae', 'objaverse-s',
                  '--num_views', '4', '--encoder_resolution', '64',
                  '--render_resolution', '16',
                  '--patch_rendering_resolution', '16'],
        model_cfg=vae_cfg)
    ldm_tr, _ = vit_triplane_diffusion_train.run(
        common + ['--logdir', str(d / 'ldm'), '--latent_size', '8',
                  '--triplane_scaling_divider', '1.0', '--batch_size', '2'],
        den_cfg=den_cfg)
    return dict(dir=d, vae=_port_sd(vae_tr.model), den=_port_sd(ldm_tr.model),
                vae_step=vae_tr.state.step, ldm_step=ldm_tr.state.step)


def _jax_two_stage(vae_sd, den_sd, key, outdir):
    jden = jdit.DiT_TriLatent(jdit.DiTConfig(dtype=jnp.float32, **DEN_KW))
    den_v = jax.jit(jden.init)(jax.random.PRNGKey(1),
                               jnp.zeros((1,) + LATENT), jnp.zeros((1,)),
                               {'crossattn': jnp.zeros((1, 77, 32))})
    den_v = {'params': jax.tree_util.tree_map(
        jnp.asarray, jconv.convert_dit_trilatent(R.dit_reference(den_sd),
                                                 depth=2)),
        'constants': den_v['constants']}
    jv = jvae.TriplaneVAE(jvae.TriplaneVAEConfig(
        dit2=jdit.DiT2Config(dtype=jnp.float32, **D2_KW), dtype=jnp.float32,
        **VAE_KW))
    opts = JOpts(**OPTS)
    like = jax.eval_shape(lambda k: jv.init(
        k, jnp.zeros((1,) + LATENT), jnp.zeros((1, 25)), opts, 4,
        method=jv.init_decoder_paths), jax.random.PRNGKey(2))['params']
    tree = jconv.convert_vae_objaverse(R.vae_objaverse_reference(vae_sd),
                                       dit2_depth=2)
    vae_v = {'params': jax.tree_util.tree_map(
        jnp.asarray, {k: tree[k] for k in like})}
    pipe = JPipeline(
        lambda p, x, t, c: jden.apply(p, x, t, c), den_v,
        lambda p, lat: jv.apply(p, lat, method=jv.decode_latent), vae_v,
        lambda p, planes, cam: jv.apply(
            p, planes, cam, opts, RES, None, method=jv.render)['image_raw'],
        lambda p, planes, coords: jv.apply(
            p, planes, coords, opts.box_warp, method=jv.query_points),
        sampler=JSamplerSpec(kind='flow_matching', num_steps=STEPS,
                             cfg_scale=1.0, triplane_scaling_divider=1.0,
                             latent_shape=LATENT))
    ctx = {'crossattn': jnp.zeros((1, 77, 32))}
    return pipe(key, ctx, ctx, batch=1, num_frames=FRAMES,
                mesh_path=str(outdir / 'jax.obj'), mesh_grid=16,
                render_resolution=RES)


def _obj_counts(path):
    v = f = 0
    for line in open(path):
        if line.startswith('v '):
            v += 1
        elif line.startswith('f '):
            idx = [int(t.split('/')[0]) for t in line.split()[1:]]
            assert len(idx) == 3 and all(1 <= i <= v for i in idx)
            f += 1
    return v, f


def test_two_stage_matches_jax_on_the_restored_weights(trained, tmp_path):
    d = trained['dir']
    key = jax.random.PRNGKey(5)
    x_init = np.array(jax.random.normal(jax.random.split(key)[0],
                                        (1,) + LATENT))
    args = tdemo.build_parser().parse_args([
        '--vae_logdir', str(d / 'vae'), '--ldm_logdir', str(d / 'ldm'),
        '--outdir', str(tmp_path), '--num_steps', str(STEPS),
        '--num_frames', str(FRAMES), '--render_resolution', str(RES),
        '--mesh_grid', '16', '--device', 'cpu'])
    vae_cfg, den_cfg, opts = _toy_cfgs()
    logs = []
    res = tdemo.two_stage(args, vae_cfg, den_cfg, opts,
                          x_init=torch.from_numpy(x_init), log=logs.append)
    assert (res['vae_step'], res['ldm_step']) == \
        (trained['vae_step'], trained['ldm_step']) == (2, 2)
    for name, mod in (('vae', res['vae']), ('den', res['denoiser'])):
        sd = _port_sd(mod)
        assert sorted(sd) == sorted(trained[name])
        for k, v in trained[name].items():
            assert torch.equal(sd[k], v), (name, k)
    assert logs[0] == 'restored VAE @ step 2'
    out = res['out']
    assert len(res['frames']) == FRAMES and all(
        os.path.exists(p) for p in res['frames'])
    v, f = _obj_counts(res['mesh_path'])
    assert (v, f) == (len(out['mesh'][0]), len(out['mesh'][1]))

    want = _jax_two_stage(trained['vae'], trained['den'], key, tmp_path)
    _close(out['latents'].numpy(), want['latents'], 1e-4)
    _close(out['video'].numpy(), np.asarray(want['video']), 1e-4)


def test_two_stage_configs_follow_the_script(tmp_path):
    args = tdemo.build_parser().parse_args(['--vae_logdir', 'a',
                                            '--ldm_logdir', 'b'])
    vae_cfg, den_cfg, opts = tdemo.configs(args)
    assert (vae_cfg.num_views, vae_cfg.img_resolution,
            vae_cfg.latent_size) == (4, 128, 16)
    assert vae_cfg.dit2.tokens_per_plane == 64
    assert (den_cfg.input_size, den_cfg.in_channels, den_cfg.depth,
            den_cfg.hidden_size) == (16, 4, 12, 768)
    assert opts == tconfig.RENDER_PRESETS[
        'objverse_tuneray_aug_resolution_64_64_auto']
    assert args.device == 'cuda'
    with pytest.raises(AssertionError, match='no VAE checkpoint'):
        tdemo.two_stage(tdemo.build_parser().parse_args([
            '--vae_logdir', str(REPO / 'no-such-dir'), '--ldm_logdir', 'b',
            '--outdir', str(tmp_path),
            '--device', 'cpu']), *_toy_cfgs())


# -- the image→3D demo ---------------------------------------------------------------

I23D_KW = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
               depth=2, num_heads=2, variant='image-pixelart',
               context_dim=32, pooled_vector_dim=32, t2i_final=True,
               dino_dim=32)
VISION_KW = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
                 num_heads=2, intermediate_size=64)


def _runner_kw():
    vae_cfg, _, opts = _toy_cfgs()
    return dict(den_cfg=tdit.DiTConfig(dtype=torch.bfloat16, **I23D_KW),
                vae_cfg=vae_cfg,
                vision_cfg=tclip.CLIPVisionConfig(**VISION_KW),
                render_opts=opts)


_GRADIO_ARGS = ['--num_steps', '2', '--num_frames', '2',
                '--render_resolution', str(RES), '--mesh_grid', '16',
                '--device', 'cpu']


@pytest.mark.parametrize('hw', [20, 40])
def test_image_condition_matches_jax_preprocessing(hw):
    jm = jclip.CLIPVisionModel(jclip.CLIPVisionConfig(**VISION_KW))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)))
    rng = np.random.default_rng(hw)
    v = {'params': jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape))
        .astype(np.float32), v['params'])}
    tm = tclip.CLIPVisionModel(tclip.CLIPVisionConfig(**VISION_KW))
    tm.load_state_dict(bridge.clip_vision_state_dict(v))
    image = rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)
    # JAX's run_i23d preprocessing (scripts/gradio_app.py:81-89)
    img = jnp.asarray(image.astype(np.float32) / 127.5 - 1.0)
    img = jax.image.resize(img[None], (1, 28, 28, 3), 'bilinear')
    enc = jm.apply(v, img)
    want = {'crossattn': enc['tokens'][:, :, :1024],
            'vector': enc['pooler_output'][:, :768]}
    cond, uncond = tgradio.image_condition(image, tm, 'cpu')
    assert sorted(cond) == sorted(want) == sorted(uncond)
    for k in want:
        _close(cond[k].numpy(), want[k], 1e-5)
        assert float(uncond[k].abs().max()) == 0.0


def _avi_frames(path):
    data = open(path, 'rb').read()
    assert data[:4] == b'RIFF' and data[8:12] == b'AVI '
    i = data.rindex(b'idx1')
    (n,) = struct.unpack('<I', data[i + 4:i + 8])
    return sum(data[i + 8 + 16 * e:i + 12 + 16 * e] == b'00dc'
               for e in range(n // 16))


def _check_written(outdir, tag, frames, mesh):
    assert len(frames) == 2 and all(os.path.exists(p) for p in frames)
    assert _avi_frames(os.path.join(outdir, f'{tag}.avi')) == 2
    assert mesh == os.path.join(outdir, f'{tag}.obj')
    _obj_counts(mesh)


def _png(path, hw, seed):
    from PIL import Image
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (hw, hw, 3), dtype=np.uint8)).save(path)


def test_gradio_cli_fallback_writes_the_outputs(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setitem(sys.modules, 'gradio', None)
    imgs = tmp_path / 'imgs'
    imgs.mkdir()
    for i in range(2):
        _png(imgs / f'view{i}.png', 48, i)
    out = tmp_path / 'out'
    written = tgradio.main(['--image_dir', str(imgs), '--outdir', str(out)]
                           + _GRADIO_ARGS, **_runner_kw())
    assert [w[0] for w in written] == ['view0', 'view1']
    for tag, frames, mesh in written:
        _check_written(str(out), tag, frames, mesh)
    written = tgradio.main(['--image', str(imgs / 'view0.png'),
                            '--outdir', str(out), '--int8_dit']
                           + _GRADIO_ARGS, **_runner_kw())
    _check_written(str(out), *written[0])
    written = tgradio.main(['--outdir', str(out)] + _GRADIO_ARGS,
                           **_runner_kw())
    assert 'synthetic render' in capsys.readouterr().out
    _check_written(str(out), *written[0])


def test_gradio_runner_holds_the_serving_modules():
    args = tgradio.build_parser().parse_args(_GRADIO_ARGS + ['--int8_dit'])
    run = tgradio.build_runner(args, **_runner_kw())
    den = run.modules['denoiser']
    assert den.cfg.quantized
    assert run.modules['vae'].dit2.blocks[0].within.attn.qkv.weight.dtype \
        == torch.float32          # the toy VAE's compute dtype
    assert run.pipeline.spec.kind == 'flow_matching'
    assert run.pipeline.spec.cfg_scale == 4.0
    args = tgradio.build_parser().parse_args(_GRADIO_ARGS)
    run = tgradio.build_runner(args, **_runner_kw())
    assert {p.dtype for p in run.modules['denoiser'].parameters()} == \
        {torch.bfloat16}


def test_gradio_interface_wiring(tmp_path, monkeypatch):
    made = {}

    class Interface:
        def __init__(self, fn, inputs, outputs, title):
            made.update(fn=fn, inputs=inputs, outputs=outputs, title=title)

        def launch(self):
            made['launched'] = True

    def widget(kind):
        return lambda **kw: (kind, kw)

    stub = types.ModuleType('gradio')
    stub.Interface = Interface
    stub.Image, stub.Gallery, stub.File = (widget('Image'),
                                           widget('Gallery'),
                                           widget('File'))
    monkeypatch.setitem(sys.modules, 'gradio', stub)
    assert tgradio.main(['--outdir', str(tmp_path)] + _GRADIO_ARGS,
                        **_runner_kw()) == []
    assert made['launched']
    assert made['inputs'] == ('Image', {'type': 'numpy',
                                        'label': 'input view'})
    assert [o[0] for o in made['outputs']] == ['Gallery', 'File']
    image = np.random.default_rng(0).integers(0, 256, (32, 32, 3),
                                              dtype=np.uint8)
    frames, mesh = made['fn'](image)
    _check_written(str(tmp_path), 'out', frames, mesh)


# -- the package surface -------------------------------------------------------------

def test_all_matches_jax_and_resolves():
    assert ln3diff_tpu_torch.__all__ == ln3diff_tpu.__all__
    assert dir(ln3diff_tpu_torch) == sorted(ln3diff_tpu_torch.__all__)
    assert ln3diff_tpu_torch.__version__ == ln3diff_tpu.__version__
    for name in ln3diff_tpu_torch.__all__:
        got = getattr(ln3diff_tpu_torch, name)
        want = getattr(ln3diff_tpu, name)
        assert type(got) is type(want) or (callable(got) and callable(want)), \
            name
        if isinstance(want, dict):
            assert sorted(got) == sorted(want), name
    with pytest.raises(AttributeError, match='no_such_name'):
        ln3diff_tpu_torch.no_such_name


@pytest.mark.parametrize('name', sorted(jconfig.RELEASE_PRESETS))
def test_release_preset_matches_jax(name):
    got = ln3diff_tpu_torch.release_preset(name)
    want = ln3diff_tpu.release_preset(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_bare_import_loads_no_submodule():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'ln3diff_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import ln3diff_tpu_torch as l3\n"
            "sub = [m for m in sys.modules if m.startswith("
            "'ln3diff_tpu_torch.')]\n"
            "assert not sub and 'torch' not in sys.modules, sub\n"
            "assert l3.release_preset('objaverse/t23d-dit').cfg_scale "
            "if False else True\n"
            "print(l3.release_preset('objaverse/t23d-dit').denoiser)\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 't23d-dit-l2'


# -- the new CLIs -----------------------------------------------------------------------

_CLIS = {'evaluator': 'evaluator', 'demo_two_stage': 'demo_two_stage',
         'gradio_app': 'gradio_app'}


@pytest.mark.parametrize('script', sorted(_CLIS))
def test_cli_help_runs_without_jax(script):
    code = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'flax', 'ln3diff_tpu', 'yaml'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = ['{script}', '--help']\n"
            f"runpy.run_module('ln3diff_tpu_torch.scripts.{script}', "
            "run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith('usage')


def _script_flags(name):
    """``{flag: default}`` of a JAX script's ``add_argument`` calls."""
    tree = ast.parse((REPO / 'scripts' / f'{name}.py').read_text())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, 'attr', '') == 'add_argument':
            flag = node.args[0].value
            default = next((ast.literal_eval(k.value) for k in node.keywords
                            if k.arg == 'default'), None)
            if any(k.arg == 'action' for k in node.keywords):
                default = False
            flags[flag.lstrip('-')] = default
    return flags


@pytest.mark.parametrize('script', sorted(_CLIS))
def test_cli_flags_match_the_jax_script(script):
    from importlib import import_module
    parser = import_module(
        f'ln3diff_tpu_torch.scripts.{script}').build_parser()
    got = {a.dest: a.default for a in parser._actions if a.dest != 'help'}
    want = _script_flags(_CLIS[script])
    assert got.pop('device') == 'cuda'
    if 'outdir' in want:
        assert os.path.basename(got.pop('outdir')) == \
            os.path.basename(want.pop('outdir'))
    assert got == want


def test_console_wrappers_are_declared_and_run(monkeypatch, capsys):
    from ln3diff_tpu_torch import cli as tcli
    text = (REPO / 'pyproject.toml').read_text()
    for name, fn in (('ln3diff-torch-evaluator', 'evaluator'),
                     ('ln3diff-torch-gradio', 'gradio_app')):
        assert f'{name} = "ln3diff_tpu_torch.cli:{fn}"' in text
        monkeypatch.setattr(sys, 'argv', [name, '--help'])
        with pytest.raises(SystemExit) as e:
            getattr(tcli, fn)()
        assert e.value.code == 0
        assert 'usage' in capsys.readouterr().out
