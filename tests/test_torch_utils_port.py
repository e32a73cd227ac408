"""The port's configs, logger, video writers and small utilities against
the JAX package's.

* ``config``: ``release_preset`` gives JAX's field values for every
  ``RELEASE_PRESETS`` name (the log directory under the temporary
  directory), ``add_preset_argument`` the same precedence (explicit flags
  over the preset over the defaults), ``vae_preset('objaverse-s')`` JAX's
  fields, and ``ExperimentConfig`` the port's types;
* ``utils/logger.py``: each sink writes JAX's lines for the same
  key-values (stdout table, jsonl, csv with a column added later,
  ``log.txt``), ``profile_kv`` accumulates as JAX's does, and the
  tensorboard sink writes an event file or, without the package, raises
  naming it;
* ``utils/video.py``: the same AVI and GIF bytes as JAX's;
* ``utils/misc.py``: ``EasyDict``, the class registry, ``assert_shape``,
  ``InfiniteSampler``'s index stream and ``cast_floating``;
* ``cli.py``: the console scripts of ``pyproject.toml``.
"""

import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from ln3diff_tpu import config as jconfig
from ln3diff_tpu.utils import logger as jlogger
from ln3diff_tpu.utils import misc as jmisc
from ln3diff_tpu.utils import video as jvideo
from ln3diff_tpu_torch import cli as tcli
from ln3diff_tpu_torch import config as tconfig
from ln3diff_tpu_torch.utils import logger as tlogger
from ln3diff_tpu_torch.utils import misc as tmisc
from ln3diff_tpu_torch.utils import video as tvideo

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    logdir = out.pop('logdir')
    return out, os.path.basename(logdir)


# -- config ----------------------------------------------------------------------

def test_release_presets_match_jax():
    assert list(tconfig.RELEASE_PRESETS) == list(jconfig.RELEASE_PRESETS)
    assert tconfig.RELEASE_PRESETS == jconfig.RELEASE_PRESETS
    for name in jconfig.RELEASE_PRESETS:
        got, want = (_fields(tconfig.release_preset(name)),
                     _fields(jconfig.release_preset(name)))
        assert got == want, name


def test_experiment_config_defaults_and_types():
    got, want = (_fields(tconfig.ExperimentConfig()),
                 _fields(jconfig.ExperimentConfig()))
    assert got == want
    cfg = tconfig.release_preset('objaverse/t23d-dit')
    assert cfg.render_opts() is tconfig.RENDER_PRESETS[cfg.cfg]
    assert isinstance(cfg.vae_config(), tconfig.TriplaneVAEConfig)
    assert json.loads(cfg.to_json())['extras']['cfg_scale'] == 6.5


def test_objaverse_s_vae_matches_jax():
    """The JAX sample script's default ``--vae``: DiT2-B/2 over the
    Objaverse VAE (every field the port's configs have, dtypes aside)."""
    def same(got, want):
        a, b = dataclasses.asdict(got), dataclasses.asdict(want)
        for d in (a, b, a['dit2'], b['dit2']):
            d.pop('dtype')
        assert a['dit2'] == {k: b['dit2'][k] for k in a['dit2']}
        assert {k: v for k, v in a.items() if k != 'dit2'} == {
            k: b[k] for k in a if k != 'dit2'}
    got = tconfig.vae_preset('objaverse-s')
    same(got, jconfig.vae_preset('objaverse-s'))
    assert got.dit2.hidden_size == 768 and got.dit2.depth == 12
    same(tconfig.vae_preset('objaverse'), jconfig.vae_preset('objaverse'))


@pytest.mark.parametrize('argv', [
    [], ['--preset', 'train/objaverse-dit'],
    ['--preset', 'train/objaverse-dit', '--lr', '3e-5', '--vae', 'shapenet'],
    ['--batch_size', '4', '--preset', 'train/shapenet-car-vae'],
])
def test_preset_argument_precedence_matches_jax(argv):
    """Defaults < preset < explicit flags, on both sides; the parsed
    namespaces and ``args_to_config`` agree."""
    import argparse
    out = []
    for mod in (tconfig, jconfig):
        p = argparse.ArgumentParser()
        mod.add_config_to_argparser(p, mod.ExperimentConfig())
        mod.add_preset_argument(p, argv)
        args = p.parse_args(argv)
        out.append((vars(args), _fields(mod.args_to_config(args))))
    (tns, tcfg), (jns, jcfg) = out
    tns.pop('logdir'), jns.pop('logdir')
    assert tns == jns
    assert tcfg == jcfg


# -- logger ------------------------------------------------------------------------

KVS = [{'loss': 0.123456789, 'step': 3, 'name': 'a', 'lr': 1e-4},
       {'loss': 2.5, 'step': 4, 'grad_norm': 17.25}]


def test_stdout_sink_matches_jax():
    a, b = io.StringIO(), io.StringIO()
    ts, js = tlogger.stdout_sink(a), jlogger.stdout_sink(b)
    for kv in KVS:
        ts(kv)
        js(kv)
    assert a.getvalue() == b.getvalue() and '| loss' in a.getvalue()


@pytest.mark.parametrize('sink', ['jsonl_sink', 'csv_sink'])
def test_file_sinks_match_jax(sink, tmp_path):
    """The csv sink rewrites its header when a column appears."""
    tp, jp = str(tmp_path / 't'), str(tmp_path / 'j')
    ts, js = getattr(tlogger, sink)(tp), getattr(jlogger, sink)(jp)
    for kv in KVS:
        ts(kv)
        js(kv)
    assert open(tp).read() == open(jp).read()


def test_configure_and_dumps_match_jax(tmp_path, capsys, monkeypatch):
    """``configure`` into a directory (stdout, csv, json, log), running
    means, sums and ``profile_kv`` scopes, plain messages to ``log.txt``;
    both modules' files hold the same lines, the timings aside."""
    monkeypatch.setattr('time.perf_counter', iter(range(1000)).__next__)
    dumps = []
    for mod, d in ((tlogger, tmp_path / 't'), (jlogger, tmp_path / 'j')):
        mod.configure(str(d), format_strs=['stdout', 'csv', 'json', 'log'])
        mod.logkv('step', 1)
        mod.logkv_mean('loss', 1.0)
        mod.logkv_mean('loss', 2.0)
        mod.log_loss_dict({'mse': 0.5}, prefix='train/')
        with mod.profile_kv('data'):
            pass
        with mod.profile_kv('data'):
            pass
        mod.log('a message')
        dumps.append(mod.dumpkvs())
    assert dumps[0] == dumps[1]
    assert dumps[0]['loss'] == 1.5 and dumps[0]['wait_data'] == 2.0
    for name in ('progress.csv', 'progress.json', 'log.txt'):
        t = open(tmp_path / 't' / name).read().replace(str(tmp_path / 't'),
                                                       'D')
        j = open(tmp_path / 'j' / name).read().replace(str(tmp_path / 'j'),
                                                       'D')
        assert t == j, name


def test_tensorboard_sink_writes_events(tmp_path):
    pytest.importorskip('tensorboard')
    sink = tlogger.tensorboard_sink(str(tmp_path / 'tb'))
    sink({'loss': 0.5, 'step': 2, 'name': 'not a number'})
    files = os.listdir(tmp_path / 'tb')
    assert any(f.startswith('events.out.tfevents') for f in files)


def test_tensorboard_sink_names_the_missing_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with pytest.raises(ImportError, match='"tensorboard" package'):
        tlogger.tensorboard_sink(str(tmp_path / 'tb'))
    # the other sinks do not need it
    tlogger.configure(str(tmp_path / 'plain'), format_strs=['csv'])


# -- video -----------------------------------------------------------------------

def _frames(dtype):
    rng = np.random.default_rng(0)
    if dtype == 'uint8':
        return rng.integers(0, 256, (5, 16, 24, 3), dtype=np.uint8)
    return rng.uniform(-1.3, 1.3, (5, 16, 24, 3)).astype(np.float32)


@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
@pytest.mark.parametrize('fmt', ['avi', 'gif'])
def test_video_bytes_match_jax(fmt, dtype, tmp_path):
    frames = _frames(dtype)
    save = {'avi': (tvideo.save_video_avi, jvideo.save_video_avi),
            'gif': (tvideo.save_video_gif, jvideo.save_video_gif)}[fmt]
    a = save[0](frames, str(tmp_path / f't.{fmt}'), fps=12)
    b = save[1](frames, str(tmp_path / f'j.{fmt}'), fps=12)
    assert open(a, 'rb').read() == open(b, 'rb').read()
    np.testing.assert_array_equal(tvideo.frames_to_uint8(frames),
                                  jvideo.frames_to_uint8(frames))


def test_video_rejects_bad_shapes(tmp_path):
    with pytest.raises(ValueError, match='expected'):
        tvideo.save_video_avi(np.zeros((2, 8, 8), np.uint8),
                              str(tmp_path / 'x.avi'))


# -- misc ------------------------------------------------------------------------

def test_misc_utilities_match_jax():
    d = tmisc.EasyDict(a=1)
    d.b = 2
    assert d == {'a': 1, 'b': 2} and d.a == 1
    del d.a
    with pytest.raises(AttributeError):
        d.a
    assert tmisc.get_obj_by_name('collections.OrderedDict') is \
        __import__('collections').OrderedDict
    assert tmisc.construct_class_by_name('fractions.Fraction', 3, 6) == 0.5
    assert tmisc.optional_import('json') is json
    assert tmisc.optional_import('no_such_module_here') is None
    tmisc.assert_shape(torch.zeros(2, 3), [None, 3])
    with pytest.raises(AssertionError, match='dimension 1'):
        tmisc.assert_shape(torch.zeros(2, 3), [2, 4])
    for kw in (dict(rank=1, num_replicas=3, seed=5), dict(shuffle=False)):
        t = iter(tmisc.InfiniteSampler(11, **kw))
        j = iter(jmisc.InfiniteSampler(11, **kw))
        assert [next(t) for _ in range(40)] == [next(j) for _ in range(40)]


def test_cast_floating_over_modules_and_state_dicts():
    m = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Embedding(5, 2))
    m.register_buffer('count', torch.arange(3))
    sd = {'w': torch.ones(2), 'n': torch.arange(2),
          'sub': {'b': torch.zeros(1, dtype=torch.float64)}}
    got = tmisc.cast_floating(sd, torch.bfloat16)
    assert got['w'].dtype == got['sub']['b'].dtype == torch.bfloat16
    assert got['n'].dtype == torch.int64
    w = m[0].weight.detach().clone()
    assert tmisc.cast_floating(m, torch.bfloat16) is m
    assert m[0].weight.dtype == m[1].weight.dtype == torch.bfloat16
    assert m.count.dtype == torch.int64
    assert torch.equal(m[0].weight, w.bfloat16())


# -- console scripts -------------------------------------------------------------

def test_console_scripts_are_declared_and_run(monkeypatch, capsys):
    text = open(os.path.join(os.path.dirname(__file__), '..',
                             'pyproject.toml')).read()
    for name, fn in (('ln3diff-torch-sample', 'sample'),
                     ('ln3diff-torch-convert', 'convert_checkpoint'),
                     ('ln3diff-torch-eg3d-warmup', 'eg3d_warmup')):
        assert f'{name} = "ln3diff_tpu_torch.cli:{fn}"' in text
        monkeypatch.setattr(sys, 'argv', [name, '--help'])
        with pytest.raises(SystemExit) as e:
            getattr(tcli, fn)()
        assert e.value.code == 0
        assert 'usage' in capsys.readouterr().out
