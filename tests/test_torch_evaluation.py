"""The port's evaluation against the JAX package's, on the CPU.

* The metric math (``evaluation/metrics.py``) on the same features: bit
  for bit (``assert_array_equal``), since both sides run the same numpy.
* The FID InceptionV3 (``evaluation/inception.py``): ``BasicConv2d`` and
  one block of each kind, A–E with both E pools, within 1e-5 of each
  output's scale; the whole network at 299², batch 2 — ``pool3``, the
  1008 logits and the 2023-d ``mixed_6/conv`` features (JAX's through
  ``mutable=['intermediates']``) — within 1e-4 of scale.  JAX weights
  reach the port through ``bridge.inception_state_dict``; a random
  torchvision-layout state dict (``AuxLogits.*`` and
  ``num_batches_tracked`` included) loads straight into the port and
  gives the tensors of JAX's ``convert_inception_state_dict``, bit for
  bit.
* ``preprocess_uint8``, growing from 64² and shrinking (antialiased)
  from 512², within 2e-5 in [-1, 1] (1e-5 of the 0–255 range).
* Both feature functions against JAX's, within 1e-4 of scale (the CLIP
  tower's JAX weights from ``PRNGKey(0)``, as JAX's function draws them,
  carried by ``bridge.clip_vision_state_dict``), and the evaluator CLI
  with ``--device cpu`` and an ``--inception_weights`` file against JAX's
  ``evaluate_npz`` with the same weights: FID, sFID and IS within 1e-3
  relative, precision and recall equal.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.conditioning import clip as jclip
from ln3diff_tpu.evaluation import inception as jinc
from ln3diff_tpu.evaluation import metrics as jmet
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.evaluation import inception as tinc
from ln3diff_tpu_torch.evaluation import metrics as tmet
from ln3diff_tpu_torch.scripts import evaluator as tcli

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


def _t(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


# -- the metric math -------------------------------------------------------------

def _feats(seed, n=64, d=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * rng.uniform(0.5, 2, d)
            + rng.standard_normal(d)).astype(np.float32)


_METRIC_CASES = {
    'sqrtm_psd': lambda m, a, b: m._sqrtm_psd(np.cov(a, rowvar=False)),
    'frechet_distance': lambda m, a, b: m.frechet_distance(
        *m.feature_statistics(a), *m.feature_statistics(b)),
    'feature_statistics': lambda m, a, b: np.concatenate(
        [s.ravel() for s in m.feature_statistics(a)]),
    'compute_fid': lambda m, a, b: m.compute_fid(a, b),
    'compute_fid_same': lambda m, a, b: m.compute_fid(a, a),
    'inception_score': lambda m, a, b: m.inception_score(a * 3.0),
    'inception_score_splits': lambda m, a, b: m.inception_score(
        a[:7], splits=10),
    'softmax': lambda m, a, b: m._softmax(a),
    'pairwise_d2': lambda m, a, b: m._pairwise_d2(a, b, block=5),
    'precision_recall': lambda m, a, b: np.array(m.precision_recall(a, b)),
    'precision_recall_k5': lambda m, a, b: np.array(
        m.precision_recall(a, b, nhood_size=5)),
}


@pytest.mark.parametrize('case', sorted(_METRIC_CASES))
def test_metric_matches_jax_bit_for_bit(case):
    a, b = _feats(0), _feats(1) + 0.3
    fn = _METRIC_CASES[case]
    np.testing.assert_array_equal(fn(tmet, a, b), fn(jmet, a, b))


def test_eval_result_prints_as_jax():
    kw = dict(fid=1.23456, sfid=None, inception_score=2.5, precision=0.5,
              recall=0.25)
    assert str(tmet.EvalResult(**kw)) == str(jmet.EvalResult(**kw))
    kw['sfid'] = 7.0
    assert str(tmet.EvalResult(**kw)) == str(jmet.EvalResult(**kw))
    assert [f.name for f in dataclasses.fields(tmet.EvalResult)] == \
        [f.name for f in dataclasses.fields(jmet.EvalResult)]


# -- the network ----------------------------------------------------------------

def _jax_like(shapes, seed):
    """Numpy weights in the shapes of a JAX Inception tree: He-scaled
    conv kernels, BN statistics and affine off their init."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == 'kernel':
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ('bn_scale', 'bn_var'):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


_BLOCKS = {
    # name: (JAX module, port module, input channels, spatial size)
    'basic_conv_s2': (lambda: jinc.BasicConv2d(16, (3, 3), strides=(2, 2)),
                      lambda c: tinc.BasicConv2d(c, 16, 3, stride=2), 6, 11),
    'basic_conv_1x7': (lambda: jinc.BasicConv2d(12, (1, 7), padding=(0, 3)),
                       lambda c: tinc.BasicConv2d(c, 12, (1, 7),
                                                  padding=(0, 3)), 6, 9),
    'A': (lambda: jinc.InceptionA(6), lambda c: tinc.InceptionA(c, 6), 8, 9),
    'B': (lambda: jinc.InceptionB(), lambda c: tinc.InceptionB(c), 8, 9),
    'C': (lambda: jinc.InceptionC(16), lambda c: tinc.InceptionC(c, 16),
          8, 9),
    'D': (lambda: jinc.InceptionD(), lambda c: tinc.InceptionD(c), 8, 9),
    'E_avg': (lambda: jinc.InceptionE('avg'),
              lambda c: tinc.InceptionE(c, 'avg'), 8, 7),
    'E_max': (lambda: jinc.InceptionE('max'),
              lambda c: tinc.InceptionE(c, 'max'), 8, 7),
}


@pytest.mark.parametrize('name', sorted(_BLOCKS))
def test_block_matches_jax(name):
    make_j, make_t, cin, hw = _BLOCKS[name]
    x = np.random.default_rng(3).standard_normal(
        (2, hw, hw, cin)).astype(np.float32)
    jm = make_j()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = _jax_like(shapes['params'], 4)
    want = jax.jit(jm.apply)({'params': params}, jnp.asarray(x))
    tm = make_t(cin)
    tm.load_state_dict(bridge.inception_state_dict(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)


@functools.lru_cache(maxsize=None)
def _net():
    """JAX's InceptionV3 with perturbed weights, and the port's with the
    same weights through the bridge."""
    jm = jinc.InceptionV3()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 299, 299, 3)))
    params = _jax_like(shapes['params'], 5)
    tm = tinc.InceptionV3().eval()
    tm.load_state_dict(bridge.inception_state_dict(params))
    return jm, params, tm


def test_whole_network_matches_jax():
    jm, params, tm = _net()
    x = np.random.default_rng(6).uniform(-1, 1, (2, 299, 299, 3)) \
        .astype(np.float32)

    @jax.jit
    def fwd(p, x):
        out, inter = jm.apply({'params': p}, x, mutable=['intermediates'])
        sp = inter['intermediates']['Mixed_6d']['branch1x1']['conv_out'][0]
        return out['pool3'], out['logits'], sp[..., :7].reshape(2, -1)

    pool3, logits, spatial = fwd(params, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out['spatial'].shape == (2, 2023)
    _close(_t(out['pool3']), pool3, 1e-4)
    _close(_t(out['logits']), logits, 1e-4)
    _close(_t(out['spatial']), spatial, 1e-4)


def _torchvision_sd(seed):
    """A random torchvision-layout ``Inception3`` state dict: the port's
    keys with ``num_batches_tracked`` and an auxiliary classifier."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in tinc.InceptionV3().state_dict().items():
        if k.endswith('num_batches_tracked'):
            sd[k] = torch.tensor(0)
        elif k.endswith('running_var') or k.endswith('bn.weight'):
            sd[k] = torch.from_numpy(
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        else:
            sd[k] = torch.from_numpy(
                (0.05 * rng.standard_normal(v.shape)).astype(np.float32))
    sd['AuxLogits.conv0.conv.weight'] = torch.zeros(128, 768, 1, 1)
    sd['AuxLogits.fc.weight'] = torch.zeros(1000, 768)
    return sd


def test_torchvision_state_dict_loads_as_jax_converts_it():
    sd = _torchvision_sd(7)
    tm = tinc.InceptionV3()
    tm.load_state_dict(sd)
    conv = jinc.convert_inception_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    want = bridge.inception_state_dict(conv)
    got = {k: v for k, v in tm.state_dict().items()
           if not k.endswith('num_batches_tracked')}
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(RuntimeError, match='Missing'):
        tinc.InceptionV3().load_state_dict(
            {k: v for k, v in sd.items() if not k.startswith('fc.')})


@pytest.mark.parametrize('hw', [64, 512, 299])
def test_preprocess_uint8_matches_jax(hw):
    imgs = np.random.default_rng(hw).integers(0, 256, (2, hw, hw, 3),
                                              dtype=np.uint8)
    got = tinc.preprocess_uint8(torch.from_numpy(imgs))
    want = jinc.preprocess_uint8(jnp.asarray(imgs))
    assert got.shape == (2, 299, 299, 3)
    _close(_t(got), want, 2e-5)


# -- the feature functions and the CLI -----------------------------------------

def _images(n, hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope='module')
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp('inception') / 'pt_inception.pth'
    torch.save(_torchvision_sd(8), path)
    return str(path)


@pytest.fixture(scope='module')
def jax_inception_fn(weights_file):
    """JAX's extractor on the weights file, memoised per image set so
    that the feature test and the CLI test share its compiles."""
    fn = jmet.make_inception_feature_fn(weights=weights_file, batch_size=2)
    memo = {}

    def cached(images):
        key = images.tobytes()
        if key not in memo:
            memo[key] = fn(images)
        return memo[key]
    return cached


def test_inception_feature_fn_matches_jax(weights_file, jax_inception_fn):
    imgs = _images(4, 48, 9)
    got = tmet.make_inception_feature_fn(weights=weights_file, batch_size=2,
                                         device='cpu')(imgs)
    want = jax_inception_fn(imgs)
    assert [g.shape for g in got] == [(4, 2048), (4, 1008), (4, 2023)]
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_clip_feature_fn_matches_jax():
    cfg = jclip.CLIPVisionConfig(image_size=224, patch_size=14,
                                 hidden_size=256, num_layers=4, num_heads=4,
                                 intermediate_size=512)
    params = jax.jit(jclip.CLIPVisionModel(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    imgs = np.concatenate([_images(2, 160, 10), _images(1, 160, 11)])
    got = tmet.make_clip_feature_fn(
        batch_size=2, device='cpu',
        state_dict=bridge.clip_vision_state_dict(params))(imgs)
    want = jmet.make_clip_feature_fn(batch_size=2)(imgs)
    assert [g.shape for g in got] == [(3, 256), (3, 64), (3, 512)]
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    # without a state dict the tower draws from a seeded generator
    a = tmet.make_clip_feature_fn(device='cpu')(imgs[:1])
    b = tmet.make_clip_feature_fn(device='cpu')(imgs[:1])
    np.testing.assert_array_equal(a[0], b[0])


def test_evaluator_cli_matches_jax(weights_file, jax_inception_fn, tmp_path,
                                   capsys):
    ref = _images(6, 40, 12)
    noise = np.random.default_rng(13).integers(-40, 41, ref.shape)
    smp = np.clip(ref.astype(np.int64) + noise, 0, 255).astype(np.uint8)
    np.savez(tmp_path / 'ref.npz', arr_0=ref)
    np.savez(tmp_path / 'smp.npz', arr_0=smp)
    got = tcli.main([str(tmp_path / 'ref.npz'), str(tmp_path / 'smp.npz'),
                     '--inception_weights', weights_file, '--batch_size',
                     '2', '--device', 'cpu'])
    assert str(got) in capsys.readouterr().out
    want = jmet.evaluate_npz(str(tmp_path / 'ref.npz'),
                             str(tmp_path / 'smp.npz'),
                             feature_fn=jax_inception_fn)
    for name in ('fid', 'sfid', 'inception_score'):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-3, err_msg=name)
    assert (got.precision, got.recall) == (want.precision, want.recall)
    assert got.fid > 0


def test_no_tf32_restores_the_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with tmet.no_tf32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before
