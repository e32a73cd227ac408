"""The port's sgm yaml assembly against the JAX package's, on the CPU.

Both stacks of ``tests/test_sgm_config.py`` (the t23d EDM stack and the
multi-view flow-matching stack; this file keeps its own copy of the yaml
texts) load through both packages and agree:

* every spec field, the discretization's σ table and the denoiser's σ
  table: equal;
* the LR schedule over steps 0…30,000, also as the ``lr_lambda`` of
  ``torch.optim.lr_scheduler.LambdaLR``: equal;
* the EDM and FM loss values of a closed-form network written for both
  sides, with JAX's draws rebuilt from its key (EDM: ``k_sigma, k_noise =
  split(key)``, the σ index ``randint(k_sigma)``; FM: ``k_t, k_noise``,
  t = JAX's ``sample_t(k_t)``) and fed as ``sigma_idx`` / ``t`` and
  ``noise``: within 1e-6 relative;
* the Euler EDM sampler with JAX's start (``key, k0 = split(key)``) as
  ``x_init`` and, with churn, its per-step draws as ``noise``: within 1e-5
  of scale.

Each embedder maker builds at toy width and encodes; unknown targets
raise; a parsed mapping loads with ``yaml`` made unimportable, a string
then raises an ``ImportError`` that says so.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from ln3diff_tpu import sgm_config as jsgm
from ln3diff_tpu.diffusion.transport import Transport as JTransport
from ln3diff_tpu_torch import sgm_config as tsgm
from ln3diff_tpu_torch.conditioning.clip import (CLIPTextConfig,
                                                 CLIPVisionConfig)
from ln3diff_tpu_torch.models.vit import vit_registry

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

T23D_YAML = """
ldm_configs:
  scheduler_config:
    target: sgm.lr_scheduler.LambdaLinearScheduler
    params:
      warm_up_steps: [10000]
      cycle_lengths: [10000000000000]
      f_start: [1.e-6]
      f_max: [1.]
      f_min: [1.]
  denoiser_config:
    target: sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser
    params:
      num_idx: 1000
      scaling_config:
        target: sgm.modules.diffusionmodules.denoiser_scaling.EpsScaling
      discretization_config:
        target: sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization
  conditioner_config:
    target: sgm.modules.GeneralConditioner
    params:
      emb_models:
        - is_trainable: False
          input_key: caption
          ucg_rate: 0.1
          target: sgm.modules.encoders.modules.FrozenCLIPEmbedder
          params:
            always_return_pooled: True
  loss_fn_config:
    target: sgm.modules.diffusionmodules.loss.StandardDiffusionLoss
    params:
      loss_weighting_config:
        target: sgm.modules.diffusionmodules.loss_weighting.EpsWeighting
      sigma_sampler_config:
        target: sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling
        params:
          num_idx: 1000
  sampler_config:
    target: sgm.modules.diffusionmodules.sampling.EulerEDMSampler
    params:
      num_steps: 250
      guider_config:
        target: sgm.modules.diffusionmodules.guiders.VanillaCFG
        params:
          scale: 6.5
"""

FM_YAML = """
ldm_configs:
  conditioner_config:
    target: sgm.modules.GeneralConditioner
    params:
      emb_models:
        - is_trainable: False
          input_key: 'img-c'
          ucg_rate: 0.1
          target: sgm.modules.encoders.modules.FrozenDinov2ImageEmbedderMVPlucker
          params:
            arch: vits
            n_cond_frames: 2
  loss_fn_config:
    target: sgm.modules.diffusionmodules.loss.FMLoss
    params:
      transport_config:
        target: transport.create_transport
        params:
          snr_type: lognorm
  guider_config:
    target: sgm.modules.diffusionmodules.guiders.VanillaCFG
    params:
      scale: 5.0
"""

STACKS = {'t23d': T23D_YAML, 'fm': FM_YAML}


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


def _plain(obj):
    """A spec as plain values: dataclasses field by field, the
    denoiser's σ table and scaling, the scheduler's lists."""
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if hasattr(obj, 'cum_cycles'):
        return {k: _plain(getattr(obj, k)) for k in (
            'warm_up_steps', 'f_min', 'f_max', 'f_start', 'cycle_lengths')}
    if hasattr(obj, 'sigmas'):
        return {'sigmas': np.asarray(obj.sigmas).tolist(),
                'scaling': _plain(obj.scaling),
                'quantize_c_noise': obj.quantize_c_noise}
    raise TypeError(type(obj))


@pytest.mark.parametrize('stack', sorted(STACKS))
def test_stack_fields_match_jax(stack):
    got = tsgm.load_ldm_configs(STACKS[stack])
    want = jsgm.load_ldm_configs(STACKS[stack])
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert _plain(getattr(got, f.name)) == \
            _plain(getattr(want, f.name)), f.name


def test_scheduler_matches_jax_and_drives_lambda_lr():
    got = tsgm.load_ldm_configs(T23D_YAML).scheduler
    want = jsgm.load_ldm_configs(T23D_YAML).scheduler
    steps = range(30001)
    assert [got(s) for s in steps] == [want(s) for s in steps]
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda=got)
    lrs = []
    for _ in steps:
        lrs.append(opt.param_groups[0]['lr'])
        opt.step()
        sched.step()
    assert lrs == [1e-4 * want(s) for s in steps]
    multi = dict(warm_up_steps=[10, 20], f_min=[0.1, 0.2], f_max=[1.0, 0.5],
                 f_start=[0.0, 0.0], cycle_lengths=[100, 200])
    a = tsgm.LambdaLinearScheduler(**multi)
    b = jsgm.LambdaLinearScheduler(**multi)
    assert [a(s) for s in range(400)] == [b(s) for s in range(400)]


@pytest.mark.parametrize('n', [4, 50, 250, 1000])
def test_discretization_table_matches_jax(n):
    target = ('sgm.modules.diffusionmodules.discretizer.'
              'LegacyDDPMDiscretization')
    cfg = {'target': target, 'params': {'linear_end': 0.02}}
    np.testing.assert_array_equal(tsgm.instantiate_from_config(cfg)(n),
                                  jsgm.instantiate_from_config(cfg)(n))
    np.testing.assert_array_equal(
        tsgm.load_ldm_configs(T23D_YAML).sampler.discretization(n),
        jsgm.load_ldm_configs(T23D_YAML).sampler.discretization(n))


# -- losses and the sampler --------------------------------------------------------

SHAPE = (2, 4, 4, 3)


def _cond(seed=0):
    return np.random.default_rng(seed).standard_normal((2, 3)).astype(
        np.float32)


def _jnet(x, t, c):
    t = jnp.asarray(t, jnp.float32).reshape(-1, 1, 1, 1)
    return jnp.tanh(0.7 * x + 0.002 * t) + 0.3 * c['v'][:, None, None, :]


def _tnet(x, t, c):
    t = t.float().reshape(-1, 1, 1, 1)
    return torch.tanh(0.7 * x + 0.002 * t) + 0.3 * c['v'][:, None, None, :]


def _x0(seed=1):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_edm_loss_matches_jax(seed):
    jstack = jsgm.load_ldm_configs(T23D_YAML)
    tstack = tsgm.load_ldm_configs(T23D_YAML)
    key = jax.random.PRNGKey(seed)
    x0, c = _x0(seed), _cond(seed)
    want = jstack.loss.make_loss_fn(jstack.denoiser)(
        _jnet, jnp.asarray(x0), key, {'v': jnp.asarray(c)})
    k_sigma, k_noise = jax.random.split(key)
    idx = np.array(jax.random.randint(k_sigma, (2,), 0, 1000))
    noise = np.array(jax.random.normal(k_noise, SHAPE, jnp.float32))
    got = tstack.loss.make_loss_fn(tstack.denoiser)(
        _tnet, torch.from_numpy(x0), {'v': torch.from_numpy(c)},
        sigma_idx=torch.from_numpy(idx), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # from a generator: the same shape, finite
    drawn = tstack.loss.make_loss_fn()(
        _tnet, torch.from_numpy(x0), {'v': torch.from_numpy(c)},
        generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2,) and torch.isfinite(drawn).all()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_fm_loss_matches_jax(seed):
    jstack = jsgm.load_ldm_configs(FM_YAML)
    tstack = tsgm.load_ldm_configs(FM_YAML)
    key = jax.random.PRNGKey(seed)
    x0, c = _x0(seed), _cond(seed)
    want = jstack.loss.make_loss_fn()(_jnet, jnp.asarray(x0), key,
                                      {'v': jnp.asarray(c)})
    k_t, k_noise = jax.random.split(key)
    t = np.array(JTransport(jstack.loss.transport).sample_t(k_t, 2))
    noise = np.array(jax.random.normal(k_noise, SHAPE, jnp.float32))
    got = tstack.loss.make_loss_fn()(
        _tnet, torch.from_numpy(x0), {'v': torch.from_numpy(c)},
        t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize('churn', [0.0, 2.0])
def test_euler_sampler_matches_jax(churn):
    jstack = jsgm.load_ldm_configs(T23D_YAML)
    tstack = tsgm.load_ldm_configs(T23D_YAML)
    steps = 5
    jspec = dataclasses.replace(jstack.sampler, num_steps=steps,
                                s_churn=churn)
    tspec = dataclasses.replace(tstack.sampler, num_steps=steps,
                                s_churn=churn)
    c, uc = _cond(3), _cond(4)
    key = jax.random.PRNGKey(7)
    want = jspec.sample(jstack.denoiser, _jnet, SHAPE, key,
                        {'v': jnp.asarray(c)}, {'v': jnp.asarray(uc)})
    key, k0 = jax.random.split(key)
    x_init = np.asarray(jax.random.normal(k0, SHAPE))
    noise = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k, SHAPE)))
    got = tspec.sample(tstack.denoiser, _tnet, SHAPE,
                       {'v': torch.from_numpy(c)}, {'v': torch.from_numpy(uc)},
                       x_init=torch.from_numpy(x_init),
                       noise=torch.from_numpy(np.stack(noise)))
    _close(got.numpy(), want, 1e-5)


# -- the embedders ----------------------------------------------------------------

TOY_VIT = vit_registry('dinov2-s/14', img_size=28, embed_dim=32, depth=2,
                       num_heads=2)
TOY = {
    'clip_text': CLIPTextConfig(hidden_size=32, num_layers=1, num_heads=2,
                                intermediate_size=64),
    'clip_image': CLIPVisionConfig(image_size=28, patch_size=14,
                                   hidden_size=32, num_layers=1,
                                   num_heads=2, intermediate_size=64),
    'dino': TOY_VIT,
}


def _cameras(B, V):
    c = np.zeros((B, V, 25), np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.0
    intr = np.array([[1.1, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]], np.float32)
    c[..., :16] = c2w.reshape(-1)
    c[..., 16:] = intr.reshape(-1)
    return c


def _maker_input(maker):
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, 28, 28, 3)).astype(np.float32)
    return {
        'clip_text': ['a chair', 'a lamp'],
        'clip_image': img,
        'clip_image_mv': rng.uniform(-1, 1, (2, 3, 28, 28, 3)).astype(
            np.float32),
        'dino': img,
        'dino_mv': rng.uniform(-1, 1, (2, 3, 28, 28, 3)).astype(np.float32),
        'dino_mv_plucker': (rng.uniform(-1, 1, (2, 3, 28, 28, 3)).astype(
            np.float32), _cameras(2, 3)),
        'concat_timestep': np.array([[256, 256], [512, 384]], np.float32),
    }[maker]


_OUT_KEYS = {'clip_text': {'crossattn', 'vector'},
             'clip_image': {'crossattn', 'vector'},
             'clip_image_mv': {'crossattn', 'vector'},
             'dino': {'dino'}, 'dino_mv': {'dino'},
             'dino_mv_plucker': {'dino'}, 'concat_timestep': {'vector'}}


@pytest.mark.parametrize('maker', sorted(_OUT_KEYS))
def test_embedder_maker_builds_at_toy_width(maker):
    spec = tsgm.EmbedderSpec(maker=maker, input_key='x', ucg_rate=0.1,
                             options={'n_cond_frames': 2, 'outdim': 8})
    cfg = TOY.get(maker.split('_mv')[0])
    emb = spec.build(torch.Generator().manual_seed(0), device='cpu',
                     model_cfg=cfg)
    assert emb.ucg_rate == 0.1
    out = emb.encode(_maker_input(maker))
    assert set(out) == _OUT_KEYS[maker]
    for v in out.values():
        assert v.shape[0] == 2 and torch.isfinite(v.float()).all()
    if maker in ('dino_mv', 'dino_mv_plucker'):
        assert out['dino'].shape[1] == 2 * ((28 // 14)**2 + 1)
    if maker == 'concat_timestep':
        assert out['vector'].shape == (2, 16)
    uc = emb.uncond(2)
    assert {k: tuple(v.shape[1:]) for k, v in uc.items()} == \
        {k: tuple(v.shape[1:]) for k, v in out.items()}
    # the same generator seed draws the same tower
    again = spec.build(torch.Generator().manual_seed(0), device='cpu',
                       model_cfg=cfg).encode(_maker_input(maker))
    for k in out:
        torch.testing.assert_close(again[k], out[k], rtol=0, atol=0)


def test_conditioner_builds_from_the_fm_stack():
    spec = tsgm.load_ldm_configs(FM_YAML).conditioner
    cond = spec.build(torch.Generator().manual_seed(0), device='cpu',
                      model_cfgs={'dino_mv_plucker': TOY_VIT})
    inp = _maker_input('dino_mv_plucker')
    c, uc = cond.get_unconditional_conditioning({'img-c': inp})
    assert c['dino'].shape == (2, 2 * 5, 32)
    assert uc['dino'].shape == c['dino'].shape
    assert float(uc['dino'].abs().max()) == 0.0


def test_unknown_targets_raise():
    with pytest.raises(ValueError, match='unknown target'):
        tsgm.instantiate_from_config({'target': 'sgm.made.up.Thing'})
    with pytest.raises(KeyError, match='target'):
        tsgm.instantiate_from_config({'params': {}})
    bad = {'ldm_configs': {'conditioner_config': {
        'target': 'sgm.modules.GeneralConditioner',
        'params': {'emb_models': [{'target': 'x.NoSuchEmbedder',
                                   'input_key': 'x'}]}}}}
    with pytest.raises(ValueError, match='unknown embedder target'):
        tsgm.load_ldm_configs(bad)
    with pytest.raises(ValueError, match='unknown embedder maker'):
        tsgm.EmbedderSpec(maker='nope', input_key='x').build(device='cpu')


def test_mapping_loads_without_yaml(monkeypatch, tmp_path):
    doc = yaml.safe_load(T23D_YAML)
    path = tmp_path / 't23d.yaml'
    path.write_text(T23D_YAML)
    from_file = _plain(tsgm.load_ldm_configs(str(path)))
    monkeypatch.setitem(sys.modules, 'yaml', None)
    assert _plain(tsgm.load_ldm_configs(doc)) == from_file
    with pytest.raises(ImportError, match='parsed mapping'):
        tsgm.load_ldm_configs(T23D_YAML)
    with pytest.raises(ImportError, match='PyYAML'):
        tsgm.load_ldm_configs(str(path))
