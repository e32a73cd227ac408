"""Every sampler of the port against the JAX package's, with JAX's random
draws fed in: DDPM (``p_sample_loop``), DDIM at η = 0 and η > 0, PLMS,
DPM-Solver++(2M) with both skip types, reverse DDIM and the transport's
SDE; with ``learned_range`` variances, LSGM mixing in both spaces,
v-prediction, ``clip_denoised``, ``rescale_timesteps`` and
``guided_channels``.

Torch cannot replay ``jax.random``, so each test rebuilds JAX's key-split
sequence on the JAX side and hands the port the same start noise
(``x_init``) and per-step draws (``noise``).  Two denoisers: a closed-form
toy function, identical on both sides (tolerance 1e-5 of the sample's
scale), and a small text DiT carried by ``bridge.dit_state_dict``, f32 on
both sides (1e-4 of scale: a sampler multiplies early differences by up
to √(1/ᾱ_t)).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.diffusion import dpm_solver as jdpm
from ln3diff_tpu.diffusion import gaussian as jg
from ln3diff_tpu.diffusion import transport as jtr
from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.diffusion import dpm_solver as tdpm
from ln3diff_tpu_torch.diffusion import gaussian as tg
from ln3diff_tpu_torch.diffusion import transport as ttr
from ln3diff_tpu_torch.models import dit as tdit

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

SHAPE = (2, 4, 4, 12)
C = SHAPE[-1]
TOY_TOL, DIT_TOL = 1e-5, 1e-4


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _toy(xp, learned=False):
    """A closed-form denoiser: mean half 0.3·x + 0.01·sin(t/100) and, with
    ``learned``, a variance half tanh(0.5·x) in (−1, 1)."""
    def fn(x, t):
        tt = t.astype(jnp.float32) if xp is jnp else t.float()
        out = 0.3 * x + 0.01 * xp.sin(tt / 100.0).reshape(-1, 1, 1, 1)
        if learned:
            out = xp.concatenate([out, xp.tanh(0.5 * x)], axis=-1) \
                if xp is jnp else torch.cat([out, torch.tanh(0.5 * x)], -1)
        return out
    return fn


def _draws(key, steps, start=True):
    """JAX's draws of a sampler that does ``key, k0 = split(key)`` for the
    start (``start``) and ``key, k = split(key)`` once per step: (x0,
    (steps, *SHAPE) stack, as numpy)."""
    x0 = None
    if start:
        key, k0 = jax.random.split(key)
        x0 = np.asarray(jax.random.normal(k0, SHAPE))
    zs = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(k, SHAPE)))
    return x0, np.stack(zs)


LOGIT = np.random.default_rng(3).standard_normal((1, 1, 1, C)) \
    .astype(np.float32)

# (mean_type, var_type, mixed_prediction, clip_denoised, rescale)
OPTIONS = {
    'eps': ('eps', 'fixed_small', False, False, False),
    'v_learned_mixed': ('v', 'learned_range', True, False, False),
    'x0_mixed_clip': ('x0', 'fixed_large', True, True, False),
    'eps_mixed_rescaled': ('eps', 'fixed_small', True, False, True),
    'v_clip_learned': ('v', 'learned_range', False, True, False),
}


def _pair(option, respacing='10'):
    mean, var, mixed, clip, rescale = OPTIONS[option]
    kw = dict(mean_type=mean, var_type=var, timestep_respacing=respacing,
              mixed_prediction=mixed, rescale_timesteps=rescale)
    j, t = jg.make_diffusion(**kw), tg.make_diffusion(**kw)
    if clip:
        j.spec = dataclasses.replace(j.spec, clip_denoised=True)
        t.spec = dataclasses.replace(t.spec, clip_denoised=True)
    return j, t, var == 'learned_range', mixed


def test_new_tables_and_scale_t():
    j = jg.make_diffusion(timestep_respacing='ddim25',
                          rescale_timesteps=True)
    t = tg.make_diffusion(timestep_respacing='ddim25',
                          rescale_timesteps=True)
    np.testing.assert_array_equal(t.table('alphas_cumprod_next',
                                          'cpu').numpy(),
                                  np.asarray(j.alphas_cumprod_next))
    idx = np.arange(25)
    got = t.scale_t(torch.from_numpy(idx))
    want = np.asarray(j.scale_t(jnp.asarray(idx)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the DiT's timestep embedding takes float t as it comes
    from ln3diff_tpu_torch.models.layers import timestep_embedding
    torch.testing.assert_close(timestep_embedding(got, 8),
                               timestep_embedding(got.double(), 8))


@pytest.mark.parametrize('option', sorted(OPTIONS))
def test_p_mean_variance(option):
    j, t, learned, mixed = _pair(option)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    out = rng.standard_normal(SHAPE[:-1] + (2 * C if learned else C,)) \
        .astype(np.float32)
    if learned:
        out[..., C:] = np.tanh(out[..., C:])
    ts = np.array([0, 7])
    logit = LOGIT if mixed else None
    want = j.p_mean_variance(jnp.asarray(out), jnp.asarray(x),
                             jnp.asarray(ts),
                             None if logit is None else jnp.asarray(logit))
    got = t.p_mean_variance(_t(out), _t(x), _t(ts),
                            None if logit is None else _t(logit))
    for g, w in zip(got, want):
        _close(g.numpy(), w, TOY_TOL)


@pytest.mark.parametrize('option', sorted(OPTIONS))
def test_p_sample_loop(option):
    j, t, learned, mixed = _pair(option)
    key = jax.random.PRNGKey(1)
    logit = LOGIT if mixed else None
    want = j.p_sample_loop(_toy(jnp, learned), SHAPE, key,
                           mixing_logit=None if logit is None
                           else jnp.asarray(logit))
    x0, zs = _draws(key, j.num_timesteps)
    got = t.p_sample_loop(_toy(torch, learned), SHAPE, device='cpu',
                          mixing_logit=None if logit is None else _t(logit),
                          x_init=_t(x0), noise=_t(zs))
    _close(got, want, TOY_TOL)


@pytest.mark.parametrize('eta', [0.0, 0.6])
@pytest.mark.parametrize('option', ['eps', 'v_learned_mixed',
                                    'x0_mixed_clip'])
def test_ddim_eta(option, eta):
    j, t, learned, mixed = _pair(option)
    key = jax.random.PRNGKey(2)
    logit = LOGIT if mixed else None
    want = j.ddim_sample_loop(_toy(jnp, learned), SHAPE, key, eta=eta,
                              mixing_logit=None if logit is None
                              else jnp.asarray(logit))
    x0, zs = _draws(key, j.num_timesteps)
    got = t.ddim_sample_loop(_toy(torch, learned), SHAPE, device='cpu',
                             eta=eta, x_init=_t(x0),
                             noise=_t(zs) if eta else None,
                             mixing_logit=None if logit is None
                             else _t(logit))
    _close(got, want, TOY_TOL)


@pytest.mark.parametrize('option', ['eps', 'v_learned_mixed',
                                    'eps_mixed_rescaled'])
def test_plms(option):
    j, t, learned, mixed = _pair(option)
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(4), SHAPE))
    logit = LOGIT if mixed else None
    calls = []

    def counted(x, s):
        calls.append(1)
        return _toy(torch, learned)(x, s)

    want = j.plms_sample_loop(_toy(jnp, learned), SHAPE, None,
                              x_init=jnp.asarray(x0),
                              mixing_logit=None if logit is None
                              else jnp.asarray(logit))
    got = t.plms_sample_loop(counted, SHAPE, device='cpu', x_init=_t(x0),
                             mixing_logit=None if logit is None
                             else _t(logit))
    _close(got, want, TOY_TOL)
    assert len(calls) == t.num_timesteps + 1


@pytest.mark.parametrize('skip_type', ['time_uniform', 'logsnr'])
@pytest.mark.parametrize('option', ['eps', 'v_learned_mixed',
                                    'x0_mixed_clip'])
def test_dpm_solver(option, skip_type):
    j, t, learned, mixed = _pair(option, respacing=None)
    np.testing.assert_array_equal(
        tdpm.dpm_solver_timesteps(1000, 12, t.table('alphas_cumprod', 'cpu')
                                  .numpy(), skip_type=skip_type),
        jdpm.dpm_solver_timesteps(1000, 12, np.asarray(j.alphas_cumprod),
                                  skip_type=skip_type))
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(5), SHAPE))
    logit = LOGIT if mixed else None
    calls = []

    def counted(x, s):
        calls.append(1)
        return _toy(torch, learned)(x, s)

    want = jdpm.dpm_solver_sample_loop(
        j, _toy(jnp, learned), SHAPE, None, num_steps=12,
        noise=jnp.asarray(x0), skip_type=skip_type,
        mixing_logit=None if logit is None else jnp.asarray(logit))
    got = tdpm.dpm_solver_sample_loop(
        t, counted, SHAPE, num_steps=12, device='cpu', x_init=_t(x0),
        skip_type=skip_type,
        mixing_logit=None if logit is None else _t(logit))
    _close(got, want, TOY_TOL)
    assert len(calls) == 13


@pytest.mark.parametrize('option', ['eps', 'v_learned_mixed'])
def test_ddim_reverse(option):
    j, t, learned, mixed = _pair(option)
    x = np.random.default_rng(6).uniform(-1, 1, SHAPE).astype(np.float32)
    logit = LOGIT if mixed else None
    want = j.ddim_reverse_sample_loop(
        _toy(jnp, learned), jnp.asarray(x),
        mixing_logit=None if logit is None else jnp.asarray(logit))
    got = t.ddim_reverse_sample_loop(
        _toy(torch, learned), _t(x),
        mixing_logit=None if logit is None else _t(logit))
    _close(got, want, TOY_TOL)


@pytest.mark.parametrize('path', ['linear', 'gvp'])
def test_sample_sde(path):
    jt = jtr.Transport(jtr.TransportSpec(path=path))
    tt = ttr.Transport(ttr.TransportSpec(path=path))

    def jv(x, t):
        return -0.4 * x + 0.1 * jnp.cos(3 * t).reshape(-1, 1, 1, 1)

    def tv(x, t):
        return -0.4 * x + 0.1 * torch.cos(3 * t).reshape(-1, 1, 1, 1)

    key = jax.random.PRNGKey(7)
    want = jt.sample_sde(jv, SHAPE, key, num_steps=12)
    x0, zs = _draws(key, 12)
    got = tt.sample_sde(tv, SHAPE, num_steps=12, device='cpu',
                        x_init=_t(x0), noise=_t(zs))
    _close(got, want, TOY_TOL)


def test_sample_sde_draws_from_a_generator():
    tt = ttr.Transport()
    a = tt.sample_sde(lambda x, t: -x, SHAPE, num_steps=4,
                      generator=torch.Generator().manual_seed(0))
    b = tt.sample_sde(lambda x, t: -x, SHAPE, num_steps=4,
                      generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.isfinite(a).all()


@pytest.mark.parametrize('guided_channels', [-1, 4])
def test_cfg_guided_channels(guided_channels):
    rng = np.random.default_rng(8)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    c = rng.standard_normal((2, 3, 8)).astype(np.float32)
    u = rng.standard_normal((2, 3, 8)).astype(np.float32)

    def model(xp):
        def fn(xx, tt, context):
            out = xx * xp.mean(context) + tt[:, None, None, None]
            return xp.concatenate([out, -out], axis=-1) if xp is jnp \
                else torch.cat([out, -out], -1)
        return fn

    jf = jg.make_cfg_model_fn(model(jnp), 3.5, {'context': jnp.asarray(u)},
                              guided_channels=guided_channels)
    tf = tg.make_cfg_model_fn(model(torch), 3.5, {'context': _t(u)},
                              guided_channels=guided_channels)
    ts = np.array([3.0, 9.0], np.float32)
    want = jf(jnp.asarray(x), jnp.asarray(ts), context=jnp.asarray(c))
    got = tf(_t(x), _t(ts), context=_t(c))
    _close(got, want, 1e-6)


# -- a small DiT through the bridge -----------------------------------------

DIT_KW = dict(input_size=4, patch_size=2, in_channels=4, hidden_size=32,
              depth=2, num_heads=2, context_dim=16, variant='text',
              exact_gelu=False)


@functools.lru_cache(maxsize=None)
def _dit():
    jm = jdit.DiT_TriLatent(jdit.DiTConfig(dtype=jnp.float32, **DIT_KW))
    ctx = {'crossattn': jnp.zeros((2, 5, 16))}
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                         jnp.zeros((2,)), ctx)
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(p.shape))
        .astype(np.float32), v['params'])
    v = {'params': params, 'constants': v['constants']}
    tm = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32,
                                           **DIT_KW)).eval()
    tm.load_state_dict(bridge.dit_state_dict(
        jax.tree_util.tree_map(np.asarray, v)))
    c = np.random.default_rng(12).standard_normal((2, 5, 16)) \
        .astype(np.float32)
    japply = jax.jit(jm.apply)

    def jfn(x, t):
        return japply(v, x, t, {'crossattn': jnp.asarray(c)})

    def tfn(x, t):
        return tm(x, t, {'crossattn': _t(c)})

    return jfn, tfn


@pytest.mark.parametrize('sampler', ['ddpm', 'ddim_eta', 'plms', 'dpm',
                                     'reverse', 'sde'])
def test_samplers_on_a_small_dit(sampler):
    jfn, tfn = _dit()
    key = jax.random.PRNGKey(9)
    j = jg.make_diffusion(timestep_respacing='8')
    t = tg.make_diffusion(timestep_respacing='8')
    x0, zs = _draws(key, 8)
    if sampler == 'ddpm':
        want = j.p_sample_loop(jfn, SHAPE, key)
        got = t.p_sample_loop(tfn, SHAPE, x_init=_t(x0), noise=_t(zs))
    elif sampler == 'ddim_eta':
        want = j.ddim_sample_loop(jfn, SHAPE, key, eta=1.0)
        got = t.ddim_sample_loop(tfn, SHAPE, eta=1.0, x_init=_t(x0),
                                 noise=_t(zs))
    elif sampler == 'plms':
        want = j.plms_sample_loop(jfn, SHAPE, None, x_init=jnp.asarray(x0))
        got = t.plms_sample_loop(tfn, SHAPE, x_init=_t(x0))
    elif sampler == 'dpm':
        jf, tf = jg.make_diffusion(), tg.make_diffusion()
        want = jdpm.dpm_solver_sample_loop(jf, jfn, SHAPE, None, num_steps=8,
                                           noise=jnp.asarray(x0))
        got = tdpm.dpm_solver_sample_loop(tf, tfn, SHAPE, num_steps=8,
                                          x_init=_t(x0))
    elif sampler == 'reverse':
        x = np.tanh(x0)
        want = j.ddim_reverse_sample_loop(jfn, jnp.asarray(x))
        got = t.ddim_reverse_sample_loop(tfn, _t(x))
    else:
        want = jtr.Transport().sample_sde(jfn, SHAPE, key, num_steps=8)
        got = ttr.Transport().sample_sde(tfn, SHAPE, num_steps=8,
                                         x_init=_t(x0), noise=_t(zs))
    assert got.shape == SHAPE and torch.isfinite(got).all()
    _close(got, want, DIT_TOL)
