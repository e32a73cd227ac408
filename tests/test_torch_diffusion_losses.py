"""The training half of the port's diffusion modules against the JAX
package's: ``gaussian.py`` ``training_losses``, the VLB terms,
``prior_bpd`` and ``calc_bpd_loop``; ``transport.py`` ``sample_t`` and
``training_losses``; ``edm.py`` (σ tables, scalings, the discrete
denoiser, ``edm_training_loss`` and ``euler_edm_sample``); and
``resample.py``'s loss-aware timestep sampler.

Torch cannot replay ``jax.random``, so each test rebuilds the JAX
function's key splits and hands the port the same draws (noise, t, σ
indices, the sampler's start and step noise).  The model is a closed-form
toy function written once for each side.  Tolerance: 1e-5 of the
output's scale in f32 (the two sides sum in another order); the resampler
is numpy on both sides and matches bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.diffusion import edm as jedm
from ln3diff_tpu.diffusion import gaussian as jg
from ln3diff_tpu.diffusion import resample as jrs
from ln3diff_tpu.diffusion import transport as jtr
from ln3diff_tpu_torch.diffusion import edm as tedm
from ln3diff_tpu_torch.diffusion import gaussian as tg
from ln3diff_tpu_torch.diffusion import resample as trs
from ln3diff_tpu_torch.diffusion import transport as ttr

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

SHAPE = (4, 4, 4, 6)
TOL = 1e-5


def _close(got, want, rel=TOL, msg=''):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    assert got.shape == want.shape, msg
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=msg)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x0(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal(shape) * 0.5, -1, 1).astype(np.float32)


def _toy(xp, learned=False):
    """(x, t) → 0.3·x + 0.01·sin(t/100) and, with ``learned``, a variance
    half tanh(0.5·x) in (−1, 1)."""
    def fn(x, t):
        t = t.astype(xp.float32) if xp is jnp else t.float()
        tt = t.reshape((-1,) + (1,) * (x.ndim - 1))
        mean = 0.3 * x + 0.01 * xp.sin(tt / 100.0)
        if not learned:
            return mean
        cat = jnp.concatenate if xp is jnp else torch.cat
        return cat([mean, xp.tanh(0.5 * x)], -1)
    return fn


# -- gaussian.py: the loss helpers and the training losses ------------------

def test_loss_helpers_match_jax():
    rng = np.random.default_rng(1)
    a, b, c, d = (rng.standard_normal(SHAPE).astype(np.float32)
                  for _ in range(4))
    x = np.clip(a, -1, 1)
    x[0, 0, 0, :3] = [-1.0, 1.0, 0.9995]
    _close(tg.normal_kl(_t(a), _t(b), _t(c), _t(d)),
           jg.normal_kl(a, b, c, d))
    _close(tg.approx_standard_normal_cdf(_t(a)),
           jg.approx_standard_normal_cdf(a))
    # scales of a posterior (σ 0.03–0.2): every bin's mass is far above the
    # 1e-12 clamp, where an ulp of the CDF would move the log by orders
    log_scales = (-2.5 + 0.3 * np.tanh(d)).astype(np.float32)
    _close(tg.discretized_gaussian_log_likelihood(
        _t(x), means=_t(x + 0.05 * c), log_scales=_t(log_scales)),
        jg.discretized_gaussian_log_likelihood(
            x, means=x + 0.05 * c, log_scales=log_scales))
    _close(tg.mean_flat(_t(a)), jg.mean_flat(a))


# every (mean_type, var_type, loss_type) of the JAX tests and the trainer
LOSS_CASES = [
    ('eps', 'fixed_small', 'mse'),
    ('v', 'fixed_small', 'mse'),
    ('x0', 'fixed_large', 'mse'),
    ('eps', 'learned_range', 'rescaled_mse'),
    ('v', 'learned_range', 'rescaled_mse'),
    ('x0', 'learned_range', 'mse'),
    ('eps', 'learned_range', 'kl'),
    ('v', 'learned_range', 'rescaled_kl'),
]


@pytest.mark.parametrize('mean_type,var_type,loss_type', LOSS_CASES)
def test_training_losses_match_jax(mean_type, var_type, loss_type):
    kw = dict(steps=100, mean_type=mean_type, var_type=var_type,
              loss_type=loss_type)
    jd, td = jg.make_diffusion(**kw), tg.make_diffusion(**kw)
    learned = var_type == 'learned_range'
    x0 = _x0()
    t = np.array([0, 7, 42, 99])
    key = jax.random.PRNGKey(3)
    want = jd.training_losses(_toy(jnp, learned), jnp.asarray(x0),
                              jnp.asarray(t), key)
    noise = jax.random.normal(key, x0.shape)
    got = td.training_losses(_toy(torch, learned), _t(x0), _t(t),
                             noise=_t(noise))
    assert sorted(got) == sorted(want)
    for k in want:
        if k in ('vb', 'loss') and 'vb' in want:
            # t = 0 is the decoder NLL, log(Φ(b+) − Φ(b−)) of bins 1/255
            # wide: the difference cancels most of f32's digits, and with a
            # poor x0 prediction both sides sit 1.5% from the f64 value
            # (4.7e-5 apart).  Held to 1e-4 of scale; t > 0 to 1e-5.
            _close(got[k][:1], want[k][:1], rel=1e-4, msg=k)
            _close(got[k][1:], want[k][1:], msg=k)
        else:
            _close(got[k], want[k], msg=k)


def test_vb_trains_only_the_variance_half():
    """The VLB term reaches the variance half and not the mean half (the
    mean is detached), as ``tests/test_diffusion.py`` holds JAX's."""
    d = tg.make_diffusion(steps=50, var_type='learned_range',
                          loss_type='rescaled_mse')
    out = torch.randn((2, 4, 4, 4), requires_grad=True)
    terms = d.training_losses(lambda x, t: out, torch.randn(2, 4, 4, 2),
                              torch.tensor([3, 40]),
                              noise=torch.randn(2, 4, 4, 2))
    terms['vb'].sum().backward()
    mean_g, var_g = out.grad.chunk(2, dim=-1)
    assert float(mean_g.abs().max()) == 0.0
    assert float(var_g.abs().max()) > 0.0


def test_bpd_loop_and_prior_match_jax():
    """``calc_bpd_loop`` over 50 steps (step i's noise from JAX's i-th
    split key) and ``prior_bpd``, learned-range variances."""
    kw = dict(steps=50, mean_type='eps', var_type='learned_range')
    jd, td = jg.make_diffusion(**kw), tg.make_diffusion(**kw)
    x0 = _x0(2, (2, 4, 4, 2))
    key = jax.random.PRNGKey(5)
    want = jd.calc_bpd_loop(_toy(jnp, True), jnp.asarray(x0), key)
    keys = jax.random.split(key, jd.num_timesteps)
    noise = np.stack([np.asarray(jax.random.normal(k, x0.shape))
                      for k in keys])
    got = td.calc_bpd_loop(_toy(torch, True), _t(x0), noise=_t(noise))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], msg=k)
    _close(td.prior_bpd(_t(x0)), jd.prior_bpd(jnp.asarray(x0)))


# -- transport.py ------------------------------------------------------------

@pytest.mark.parametrize('t_sampling,train_eps', [('lognorm', 0.0),
                                                  ('uniform', 0.0),
                                                  ('lognorm', 0.05)])
def test_transport_sample_t_and_loss_match_jax(t_sampling, train_eps):
    spec = dict(t_sampling=t_sampling, train_eps=train_eps)
    jt = jtr.Transport(jtr.TransportSpec(**spec))
    tt = ttr.Transport(ttr.TransportSpec(**spec))
    x1 = _x0(4)
    key = jax.random.PRNGKey(6)
    want = jt.training_losses(_toy(jnp), jnp.asarray(x1), key)
    k_t, k_noise = jax.random.split(key)
    draw = jax.random.normal if t_sampling == 'lognorm' \
        else jax.random.uniform
    u = draw(k_t, (x1.shape[0],))
    t = tt.sample_t(x1.shape[0], u=_t(u))
    _close(t, jt.sample_t(k_t, x1.shape[0]))
    got = tt.training_losses(_toy(torch), _t(x1), t=t,
                             noise=_t(jax.random.normal(k_noise, x1.shape)))
    for k in want:
        _close(got[k], want[k], msg=k)
    # drawn by the port: t inside the training interval
    g = torch.Generator().manual_seed(0)
    t = tt.sample_t(1000, generator=g)
    assert float(t.min()) >= train_eps and float(t.max()) <= 1 - train_eps


def test_create_transport_fields():
    tr = ttr.create_transport('Linear', 'velocity', 'uniform')
    assert tr.spec.t_sampling == 'uniform' and tr.spec.path == 'linear'
    with pytest.raises(NotImplementedError):
        ttr.create_transport('Linear', 'noise')


# -- edm.py ------------------------------------------------------------------

def test_sigma_tables_and_scalings_match_jax():
    for n in (1000, 250, 25):
        np.testing.assert_array_equal(tedm.legacy_ddpm_sigmas(n),
                                      jedm.legacy_ddpm_sigmas(n))
    sigma = np.array([0.03, 0.5, 1.0, 4.0, 14.0], np.float32)
    for kind in ('eps', 'v', 'v-edm-cnoise', 'edm'):
        got = tedm.ScalingFns(kind)(_t(sigma))
        want = jedm.ScalingFns(kind)(jnp.asarray(sigma))
        for g, w in zip(got, want):
            _close(g, w, msg=kind)


def _edm_net(xp):
    def net(x, c_noise, cond):
        c = c_noise.astype(xp.float32) if xp is jnp else c_noise.float()
        c = c.reshape((-1,) + (1,) * (x.ndim - 1))
        out = xp.tanh(0.5 * x + c / 1000.0)
        if cond is not None:
            out = out + 0.1 * cond['v'].reshape(out.shape[0], 1, 1, 1)
        return out
    return net


@pytest.mark.parametrize('scaling', ['eps', 'v', 'edm'])
def test_discrete_denoiser_matches_jax(scaling):
    x = _x0(7)
    sigma = np.array([0.03, 0.9, 3.3, 14.0], np.float32)
    jden = jedm.DiscreteDenoiser(scaling=scaling)
    tden = tedm.DiscreteDenoiser(scaling=scaling)
    np.testing.assert_array_equal(tden.sigmas.numpy(), np.asarray(jden.sigmas))
    assert np.array_equal(tden.sigma_to_idx(_t(sigma)).numpy(),
                          np.asarray(jden.sigma_to_idx(jnp.asarray(sigma))))
    _close(tden(_edm_net(torch), _t(x), _t(sigma), None),
           jden(_edm_net(jnp), jnp.asarray(x), jnp.asarray(sigma), None))


@pytest.mark.parametrize('weighting', ['eps', 'unit'])
def test_edm_training_loss_matches_jax(weighting):
    den_j, den_t = jedm.DiscreteDenoiser(), tedm.DiscreteDenoiser()
    x0 = _x0(8)
    key = jax.random.PRNGKey(9)
    want = jedm.edm_training_loss(den_j, _edm_net(jnp), jnp.asarray(x0), key,
                                  None, loss_weighting=weighting)
    k_sigma, k_noise = jax.random.split(key)
    idx = jax.random.randint(k_sigma, (x0.shape[0],), 0, 1000)
    got = tedm.edm_training_loss(
        den_t, _edm_net(torch), _t(x0), None, loss_weighting=weighting,
        sigma_idx=_t(idx).long(),
        noise=_t(jax.random.normal(k_noise, x0.shape)))
    _close(got, want)
    _close(tedm.discrete_sigma_sampler(4, idx=_t(idx).long()),
           jedm.discrete_sigma_sampler(k_sigma, 4))


@pytest.mark.parametrize('s_churn', [0.0, 2.0])
def test_euler_edm_sample_matches_jax(s_churn):
    """Eight Euler steps with CFG 3.0 from JAX's start noise and, with
    churn, its per-step noise (``key, k = split(key)`` per step)."""
    shape, steps = (2, 4, 4, 6), 8
    cond = {'v': np.array([[1.0], [0.5]], np.float32)}
    uc = {'v': np.zeros((2, 1), np.float32)}
    key = jax.random.PRNGKey(10)
    want = jedm.euler_edm_sample(
        jedm.DiscreteDenoiser(), _edm_net(jnp), shape, key,
        {k: jnp.asarray(v) for k, v in cond.items()},
        {k: jnp.asarray(v) for k, v in uc.items()}, num_steps=steps,
        cfg_scale=3.0, s_churn=s_churn)
    key, k0 = jax.random.split(key)
    x_init = jax.random.normal(k0, shape)
    noise = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k, shape)))
    got = tedm.euler_edm_sample(
        tedm.DiscreteDenoiser(), _edm_net(torch), shape,
        {k: _t(v) for k, v in cond.items()},
        {k: _t(v) for k, v in uc.items()}, num_steps=steps, cfg_scale=3.0,
        s_churn=s_churn, x_init=_t(x_init), noise=_t(np.stack(noise)))
    _close(got, want)


# -- resample.py -------------------------------------------------------------

def test_resampler_matches_jax_bit_for_bit():
    """From one numpy generator and one loss stream, both resamplers draw
    the same t and weights through the warm-up and after it."""
    T = 16
    jr_, tr_ = (m.LossSecondMomentResampler(T, history_per_term=3)
                for m in (jrs, trs))
    g_j, g_t = np.random.default_rng(11), np.random.default_rng(11)
    losses = np.random.default_rng(12)
    for step in range(30):
        tj, wj = jr_.sample(g_j, 8)
        tt, wt = tr_.sample(g_t, 8)
        assert tj.dtype == tt.dtype and wj.dtype == wt.dtype
        assert np.array_equal(tj, tt) and np.array_equal(wj, wt), step
        values = losses.uniform(0.1, 2.0, 8) * (1 + tj / T)
        jr_.update_with_losses(tj, values)
        tr_.update_with_losses(tt, values)
    assert tr_._warmed_up()
    np.testing.assert_array_equal(tr_.weights(), jr_.weights())
    assert tr_.weights().std() > 0


def test_uniform_timesteps():
    t, w = trs.uniform_timesteps(500, 10,
                                 generator=torch.Generator().manual_seed(0))
    assert t.dtype == torch.int64 and int(t.min()) == 0 and int(t.max()) == 9
    assert torch.equal(w, torch.ones(500))
