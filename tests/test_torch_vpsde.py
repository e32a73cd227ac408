"""The port's VPSDE (``ln3diff_tpu_torch/diffusion/vpsde.py``) and the
posterior's ``log_p`` / ``normal_entropy`` / ``nll`` against the JAX
package, f32 on both sides, fed JAX's random draws.

Tolerance: 1e-6 of each output's scale, except for the IW quantities
(``test_iw_quantities_match_jax``: the uniform-t modes are held per
element to a bound derived from their conditioning), and where ``t``
comes out of
``inv_var`` (the IW modes ``ll_iw`` and ``drop_sigma2t_iw``): ``-β0 +
sqrt(β0² − 2a·c)`` cancels as ``var → σ²(ε)``, torch and XLA round
``log``/``exp`` an ulp apart, and the cancellation amplifies that in
``t``.  There ``t`` and the quantities computed from it are held to
``T_TOL`` = 2e-5 of scale.  ``log_p`` squares ``(x − μ)/var``: an ulp of
XLA's ``exp`` there is held to ``LOG_P_TOL`` = 4e-6 of scale."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.diffusion import vpsde as jv
from ln3diff_tpu.models import distributions as jdist
from ln3diff_tpu_torch.diffusion import vpsde as tv
from ln3diff_tpu_torch.models import distributions as tdist

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-6
T_TOL = 2e-5
LOG_P_TOL = 4e-6


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rel=TOL, msg=''):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=msg)


SDE = dict(beta_start=0.1, beta_end=20.0, sigma2_0=0.0, time_eps=0.01)


def _uniform_t_f64(t, mode):
    """The uniform-t modes' quantities in f64 from the f32 ``t`` both
    sides share, each with its condition factor: the relative error that
    one unit roundoff in the exponent ``x = β0·t + ½(β1 − β0)·t²`` and in
    ``exp`` becomes.  ``var = 1 − e^{−x}``: an error of (1 + x)·e^{−x}·u
    absolute, (1 + x)·e^{−x}/var relative — large at the smallest t,
    where var → 0; ``m = e^{−x/2}``: (1 + x); every weight divided by
    ``var`` inherits var's factor; ``0.5/(1 − var)`` (``rescale_iw``)
    gets var's absolute error over 1 − var."""
    b0, b1 = SDE['beta_start'], SDE['beta_end']
    t = np.asarray(t, np.float64)
    x = b0 * t + 0.5 * (b1 - b0) * t * t
    var, m, g2 = -np.expm1(-x), np.exp(-0.5 * x), b0 + (b1 - b0) * t
    c_var = 1 + (1 + x) * np.exp(-x) / var
    ll = (g2 / (2 * var), c_var + 1)
    w = {'ll_uniform': ll, 'drop_all_uniform': (np.ones_like(t), 0 * t),
         'drop_sigma2t_uniform': (g2 / 2, 1 + 0 * t),
         'rescale_iw': (0.5 / (1 - var), 1 + (1 + x) / np.exp(-x))}[mode]
    return {'t': (t, 0 * t), 'var_t': (var, c_var), 'm_t': (m, 1 + x),
            'obj_weight_t': w, 'obj_weight_t_ll': ll, 'g2_t': (g2, 1 + 0 * t)}


# ulps per f32 evaluation: exp within 1 ulp, plus the roundings of the
# exponent's polynomial and of the few products and quotients after it
ULPS = 4


@pytest.mark.parametrize('mode', tv.IW_MODES)
def test_iw_quantities_match_jax(mode):
    """Every IW mode from JAX's ``rho`` (uniform of the key).  The IW
    modes are held to ``T_TOL`` of scale (module docstring).  The uniform
    modes compute the same formulas from a bit-equal ``t``, so each
    element of each side is held within ``ULPS`` unit roundoffs of the f64
    value times its condition factor (``_uniform_t_f64``), and the two
    sides to the sum of their bounds."""
    key = jax.random.PRNGKey(3)
    want = jv.VPSDE(**SDE).iw_quantities(key, 64, mode)
    rho = jax.random.uniform(key, (64,))
    got = tv.VPSDE(**SDE).iw_quantities(64, mode, rho=_t(rho))
    if mode in ('ll_iw', 'drop_sigma2t_iw'):
        for name, g, w in zip(want._fields, got, want):
            _close(g, w, T_TOL, msg=f'{mode}.{name}')
        return
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
    ref = _uniform_t_f64(got.t.numpy(), mode)
    u = float(np.finfo(np.float32).eps) / 2
    for name, g, w in zip(want._fields, got, want):
        r, cond = ref[name]
        bound = ULPS * u * np.abs(r) * cond
        g = g.numpy().astype(np.float64).reshape(-1)
        w = np.asarray(w, np.float64).reshape(-1)
        for side, v in (('port', g), ('jax', w)):
            assert (np.abs(v - r) <= bound).all(), (
                mode, name, side, float(np.max(np.abs(v - r) / bound)))
        assert (np.abs(g - w) <= 2 * bound).all(), (mode, name)


def test_iw_quantities_from_a_generator():
    sde = tv.VPSDE()
    a = sde.iw_quantities(8, 'll_iw',
                          generator=torch.Generator().manual_seed(0))
    b = sde.iw_quantities(8, 'll_iw',
                          rho=torch.rand(8, generator=torch.Generator()
                                         .manual_seed(0)))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert float(a.t.min()) >= sde.time_eps - 1e-6
    assert float(a.t.max()) <= 1.0 + 1e-6
    with pytest.raises(ValueError):
        sde.iw_quantities(8, 'nope')


def test_schedule_and_conversions_match_jax():
    rng = np.random.default_rng(0)
    t = rng.uniform(0.01, 1.0, (2,)).astype(np.float32)
    z = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    e = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    js, ts = jv.VPSDE(**SDE), tv.VPSDE(**SDE)
    J = jnp.asarray
    var_j = js.var(J(t)).reshape(-1, 1, 1, 1)
    m_j = js.e2int_f(J(t)).reshape(-1, 1, 1, 1)
    var_t = ts.var(_t(t)).reshape(-1, 1, 1, 1)
    m_t = ts.e2int_f(_t(t)).reshape(-1, 1, 1, 1)
    logsnr_j, logsnr_t = js.log_snr(m_j, var_j), ts.log_snr(m_t, var_t)
    pairs = [
        (ts.g2(_t(t)), js.g2(J(t))), (ts.f(_t(t)), js.f(J(t))),
        (var_t, var_j), (m_t, m_j), (logsnr_t, logsnr_j),
        (ts.inv_var(_t(np.asarray(var_j).ravel())),
         js.inv_var(var_j.ravel())),
        (ts.sample_q(_t(z), _t(e), var_t, m_t),
         js.sample_q(J(z), J(e), var_j, m_j)),
        (ts.mixing_component(_t(z), var_t),
         js.mixing_component(J(z), var_j)),
        (ts.predict_x0_from_eps(_t(z), _t(e), logsnr_t),
         js.predict_x0_from_eps(J(z), J(e), logsnr_j)),
        (ts.predict_eps_from_x0(_t(z), _t(e), logsnr_t),
         js.predict_eps_from_x0(J(z), J(e), logsnr_j)),
        (ts.predict_eps_from_z_and_v(_t(e), var_t, _t(z), m_t),
         js.predict_eps_from_z_and_v(J(e), var_j, J(z), m_j)),
        (ts.predict_x0_from_z_and_v(_t(e), var_t, _t(z), m_t),
         js.predict_x0_from_z_and_v(J(e), var_j, J(z), m_j)),
    ]
    for i, (g, w) in enumerate(pairs):
        rel = T_TOL if i == 5 else TOL
        _close(g, w, rel, msg=str(i))


def _eps_fns(seed):
    """The same toy ε-network on both sides: a per-channel affine map of
    x_t plus a t-dependent offset."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(6).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)

    def jfn(x, t):
        return x * jnp.asarray(a) + jnp.asarray(b) * t.reshape(-1, 1, 1, 1)

    def tfn(x, t):
        return x * _t(a) + _t(b) * t.reshape(-1, 1, 1, 1)

    return jfn, tfn


@pytest.mark.parametrize('mode,mixing', [('drop_sigma2t_iw', True),
                                         ('ll_uniform', False),
                                         ('rescale_iw', True)])
def test_training_losses_and_mixing_match_jax(mode, mixing):
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((3, 4, 4, 6)).astype(np.float32)
    logit = (rng.standard_normal((1, 1, 1, 6)) * 2).astype(np.float32) \
        if mixing else None
    jfn, tfn = _eps_fns(2)
    key = jax.random.PRNGKey(4)
    want = jv.vpsde_training_losses(
        jv.VPSDE(), jfn, jnp.asarray(x0), key, mode=mode,
        mixing_logit=None if logit is None else jnp.asarray(logit))
    k_t, k_n = jax.random.split(key)
    got = tv.vpsde_training_losses(
        tv.VPSDE(), tfn, _t(x0), mode=mode,
        mixing_logit=None if logit is None else _t(logit),
        rho=_t(jax.random.uniform(k_t, (3,))),
        noise=_t(jax.random.normal(k_n, x0.shape)))
    rel = T_TOL if mode.endswith('_iw') and mode != 'rescale_iw' else TOL
    for k in ('loss', 'p_eps_objs', 'x_t', 'pred_eps', 'noise'):
        _close(got[k], want[k], rel, msg=k)
    _close(got['iw'].t, want['iw'].t, rel)


def test_get_mixed_prediction_matches_jax():
    rng = np.random.default_rng(5)
    p, m = rng.standard_normal((2, 2, 3, 3, 6)).astype(np.float32)
    logit = rng.standard_normal((1, 1, 1, 6)).astype(np.float32)
    _close(tv.get_mixed_prediction(True, _t(p), _t(logit), _t(m)),
           jv.get_mixed_prediction(True, jnp.asarray(p), jnp.asarray(logit),
                                   jnp.asarray(m)))
    assert tv.get_mixed_prediction(False, _t(p), _t(logit), _t(m)) \
        .equal(_t(p))
    assert tv.get_mixed_prediction(True, _t(p), None, _t(m)).equal(_t(p))


@pytest.mark.parametrize('mode', ['ll_iw', 'll_uniform'])
def test_cross_entropy_and_kl_terms_match_jax(mode):
    rng = np.random.default_rng(6)
    x0 = rng.standard_normal((3, 4, 4, 6)).astype(np.float32)
    logit = rng.standard_normal((1, 1, 1, 6)).astype(np.float32)
    jfn, tfn = _eps_fns(7)
    key = jax.random.PRNGKey(8)
    want = jv.vpsde_cross_entropy_per_dim(
        jv.VPSDE(), jfn, jnp.asarray(x0), key, mode=mode,
        mixing_logit=jnp.asarray(logit))
    k_t, k_n = jax.random.split(key)
    got = tv.vpsde_cross_entropy_per_dim(
        tv.VPSDE(), tfn, _t(x0), mode=mode, mixing_logit=_t(logit),
        rho=_t(jax.random.uniform(k_t, (3,))),
        noise=_t(jax.random.normal(k_n, x0.shape)))
    rel = T_TOL if mode == 'll_iw' else TOL
    _close(got, want, rel)
    with pytest.raises(ValueError):
        tv.vpsde_cross_entropy_per_dim(tv.VPSDE(), tfn, _t(x0),
                                       mode='drop_sigma2t_iw')
    # the vada KL and the balancer on the CE and a log q
    log_q = rng.standard_normal(x0.shape).astype(np.float32)
    wk, wd = jv.kl_per_group_vada(jnp.asarray(log_q), want)
    gk, gd = tv.kl_per_group_vada(_t(log_q), got)
    _close(gk, wk, rel)
    _close(gd, wd, rel)
    kl_all = rng.standard_normal((5, 3)).astype(np.float32)
    for balance in (False, True):
        _close(tv.kl_balancer(_t(kl_all), 0.7, balance),
               jv.kl_balancer(jnp.asarray(kl_all), 0.7, balance))
    for g, w in zip(tv.kl_per_group(_t(kl_all)),
                    jv.kl_per_group(jnp.asarray(kl_all))):
        _close(g, w)
    # rank-2 inputs take kl_diag over the batch only
    gk, gd = tv.kl_per_group_vada(_t(kl_all), _t(kl_all * 0.5))
    wk, wd = jv.kl_per_group_vada(jnp.asarray(kl_all),
                                  jnp.asarray(kl_all * 0.5))
    _close(gk, wk)
    _close(gd, wd)


def test_kl_balancer_stops_the_gradient_of_its_weights():
    kl = torch.tensor([[1.0, 3.0], [2.0, -1.0]], requires_grad=True)
    tv.kl_balancer(kl, 1.0, balance=True).backward()
    alpha = kl.detach().abs().mean(0)
    alpha = alpha * 2 / alpha.sum()
    torch.testing.assert_close(kl.grad, alpha.expand(2, 2) / 2)


def test_sample_ode_matches_jax():
    """The Euler ODE from JAX's start noise (``split(key)[1]``)."""
    jfn, tfn = _eps_fns(9)
    key = jax.random.PRNGKey(10)
    shape = (2, 4, 4, 6)
    want = jv.VPSDE().sample_ode(jfn, shape, key, num_steps=20,
                                 temperature=0.8)
    _, k0 = jax.random.split(key)
    got = tv.VPSDE().sample_ode(tfn, shape, num_steps=20, temperature=0.8,
                                x_init=_t(jax.random.normal(k0, shape)))
    _close(got, want, 1e-5)
    # from a generator: the same as passing its draw
    g = torch.Generator().manual_seed(0)
    a = tv.VPSDE().sample_ode(tfn, shape, num_steps=3, generator=g)
    b = tv.VPSDE().sample_ode(tfn, shape, num_steps=3, x_init=torch.randn(
        shape, generator=torch.Generator().manual_seed(0)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_posterior_log_p_entropy_nll_match_jax():
    """``log_p`` divides by var and subtracts logvar, as JAX (and the
    reference) do."""
    rng = np.random.default_rng(11)
    mean = rng.standard_normal((2, 3, 3, 4, 3)).astype(np.float32)
    logvar = rng.standard_normal((2, 3, 3, 4, 3)).astype(np.float32)
    x = rng.standard_normal(mean.shape).astype(np.float32)
    jg = jdist.make_gaussian(jnp.asarray(mean), jnp.asarray(logvar))
    tg = tdist.make_gaussian(_t(mean), _t(logvar))
    # exp(logvar) a few ulps apart (XLA's CPU exp), squared through 1/var²
    _close(tg.log_p(_t(x)), jg.log_p(jnp.asarray(x)), LOG_P_TOL)
    _close(tg.normal_entropy(), jg.normal_entropy())
    _close(tg.nll(_t(x)), jg.nll(jnp.asarray(x)))
    var = np.exp(np.asarray(jg.logvar, np.float64))
    ref = (-0.5 * ((x - mean) / var)**2 - 0.5 * np.log(2 * np.pi)
           - np.asarray(jg.logvar, np.float64))
    _close(tg.log_p(_t(x)), ref, 1e-5)
