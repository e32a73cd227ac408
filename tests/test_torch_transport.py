"""``ln3diff_tpu_torch.diffusion.transport`` against
``ln3diff_tpu.diffusion.transport``: the path plans of all three
interpolants and the ODE sampler (Euler, Heun, reversed), with JAX's
start noise fed to the port as ``x_init``.  f32 on both sides; tolerance
1e-5 of each output's scale (the same f32 operations in the same order,
up to the libraries' transcendental functions)."""

import numpy as np
import os
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.diffusion import transport as jtr
from ln3diff_tpu_torch.diffusion import transport as ttr

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


def _weights(seed=0, C=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, C)).astype(np.float32) / C**0.5,
            rng.standard_normal(C).astype(np.float32))


def _jax_model(w, b):
    w, b = jnp.asarray(w), jnp.asarray(b)

    def fn(x, t, scale=1.0):
        return scale * jnp.tanh(x @ w + b * t[:, None, None, None]) - 0.3 * x
    return fn


def _torch_model(w, b):
    w, b = torch.from_numpy(w), torch.from_numpy(b)

    def fn(x, t, scale=1.0):
        return scale * torch.tanh(x @ w + b * t[:, None, None, None]) \
            - 0.3 * x
    return fn


@pytest.mark.parametrize('kind', ['linear', 'gvp', 'vp'])
def test_path_plan_matches_jax(kind):
    rng = np.random.default_rng(1)
    t = np.linspace(0.02, 0.97, 7).astype(np.float32)
    x0 = rng.standard_normal((7, 3, 4)).astype(np.float32)
    x1 = rng.standard_normal((7, 3, 4)).astype(np.float32)
    v = rng.standard_normal((7, 3, 4)).astype(np.float32)
    jp, tp = jtr.PathPlan(kind=kind), ttr.PathPlan(kind=kind)
    tt = torch.from_numpy(t)
    for name in ('alpha', 'sigma'):
        for got, want in zip(getattr(tp, name)(tt),
                             getattr(jp, name)(jnp.asarray(t))):
            _close(got, want)
    for got, want in zip(
            tp.plan(tt, torch.from_numpy(x0), torch.from_numpy(x1)),
            jp.plan(jnp.asarray(t), jnp.asarray(x0), jnp.asarray(x1))):
        _close(got, want)
    _close(tp.score_from_velocity(torch.from_numpy(v), torch.from_numpy(x1),
                                  tt),
           jp.score_from_velocity(jnp.asarray(v), jnp.asarray(x1),
                                  jnp.asarray(t)))


@pytest.mark.parametrize('method,reverse,eps', [('euler', False, 0.0),
                                                ('heun', False, 0.0),
                                                ('euler', True, 0.0),
                                                ('heun', False, 0.05)])
def test_sample_ode_matches_jax(method, reverse, eps):
    """Eight steps of a nonlinear velocity field (model kwargs included)
    from JAX's draw: the same trajectory end, and each denoiser call gets
    t in [0, 1] as JAX sends it."""
    w, b = _weights()
    shape = (2, 3, 4, 6)
    spec = dict(sample_eps=eps)
    key = jax.random.PRNGKey(7)
    want = jtr.Transport(jtr.TransportSpec(**spec)).sample_ode(
        _jax_model(w, b), shape, key, num_steps=8, method=method,
        model_kwargs={'scale': 1.5}, reverse=reverse)
    x_init = torch.from_numpy(np.array(jax.random.normal(key, shape)))
    seen = []
    model = _torch_model(w, b)

    def recording(x, t, **kw):
        seen.append(t.clone())
        return model(x, t, **kw)

    got = ttr.Transport(ttr.TransportSpec(**spec)).sample_ode(
        recording, shape, num_steps=8, method=method,
        model_kwargs={'scale': 1.5}, reverse=reverse, x_init=x_init)
    _close(got, want)
    assert len(seen) == 8 * (2 if method == 'heun' else 1)
    ts = torch.stack(seen)
    assert ts.dtype == torch.float32 and ts.shape == (len(seen), 2)
    assert float(ts.min()) >= 0.0 and float(ts.max()) <= 1.0 + 1e-6


def test_sample_ode_draws_from_the_generator():
    """Without ``x_init`` the start is a draw from the generator: the same
    seed gives the same result, another seed another one."""
    w, b = _weights(2)
    tr = ttr.Transport()

    def run(seed):
        return tr.sample_ode(_torch_model(w, b), (1, 2, 2, 6), num_steps=3,
                             generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
    with pytest.raises(NotImplementedError):
        tr.sample_ode(_torch_model(w, b), (1, 2, 2, 6), method='rk4')


def test_create_transport():
    tr = ttr.create_transport('GVP')
    assert tr.spec == ttr.TransportSpec(path='gvp')
    assert tr.path.kind == 'gvp'
    jt = jtr.create_transport('GVP')
    assert (jt.spec.path, jt.spec.sample_eps) == (tr.spec.path,
                                                  tr.spec.sample_eps)
