"""The port's DDIM sampling against ``ln3diff_tpu.diffusion.gaussian``.

Schedules and respacing must be identical; the sampler is fed JAX's start
noise through ``x_init`` and a closed-form model, so both sides run the
same arithmetic (tolerance 1e-5 relative to the sample's scale).
"""

import numpy as np
import os
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.diffusion import gaussian as jg
from ln3diff_tpu_torch.diffusion import gaussian as tg

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


@pytest.mark.parametrize('name', ['linear', 'cosine', 'linear_simple'])
def test_beta_schedules_identical(name):
    np.testing.assert_array_equal(tg.get_named_beta_schedule(name, 1000),
                                  jg.get_named_beta_schedule(name, 1000))


@pytest.mark.parametrize('spec', ['ddim250', 'ddim25', '10', '4,3,2'])
def test_space_timesteps_identical(spec):
    assert tg.space_timesteps(1000, spec) == jg.space_timesteps(1000, spec)


@pytest.mark.parametrize('respacing', [None, 'ddim250'])
def test_schedule_tables(respacing):
    j = jg.make_diffusion(timestep_respacing=respacing)
    t = tg.make_diffusion(timestep_respacing=respacing)
    assert j.num_timesteps == t.num_timesteps
    for name in tg._TABLES:
        np.testing.assert_array_equal(t.table(name, 'cpu').numpy(),
                                      np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(t.table('timestep_map', 'cpu').numpy(),
                                  np.asarray(j.timestep_map))


def _model(x, t, xp):
    """A closed-form stand-in for the denoiser, identical on both sides."""
    tt = t.astype(xp.float32) if xp is jnp else t.float()
    return 0.3 * x + 0.01 * xp.sin(tt / 100.0).reshape(-1, 1, 1, 1)


@pytest.mark.parametrize('mean_type,var_type', [
    ('eps', 'fixed_small'), ('v', 'fixed_large'), ('x0', 'fixed_small')])
def test_ddim_sample_loop_with_jax_noise(mean_type, var_type):
    kw = dict(mean_type=mean_type, var_type=var_type,
              timestep_respacing='ddim20')
    j = jg.make_diffusion(**kw)
    t = tg.make_diffusion(**kw)
    shape = (2, 4, 4, 12)
    x_init = jax.random.normal(jax.random.PRNGKey(0), shape)
    want = j.ddim_sample_loop(lambda x, s: _model(x, s, jnp), shape,
                              jax.random.PRNGKey(1), x_init=x_init)
    got = t.ddim_sample_loop(lambda x, s: _model(x, s, torch), shape,
                             device='cpu',
                             x_init=torch.from_numpy(np.array(x_init)))
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                               rtol=1e-5)


def test_cfg_model_fn():
    shape = (1, 4, 4, 12)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    c = rng.standard_normal((1, 3, 8)).astype(np.float32)
    u = rng.standard_normal((1, 3, 8)).astype(np.float32)

    def jm(xx, tt, context):
        return xx * jnp.mean(context['crossattn']) + tt[:, None, None, None]

    def tm(xx, tt, context):
        return xx * torch.mean(context['crossattn']) + tt[:, None, None, None]

    jf = jg.make_cfg_model_fn(jm, 6.5, {'context': {'crossattn':
                                                    jnp.asarray(u)}})
    tf = tg.make_cfg_model_fn(tm, 6.5, {'context': {'crossattn':
                                                    torch.from_numpy(u)}})
    want = jf(jnp.asarray(x), jnp.asarray([3.0]),
              context={'crossattn': jnp.asarray(c)})
    got = tf(torch.from_numpy(x), torch.tensor([3.0]),
             context={'crossattn': torch.from_numpy(c)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
