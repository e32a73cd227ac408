"""The port's ADA pipeline (``training/augment.py``) and grid sampling
(``ops/grid_sample.py``) against the JAX package, f32.

``augment_pipe`` is held to JAX's per augmentation group at
``debug_percentile`` and with JAX's own draws for ``bgc_config()`` (the
port is fed ``uniform``/``normal`` of ``split(key, 48)[i]`` for each draw
of ``augment_draw_plan``).  Tolerance 2e-5 of each output's scale: the
geometric path sums a 12-tap FIR twice and a bilinear warp in another
order, and ``erfinv`` of a percentile may sit an ulp apart; grid sampling
(``F.grid_sample`` against JAX's gathers) to 1e-6.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.ops import grid_sample as jgs
from ln3diff_tpu.training import augment as jaug
from ln3diff_tpu_torch.ops import grid_sample as tgs
from ln3diff_tpu_torch.training import augment as taug

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 2e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rel=TOL, msg=''):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach(), np.float64)
    assert got.shape == want.shape, msg
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=msg)


def _images(shape=(2, 16, 16, 3), seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, shape).astype(np.float32)


def jax_draws(key, shape, cfg, dp=None):
    """The port's draws for ``augment_pipe(key, images, cfg, p, dp)``."""
    keys = jax.random.split(key, 48)
    vals = {}
    for i, kind, shp in taug.augment_draw_plan(shape, cfg, dp):
        fn = jax.random.uniform if kind == 'uniform' else jax.random.normal
        vals[i] = _t(fn(keys[i], shp))
    return taug.AugmentDraws(vals)


# -- grid sampling --------------------------------------------------------------

def test_grid_sample_matches_jax_convention():
    """F.grid_sample(bilinear, zeros, align_corners=False) is JAX's gather
    formula: pixel centres, zero outside, x → width, y → height."""
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 40, 2)).astype(np.float32)
    coords[0, :4] = [[-1, -1], [1, 1], [0, 0], [-6 / 7, 0.2]]
    _close(tgs.grid_sample_2d(_t(feats[0]), _t(coords[0])),
           jgs.grid_sample_2d(jnp.asarray(feats[0]),
                              jnp.asarray(coords[0])), 1e-6)
    _close(tgs.grid_sample_2d_batched(_t(feats), _t(coords)),
           jgs.grid_sample_2d_batched(jnp.asarray(feats),
                                      jnp.asarray(coords)), 1e-6)
    grid = rng.standard_normal((4, 5, 6, 3)).astype(np.float32)
    c3 = rng.uniform(-1.2, 1.2, (50, 3)).astype(np.float32)
    _close(tgs.grid_sample_3d(_t(grid), _t(c3)),
           jgs.grid_sample_3d(jnp.asarray(grid), jnp.asarray(c3)), 1e-6)


def test_grid_sample_grads_match_jax():
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 6, 6, 2)).astype(np.float32)
    coords = rng.uniform(-0.9, 0.9, (2, 30, 2)).astype(np.float32)
    w = rng.standard_normal((2, 30, 2)).astype(np.float32)

    def jloss(f, c):
        return jnp.sum(jgs.grid_sample_2d_batched(f, c) * w)

    gf, gc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feats),
                                             jnp.asarray(coords))
    tf, tc = _t(feats).requires_grad_(), _t(coords).requires_grad_()
    (tgs.grid_sample_2d_batched(tf, tc) * _t(w)).sum().backward()
    _close(tf.grad, gf, 1e-5)
    _close(tc.grad, gc, 1e-5)


# -- the pipeline ---------------------------------------------------------------

GROUPS = {
    'xflip': dict(xflip=1), 'rotate90': dict(rotate90=1),
    'xint': dict(xint=1), 'scale': dict(scale=1), 'rotate': dict(rotate=1),
    'aniso': dict(aniso=1), 'xfrac': dict(xfrac=1),
    'brightness': dict(brightness=1), 'contrast': dict(contrast=1),
    'lumaflip': dict(lumaflip=1), 'hue': dict(hue=1),
    'saturation': dict(saturation=1), 'imgfilter': dict(imgfilter=1),
    'noise': dict(noise=1), 'cutout': dict(cutout=1),
}


@pytest.mark.parametrize('group', sorted(GROUPS))
def test_augment_group_at_debug_percentile(group):
    """Each group alone at ``debug_percentile`` 0.7 (every parameter at
    its percentile; the pixel noise and the keys from JAX's key)."""
    shape = (2, 16, 16, 3)
    x = _images(shape)
    cfg_j = jaug.AugmentConfig(**GROUPS[group])
    cfg_t = taug.AugmentConfig(**GROUPS[group])
    key = jax.random.PRNGKey(3)
    want = jaug.augment_pipe(key, jnp.asarray(x), cfg_j, 1.0,
                             debug_percentile=0.7)
    got = taug.augment_pipe(_t(x), cfg_t, 1.0, debug_percentile=0.7,
                            draws=jax_draws(key, shape, cfg_t, 0.7))
    _close(got, want, msg=group)
    assert not np.allclose(np.asarray(want), x), 'the group did nothing'


@pytest.mark.parametrize('p,channels', [(0.6, 3), (1.0, 3), (1.0, 1)])
def test_bgc_with_jax_draws(p, channels):
    shape = (3, 16, 16, channels)
    x = _images(shape, seed=4)
    key = jax.random.PRNGKey(5)
    want = jaug.augment_pipe(key, jnp.asarray(x), jaug.bgc_config(), p)
    got = taug.augment_pipe(_t(x), taug.bgc_config(), p,
                            draws=jax_draws(key, shape, taug.bgc_config()))
    _close(got, want)


def test_every_group_together_with_jax_draws():
    kw = {k: v for g in GROUPS.values() for k, v in g.items()}
    shape = (2, 16, 16, 3)
    x = _images(shape, seed=6)
    key = jax.random.PRNGKey(7)
    want = jaug.augment_pipe(key, jnp.asarray(x), jaug.AugmentConfig(**kw),
                             0.8)
    cfg = taug.AugmentConfig(**kw)
    got = taug.augment_pipe(_t(x), cfg, 0.8,
                            draws=jax_draws(key, shape, cfg))
    _close(got, want)


def test_filter_bank_and_p_zero():
    np.testing.assert_array_equal(taug._filter_bank(), jaug._filter_bank())
    # p = 0: nothing fires; the anti-aliased identity warp stays close to
    # the input, as JAX's does
    x = _images()
    got = taug.augment_pipe(_t(x), taug.bgc_config(), 0.0,
                            generator=torch.Generator().manual_seed(0))
    want = jaug.augment_pipe(jax.random.PRNGKey(0), jnp.asarray(x),
                             jaug.bgc_config(), 0.0)
    _close(got, want)


def test_a_grad_flows_through_the_pipe():
    x = _t(_images()).requires_grad_()
    y = taug.augment_pipe(x, taug.bgc_config(), 1.0,
                          generator=torch.Generator().manual_seed(1))
    (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    # and it is JAX's grad of the same function with the same draws
    key = jax.random.PRNGKey(8)
    w = np.linspace(-1, 1, x.numel(), dtype=np.float32).reshape(x.shape)
    want = jax.grad(lambda im: jnp.sum(jaug.augment_pipe(
        key, im, jaug.bgc_config(), 1.0) * w))(jnp.asarray(_images()))
    xt = _t(_images()).requires_grad_()
    (taug.augment_pipe(xt, taug.bgc_config(), 1.0, draws=jax_draws(
        key, x.shape, taug.bgc_config())) * _t(w)).sum().backward()
    _close(xt.grad, want, 1e-4)


def test_draws_must_fit_the_plan():
    cfg = taug.AugmentConfig(xflip=1)
    plan = taug.augment_draw_plan((2, 8, 8, 3), cfg)
    assert plan == [(0, 'uniform', (2,)), (1, 'uniform', (2,))]
    bad = taug.AugmentDraws({0: torch.zeros(3), 1: torch.zeros(2)})
    with pytest.raises(ValueError, match='draw 0'):
        taug.augment_pipe(torch.zeros(2, 8, 8, 3), cfg, 1.0, draws=bad)


@pytest.mark.parametrize('r_t,p', [(0.9, 0.3), (0.1, 0.3), (0.9, 0.9999),
                                   (0.2, 0.0001)])
def test_update_ada_p_matches_jax(r_t, p):
    want = float(jaug.update_ada_p(p, r_t, batch_size=8, ada_target=0.6,
                                   ada_interval=4, ada_kimg=0.5))
    assert taug.update_ada_p(p, r_t, batch_size=8, ada_target=0.6,
                             ada_interval=4, ada_kimg=0.5) == want
