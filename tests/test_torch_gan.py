"""The port's discriminators, mapping network and GAN losses
(``models/stylegan.py``, ``training/gan.py``) against the JAX package,
f32.

JAX's parameters (jitted inits, perturbed with numpy noise so that no
bias is zero) are carried by ``bridge``.  Tolerances: 1e-5 of each
output's scale for the networks and ``minibatch_stddev`` (f32 sums in
another order); the discriminator step's loss, metrics and every grad —
hinge + ½γ·R1 on ADA-augmented (``bgc_config()`` at p = 0.6, JAX's
draws) real and fake images — to 1e-4 of scale (R1's double backward
through five convs and the stddev).
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from ln3diff_tpu.models import stylegan as jsg
from ln3diff_tpu.training import augment as jaug
from ln3diff_tpu.training import gan as jgan
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import stylegan as tsg
from ln3diff_tpu_torch.training import augment as taug
from ln3diff_tpu_torch.training import gan as tgan
from tests.test_torch_augment import jax_draws

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-5


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


def _perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + scale * rng.standard_normal(p.shape))
        .astype(np.float32), tree)


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


DISC = dict(img_resolution=16, base_channels=8, max_channels=32)


@functools.lru_cache(maxsize=None)
def _disc(res=16, channels=3):
    cfg = dict(DISC, img_resolution=res, img_channels=channels)
    jm = jsg.StyleGANDiscriminator(jsg.DiscriminatorConfig(**cfg))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, res, res, channels)))
    params = _perturbed(v['params'], 1)
    tm = tsg.StyleGANDiscriminator(tsg.DiscriminatorConfig(**cfg))
    tm.load_state_dict(bridge.discriminator_state_dict(params))
    return jm, params, tm


@pytest.mark.parametrize('batch,res', [(4, 16), (6, 16), (3, 32)])
def test_discriminator_matches_jax(batch, res):
    """Minibatch-stddev groups of 4, 3 and 3; the stride-2 convs pad
    (0, 1) as 'SAME' does."""
    jm, params, tm = _disc(res)
    x = _images((batch, res, res, 3), batch)
    want = jm.apply({'params': params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    _close(got, want)


def test_dual_discriminator_matches_jax():
    cfg = dict(DISC, img_resolution=16)
    jm = jsg.DualDiscriminator(jsg.DiscriminatorConfig(**cfg))
    sr, raw = _images((2, 16, 16, 3), 1), _images((2, 8, 8, 3), 2)
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(sr),
                         jnp.asarray(raw))
    params = _perturbed(v['params'], 3)
    tm = tsg.DualDiscriminator(tsg.DiscriminatorConfig(**cfg))
    tm.load_state_dict(bridge.discriminator_state_dict(params))
    want = jm.apply({'params': params}, jnp.asarray(sr), jnp.asarray(raw))
    with torch.no_grad():
        got = tm(_t(sr), _t(raw))
    _close(got, want)


@pytest.mark.parametrize('size', [8, 16, 32, 12])
def test_filtered_resizing_matches_jax(size):
    img = _images((2, 16, 16, 3), 4)
    f = jsg.setup_filter()
    want = jsg.filtered_resizing(jnp.asarray(img), size, f)
    got = tsg.filtered_resizing(_t(img).permute(0, 3, 1, 2), size,
                                tsg.setup_filter())
    _close(got.permute(0, 2, 3, 1), want)


def test_setup_filter_and_gain_match_jax():
    for taps, norm in (([1, 3, 3, 1], True), ([1, 2, 1], False),
                       (jaug._SYM6, True)):
        np.testing.assert_array_equal(
            tsg.setup_filter(taps, normalize=norm).numpy(),
            np.asarray(jsg.setup_filter(taps, normalize=norm)))
    img = _images((1, 8, 8, 2), 5)
    f = jsg.setup_filter()
    want = jsg.upsample2d(jnp.asarray(img), f, up=2, gain=3.0)
    got = tsg.upsample2d(_t(img).permute(0, 3, 1, 2), tsg.setup_filter(),
                         up=2, gain=3.0)
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize('batch', [4, 6, 5, 1])
def test_minibatch_stddev_matches_jax(batch):
    x = np.random.default_rng(batch).standard_normal(
        (batch, 4, 4, 5)).astype(np.float32)
    want = jsg.minibatch_stddev(jnp.asarray(x))
    got = tsg.minibatch_stddev(_t(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize('c_dim,psi,cutoff', [(4, 0.7, 2), (0, 0.5, None),
                                              (4, 1.0, None)])
def test_mapping_network_matches_jax(c_dim, psi, cutoff):
    """w_avg rides along as a buffer: the EMA update (update_emas) and the
    truncation toward it."""
    kw = dict(z_dim=8, c_dim=c_dim, w_dim=16, num_ws=3, num_layers=2)
    jm = jsg.MappingNetwork(**kw)
    rng = np.random.default_rng(6)
    z = rng.standard_normal((5, 8)).astype(np.float32)
    c = rng.standard_normal((5, 4)).astype(np.float32) if c_dim else None
    v = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(z),
                         None if c is None else jnp.asarray(c))
    v = {'params': _perturbed(v['params'], 7),
         'stats': {'w_avg': rng.standard_normal(16).astype(np.float32)}}
    tm = tsg.MappingNetwork(**kw)
    tm.load_state_dict(bridge.mapping_state_dict(v))
    want, upd = jm.apply(v, jnp.asarray(z),
                         None if c is None else jnp.asarray(c),
                         truncation_psi=psi, truncation_cutoff=cutoff,
                         update_emas=True, mutable=['stats'])
    with torch.no_grad():
        got = tm(_t(z), None if c is None else _t(c), truncation_psi=psi,
                 truncation_cutoff=cutoff, update_emas=True)
    _close(got, want)
    _close(tm.w_avg, upd['stats']['w_avg'])


def test_losses_and_r1_match_jax():
    jm, params, tm = _disc()
    real = _images((4, 16, 16, 3), 8)
    lr = np.random.default_rng(9).standard_normal((4, 1)).astype(np.float32)
    lf = np.random.default_rng(10).standard_normal((4, 1)) \
        .astype(np.float32)
    _close(tgan.hinge_d_loss(_t(lr), _t(lf)),
           jgan.hinge_d_loss(jnp.asarray(lr), jnp.asarray(lf)))
    _close(tgan.vanilla_g_loss(_t(lf)), jgan.vanilla_g_loss(jnp.asarray(lf)))
    _close(tgan.calculate_adaptive_weight(torch.tensor(3.0),
                                          torch.tensor(0.5)),
           jgan.calculate_adaptive_weight(3.0, 0.5))

    def japply(p, img):
        return jm.apply({'params': p}, img)

    want = jgan.r1_penalty(japply, params, jnp.asarray(real))
    real_t = _t(real).requires_grad_(True)
    got = tgan.r1_penalty(tm(real_t), real_t)
    _close(got, want, 1e-4)
    # R1 is differentiable in D's parameters: its grads match JAX's
    want_g = bridge.discriminator_state_dict(jax.grad(
        lambda p: jgan.r1_penalty(japply, p, jnp.asarray(real)))(params))
    tm.zero_grad(set_to_none=True)
    got.backward()
    for k, p in tm.named_parameters():
        # the output bias does not move ∇_x D: no grad (JAX: zeros)
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _close(g, want_g[k], 1e-4, k)


@pytest.mark.parametrize('ada', [False, True])
def test_disc_step_matches_jax(ada):
    """``AdversarialHead``'s discriminator loss and its grads (hinge +
    ½γ·R1, R1 at the augmented reals), then the AdamW step (β 0, 0.99)."""
    jm, params, _ = _disc()
    cfg_t = tgan.GANConfig(disc=tsg.DiscriminatorConfig(**DISC), r1_gamma=2,
                           ada=taug.bgc_config() if ada else None)
    head = tgan.AdversarialHead(cfg_t, device='cpu')
    head.model.load_state_dict(bridge.discriminator_state_dict(params))
    head.ada_p = 0.6
    real, fake = _images((4, 16, 16, 3), 11), _images((4, 16, 16, 3), 12)
    key = jax.random.PRNGKey(13)
    kr, kf = jax.random.split(key)

    def jloss(p):
        def aug(k, x):
            return jaug.augment_pipe(k, x, jaug.bgc_config(), 0.6) \
                if ada else x
        r = aug(kr, jnp.asarray(real))
        lr = jm.apply({'params': p}, r)
        lf = jm.apply({'params': p}, aug(kf, jnp.asarray(fake)))
        loss = jgan.hinge_d_loss(lr, lf)
        r1 = jgan.r1_penalty(lambda q, x: jm.apply({'params': q}, x), p, r)
        return loss + 0.5 * 2 * r1, (loss, r1, lr.mean(), lf.mean())

    (want, aux), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    draws = (jax_draws(kr, real.shape, taug.bgc_config()),
             jax_draws(kf, fake.shape, taug.bgc_config())) if ada else None
    total, metrics = head.d_loss(_t(real), _t(fake), draws)
    _close(total, want, 1e-4)
    for name, w in zip(('d_loss', 'r1', 'logits_real', 'logits_fake'), aux):
        _close(metrics[name], w, 1e-4, name)
    total.backward()
    want_g = bridge.discriminator_state_dict(grads)
    gmax = max(float(g.abs().max()) for g in want_g.values())
    for k, p in head.model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want_g[k].numpy(), rtol=0, err_msg=k,
            atol=max(1e-4 * float(want_g[k].abs().max()), 1e-6 * gmax))
    head.model.zero_grad(set_to_none=True)

    # the step: optax's adamw(2e-4, b1 0, b2 0.99, no decay, no clip)
    from ln3diff_tpu.training import train_state as jts
    tx = jts.make_optimizer(2e-4, weight_decay=0.0, grad_clip=None,
                            betas=(0.0, 0.99))
    new = jts.create_train_state(params, tx).apply_gradients(grads)
    head.disc_step(_t(real), _t(fake), draws)
    want_p = bridge.discriminator_state_dict(new.params)
    for k, p in head.state.params.items():
        # a first Adam step with b1 = 0 moves by lr·g/(|g| + eps)
        err = (p.detach() - want_p[k]).abs()
        assert float(err.max()) <= 2 * 2e-4 + 1e-6, k
        resolved = want_g[k].abs() >= 10 * max(
            1e-4 * float(want_g[k].abs().max()), 1e-6 * gmax)
        assert bool((err[resolved] <= 1e-5 * float(want_p[k].abs().max())
                     + 2e-6).all()), k


def test_ada_controller_moves_p_every_interval():
    cfg = tgan.GANConfig(disc=tsg.DiscriminatorConfig(**DISC),
                         ada=taug.AugmentConfig(xflip=1), ada_interval=2,
                         ada_kimg=0.01)
    head = tgan.AdversarialHead(cfg, seed=3, device='cpu')
    head.ada_p = 0.5
    real, fake = _t(_images((2, 16, 16, 3), 14)), _t(_images((2, 16, 16, 3),
                                                             15))
    signs = []
    for i in range(4):
        m = head.disc_step(real, fake)
        signs.append(float(m['real_sign']))
        if i == 1:
            want = taug.update_ada_p(0.5, np.mean(signs[:2]), 2,
                                     ada_interval=2, ada_kimg=0.01)
            assert m['ada_p'] == head.ada_p == want
        if i == 0:
            assert m['ada_p'] == 0.5


def test_generator_loss_uses_the_live_discriminator():
    """The generator term reads the head's current parameters (no
    capture) and gives the discriminator no grad."""
    head = tgan.AdversarialHead(tgan.GANConfig(
        disc=tsg.DiscriminatorConfig(**DISC)), device='cpu')
    fake = _t(_images((2, 16, 16, 3), 16)).requires_grad_()
    g0 = head.generator_loss(fake)
    g0.backward()
    assert fake.grad.abs().max() > 0
    assert all(p.grad is None for p in head.model.parameters())
    head.disc_step(_t(_images((2, 16, 16, 3), 17)), fake.detach())
    g1 = head.generator_loss(fake)
    want = head.cfg.adv_lambda * tgan.vanilla_g_loss(head.model(fake))
    assert float(g1.detach()) == float(want.detach()) != float(g0.detach())


def test_heads_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tgan.AdversarialHead()
    assert dataclasses.asdict(tgan.GANConfig())['adv_lambda'] == 0.01
