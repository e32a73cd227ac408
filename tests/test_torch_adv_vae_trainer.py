"""The port's adversarial VAE trainer against the JAX package's.

The tiny VAE of ``tests/test_torch_training.py`` (its JAX parameters,
perturbed, carried by ``bridge``), patches of 16 of a 16² render, LPIPS
(VGG16 at its fixed widths, perturbed heads) in the loss, f32, with

* an ``AdversarialHead`` (a 16² StyleGAN discriminator, R1 γ = 1, ADA
  ``bgc_config()`` at p = 0.6 with the controller every step), and
* a ``VisionAidedHead`` over a toy CLIP vision tower.

Step 1: the loss, each term (``g_adv`` included) and every VAE grad
against ``jax.value_and_grad`` of JAX's ``VAETrainer._loss_fn`` (the
port fed JAX's draws, the generator term's ADA draws from the head's
first key); then ``_disc_step`` on both sides: the discriminator's
metrics, its parameters after the step and the new ADA strength.

The JAX trainer's generator term is judged by the discriminator, ADA key
and strength of its first trace (``generator_loss`` reads Python state
inside the jitted step): ``test_jax_step_captures_the_first_discriminator``
shows it on the JAX side.  The port reads the live ones; step 2's
generator term is held against JAX's own jitted ``head._g_loss(live
params, fake, key, p)``.

Tolerances: 1e-4 of scale for the loss, the terms and the grads (floor
1e-6 of the largest grad), as the VAE trainer's test; LPIPS alone 1e-5.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from ln3diff_tpu.conditioning import clip as jclip
from ln3diff_tpu.conditioning import lpips as jlpips
from ln3diff_tpu.models import stylegan as jsg
from ln3diff_tpu.render import renderer as jr
from ln3diff_tpu.training import augment as jaug
from ln3diff_tpu.training import gan as jgan
from ln3diff_tpu.training import losses as jl
from ln3diff_tpu.training import train_state as jts
from ln3diff_tpu.training import vision_aided as jva
from ln3diff_tpu.training.vae_trainer import VAETrainConfig as JTrainConfig
from ln3diff_tpu.training.vae_trainer import VAETrainer as JTrainer
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.conditioning import clip as tclip
from ln3diff_tpu_torch.conditioning import lpips as tlpips
from ln3diff_tpu_torch.data import synthetic as tsyn
from ln3diff_tpu_torch.models import stylegan as tsg
from ln3diff_tpu_torch.render import renderer as tr
from ln3diff_tpu_torch.training import augment as taug
from ln3diff_tpu_torch.training import gan as tgan
from ln3diff_tpu_torch.training import losses as tl
from ln3diff_tpu_torch.training import vision_aided as tva
from ln3diff_tpu_torch.training.vae_trainer import (TrainDraws,
                                                    VAETrainConfig,
                                                    VAETrainer)
from tests.test_torch_augment import jax_draws
from tests.test_torch_training import OPTS, _jax_init, _jcfg, _tcfg

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

PATCH, RENDER, LR = 16, 16, 2e-3
DISC = dict(img_resolution=16, base_channels=8, max_channels=32)
CLIP = dict(hidden_size=32, num_layers=4, num_heads=2, intermediate_size=64,
            patch_size=8, image_size=32)
LOSS = dict(lpips_lambda=0.5)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float64)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rel, msg=''):
    want, got = _np(want), _np(got)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=msg)


def _perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + scale * rng.standard_normal(p.shape))
        .astype(np.float32), tree)


def jax_aug_draws(key, shape):
    return jax_draws(key, shape, taug.bgc_config())


@functools.lru_cache(maxsize=None)
def _lpips_params():
    m = jlpips.LPIPS()
    v = jax.jit(m.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)),
                        jnp.zeros((1, 16, 16, 3)))
    return _perturbed(v['params'], 4, scale=0.02)


def test_lpips_matches_jax():
    """VGG16 at its fixed widths on 32² patches, perturbed heads."""
    params = _lpips_params()
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.standard_normal(a.shape), -1, 1) \
        .astype(np.float32)
    want = jlpips.LPIPS().apply({'params': params}, jnp.asarray(a),
                                jnp.asarray(b))
    fn = tlpips.make_lpips_fn(bridge.lpips_state_dict(params), device='cpu')
    with torch.no_grad():
        got = fn.model(_t(a), _t(b))
    _close(got, want, 1e-5)
    _close(fn(_t(a), _t(b)), jlpips.make_lpips_fn(params)(
        jnp.asarray(a), jnp.asarray(b)), 1e-5)
    # frozen: the grads reach the images only
    x = _t(a).requires_grad_()
    fn(x, _t(b)).backward()
    assert x.grad.abs().max() > 0
    assert all(p.grad is None for p in fn.model.parameters())
    # without weights: random VGG16, heads at 1 (JAX's init)
    fresh = tlpips.make_lpips_fn(device='cpu')
    assert all(float(getattr(fresh.model, f'lin{i}').min()) == 1.0
               for i in range(5))
    assert float(fresh(_t(a), _t(a))) == 0.0


def _heads(kind):
    """(JAX head, port head) with the same parameters."""
    if kind == 'stylegan':
        jcfg = jgan.GANConfig(disc=jsg.DiscriminatorConfig(**DISC),
                              ada=jaug.bgc_config(), ada_interval=1,
                              ada_kimg=0.01)
        jh = jgan.AdversarialHead(jcfg, seed=0)
        jh.ada_p = 0.6
        th = tgan.AdversarialHead(tgan.GANConfig(
            disc=tsg.DiscriminatorConfig(**DISC), ada=taug.bgc_config(),
            ada_interval=1, ada_kimg=0.01), seed=0, device='cpu')
        th.ada_p = 0.6
        params = _perturbed(jh.state.params, 6)
        jh.state = jh.state.replace(params=jax.tree_util.tree_map(
            jnp.asarray, params))
        th.model.load_state_dict(bridge.discriminator_state_dict(params))
        return jh, th
    jcfg = jva.VisionAidedConfig(clip=jclip.CLIPVisionConfig(**CLIP),
                                 taps=(2, 4), head_width=8)
    jh = jva.VisionAidedHead(jcfg, seed=0)
    params = _perturbed(jh.state.params, 7)
    jh.state = jh.state.replace(params=jax.tree_util.tree_map(
        jnp.asarray, params))
    th = tva.VisionAidedHead(tva.VisionAidedConfig(
        clip=tclip.CLIPVisionConfig(**CLIP), taps=(2, 4), head_width=8),
        seed=0, device='cpu')
    th.model.load_state_dict(bridge.vision_aided_state_dict(params))
    return jh, th


def _trainers(kind):
    mesh, params, raw, _ = _jax_init()
    jh, th = _heads(kind)
    jlp = jlpips.make_lpips_fn(_lpips_params())
    jt = JTrainer(_jcfg(), JTrainConfig(lr=LR, patch_resolution=PATCH,
                                        render_resolution=RENDER),
                  jl.LossConfig(**LOSS), render_opts=jr.RenderOptions(**OPTS),
                  mesh=mesh, seed=0, lpips_fn=jlp, adversarial=jh)
    tt = VAETrainer(_tcfg(), VAETrainConfig(
        lr=LR, patch_resolution=PATCH, render_resolution=RENDER,
        ema_rate=0.5), tl.LossConfig(**LOSS),
        render_opts=tr.RenderOptions(**OPTS), seed=0,
        lpips_fn=tlpips.make_lpips_fn(
            bridge.lpips_state_dict(_lpips_params()), device='cpu'),
        adversarial=th, device='cpu')
    tt.model.load_state_dict(bridge.vae_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jt, tt, params, raw


def _vae_draws(key, n_views):
    k_vae, k_render = jax.random.split(key)
    k_strat, k_imp = jax.random.split(k_render)
    R, S = PATCH**2, OPTS['depth_resolution']
    return _t(jax.random.normal(k_vae, (1, 16, 16, 4, 3))), tr.RenderDraws(
        _t(jax.random.uniform(k_strat, (n_views, R, S, 1))),
        _t(jax.random.uniform(k_imp, (n_views * R,
                                      OPTS['depth_resolution_importance']))))


@functools.lru_cache(maxsize=None)
def _step_one(kind):
    """Both trainers through step 1 and the discriminator step; the JAX
    results as numpy, the port trainer for step 2."""
    jt, tt, params, raw = _trainers(kind)
    jh, th = jt.adversarial, tt.adversarial
    jbatch = jt.prepare_batch(raw)
    tbatch = tt.prepare_batch(tsyn.make_multiview_batch(2, 32, RENDER,
                                                        seed=0))
    key = jax.random.PRNGKey(11)
    ada = kind == 'stylegan'
    # the key the head hands out when the step is first traced
    key0 = jh._ada_key if ada else None
    k_g1 = jax.random.split(key0)[1] if ada else None
    (loss, terms), grads = jax.jit(jax.value_and_grad(
        jt._loss_fn, has_aux=True))(params, None, jbatch, key)
    if ada:
        # the trace leaves a tracer in the head's key (see
        # test_jax_step_leaks_the_ada_key): put back the concrete key
        jh._ada_key = jax.random.split(key0)[0]
    eps, render = _vae_draws(key, 2)
    draws = TrainDraws(eps, render, jax_aug_draws(k_g1, (2, PATCH, PATCH, 3))
                       if ada else None)
    tloss, tterms = tt.loss_fn(tbatch, draws=draws)
    tloss.backward()
    tgrads = {k: p.grad.clone() for k, p in tt.model.named_parameters()}
    tt.model.zero_grad(set_to_none=True)
    tt.train_step(tbatch, draws=draws)

    tx = jts.make_optimizer(LR, 0.01, grad_clip=0.5)
    new = jts.create_train_state(params, tx).apply_gradients(grads)
    k_d1 = jax.random.split(jh._ada_key)[1] if ada else None
    jd = jt._disc_step(new, jbatch)
    d_draws = None
    if ada:
        kr, kf = jax.random.split(k_d1)
        shape = (2, PATCH, PATCH, 3)
        d_draws = (jax_aug_draws(kr, shape), jax_aug_draws(kf, shape))
    td = tt._disc_step(tbatch, d_draws)
    return dict(jt=jt, tt=tt, loss=float(loss), tloss=tloss,
                terms={k: float(v) for k, v in terms.items()}, tterms=tterms,
                grads=bridge.vae_state_dict(jax.tree_util.tree_map(
                    np.asarray, grads)), tgrads=tgrads,
                jd={k: float(v) for k, v in jd.items()}, td=td)


@pytest.mark.parametrize('kind', ['stylegan', 'vision_aided'])
def test_step_one_matches_jax(kind):
    s = _step_one(kind)
    _close(s['tloss'], s['loss'], 1e-4, 'loss')
    assert sorted(s['tterms']) == sorted(s['terms'])
    assert 'g_adv' in s['terms'] and 'lpips' in s['terms']
    for k, v in s['tterms'].items():
        _close(v, s['terms'][k], 1e-4, k)
    floor = 1e-6 * max(float(g.abs().max()) for g in s['grads'].values())
    assert sorted(s['tgrads']) == sorted(s['grads'])
    for k, g in s['tgrads'].items():
        w = s['grads'][k]
        np.testing.assert_allclose(
            _np(g), _np(w), rtol=0, err_msg=k,
            atol=max(1e-4 * float(w.abs().max()), floor))


@pytest.mark.parametrize('kind', ['stylegan', 'vision_aided'])
def test_disc_step_matches_jax(kind):
    """``_disc_step``: a second encode and deterministic render with the
    updated VAE, then the discriminator update; its metrics, its
    parameters and (ADA) the controller's new p."""
    s = _step_one(kind)
    jd, td = s['jd'], s['td']
    assert sorted(k for k in jd) == sorted(k for k in td)
    for k in jd:
        if k == 'real_sign':
            # a logit near 0 may flip; the mean of 2 signs moves by 1
            assert abs(float(td[k]) - jd[k]) <= 1.0
            continue
        _close(td[k], jd[k], 1e-4, k)
    jh, th = s['jt'].adversarial, s['tt'].adversarial
    want = (bridge.discriminator_state_dict if kind == 'stylegan'
            else bridge.vision_aided_state_dict)(
        jax.tree_util.tree_map(np.asarray, jh.state.params))
    lr_d = 2e-4 if kind == 'stylegan' else 1e-4
    for k, p in th.model.named_parameters():
        err = float((p.detach() - want[k]).abs().max())
        # a first Adam step with β1 = 0 moves by lr·g/(|g| + ε)
        assert err <= 2 * lr_d + 1e-6, k
    if kind == 'stylegan':
        assert th.ada_p == jh.ada_p != 0.6


def test_step_two_generator_term_reads_the_live_discriminator():
    """Step 2's g_adv against JAX's jitted ``head._g_loss`` with the live
    discriminator, the head's next key and the new p; it differs from what
    the JAX trainer's captured term (first discriminator, first key,
    p = 0.6) gives for the same images."""
    s = _step_one('stylegan')
    jh, tt = s['jt'].adversarial, s['tt']
    th = tt.adversarial
    # the same live discriminator on both sides
    live = jax.tree_util.tree_map(np.asarray, jh.state.params)
    th.model.load_state_dict(bridge.discriminator_state_dict(live))
    k_g2 = jax.random.split(jh._ada_key)[1]
    seen = {}
    gen_loss = th.generator_loss

    def spy(fake, draws=None):
        seen['fake'] = fake.detach().numpy()
        return gen_loss(fake, draws)

    th.generator_loss = spy
    batch = tt.prepare_batch(tsyn.make_multiview_batch(2, 32, RENDER,
                                                       seed=0))
    g = torch.Generator().manual_seed(12)
    draws = TrainDraws(torch.randn((1, 16, 16, 4, 3), generator=g),
                       tr.draw_uniforms(2, PATCH**2, tr.RenderOptions(**OPTS),
                                        g, 'cpu'),
                       jax_aug_draws(k_g2, (2, PATCH, PATCH, 3)))
    _, terms = tt.loss_fn(batch, draws=draws)
    fake = jnp.asarray(seen['fake'])
    want = jh.cfg.adv_lambda * jh._g_loss(live, fake, k_g2, jh.ada_p)
    _close(terms['g_adv'], want, 1e-4)
    k_g1 = jax.random.split(jax.random.PRNGKey(1))[1]
    first = jax.tree_util.tree_map(np.asarray, _heads('stylegan')[0]
                                   .state.params)
    captured = jh.cfg.adv_lambda * jh._g_loss(first, fake, k_g1, 0.6)
    assert abs(float(captured) - float(want)) > 1e-3 * abs(float(want))


def _real_fake():
    real = np.random.default_rng(14).uniform(
        -1, 1, (2, PATCH, PATCH, 3)).astype(np.float32)
    return jnp.asarray(real), jnp.asarray(real[::-1])


def test_jax_step_captures_the_first_discriminator():
    """The JAX package's fault: under ``jax.jit`` its ``_loss_fn`` keeps
    the discriminator parameters of the first trace (``generator_loss``
    reads ``self.state.params``); after a discriminator update the jitted
    step's ``g_adv`` is unchanged, while a fresh trace sees the new
    discriminator."""
    jt, _, params, raw = _trainers('vision_aided')
    batch = jt.prepare_batch(raw)
    key = jax.random.PRNGKey(13)
    step = jax.jit(jt._loss_fn)
    _, before = step(params, None, batch, key)
    jt.adversarial.disc_step(*_real_fake())
    _, again = step(params, None, batch, key)
    assert float(again['g_adv']) == float(before['g_adv'])
    _, fresh = jax.jit(lambda *a: jt._loss_fn(*a))(params, None, batch,
                                                   key)
    assert float(fresh['g_adv']) != float(before['g_adv'])


def test_jax_step_leaks_the_ada_key():
    """With an ``AdversarialHead`` the trace also stores a traced key in
    ``head._ada_key`` (``_next_key`` inside the jitted step), so JAX's
    next discriminator step fails: the JAX trainer cannot run its first
    ``_disc_step``.  The port draws from a ``torch.Generator`` at every
    call."""
    jt, _, params, raw = _trainers('stylegan')
    batch = jt.prepare_batch(raw)
    jax.jit(jt._loss_fn)(params, None, batch, jax.random.PRNGKey(13))
    with pytest.raises(jax.errors.UnexpectedTracerError):
        jt.adversarial.disc_step(*_real_fake())


def test_adversarial_run_loop_and_guard():
    """``run_loop`` with a head: a discriminator step after each step (its
    metrics logged with the step's), stopped by the guard."""
    _, tt, _, _ = _trainers('stylegan')
    tt.cfg = VAETrainConfig(**dict(vars(tt.cfg), log_interval=1))

    class StopAtTwo:
        n = 0

        def should_stop(self):
            self.n += 1
            return self.n == 2

    logs = []
    raw = tsyn.make_multiview_batch(2, 32, RENDER, seed=1)
    tt.run_loop(iter([raw] * 4), num_steps=4,
                generator=torch.Generator().manual_seed(0),
                log=logs.append, guard=StopAtTwo())
    assert [d.get('step') for d in logs] == [1, 2, None]
    assert logs[-1] == {'stopped_after_step': 2}
    for d in logs[:2]:
        assert {'g_adv', 'd_loss', 'r1', 'ada_p'} <= set(d)
        assert all(np.isfinite(v) for v in d.values())
    assert tt.state.step == 2 and tt.adversarial._num_d_steps == 2
