"""The port's LSGM joint trainer against the JAX package's joint loss.

One joint step of the toy VAE of ``tests/test_models.py``
(``small_vae_cfg``) with the toy U-Net of ``tests/test_lsgm_trainer.py``
(``tiny_unet``: roll-out, ADM self-attention, the mixing logit), f32 on
both sides, against ``jax.value_and_grad(make_joint_loss_fn(...))``
called directly (no mesh), under ``LSGMConfig()``, ``p_rendering_loss``
and ``train_vae=False``.  JAX's parameters (every leaf perturbed off its
init: flax zero-initialises the U-Net's output convs and the adaLN
weights) are carried by ``bridge.lsgm_state_dict``; the port is fed JAX's
draws: ``k_vae, k_render, k_ddpm = split(rng, 3)``, ε from ``k_vae``, the
render's uniforms from ``split(k_render)``, the p term's ``rho`` and
noise from ``split(k_ddpm)`` and the q term's from
``split(fold_in(k_ddpm, 1))``.

Tolerances: the loss, each metric and every grad to 1e-4 of scale (each
grad with a floor of 1e-6 of the largest grad: grads that are zero in
exact arithmetic hold f32 noise on both sides), as the VAE trainer's
test; the AdamW step as there (1e-5 of scale plus 1e-2·lr where the
grad is resolved, 2·lr elsewhere).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from ln3diff_tpu.data import synthetic as jsyn
from ln3diff_tpu.parallel.mesh import MeshConfig, make_mesh
from ln3diff_tpu.render import renderer as jr
from ln3diff_tpu.training import losses as jl
from ln3diff_tpu.training import lsgm_trainer as jlsgm
from ln3diff_tpu.training import train_state as jts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.data import synthetic as tsyn
from ln3diff_tpu_torch.models.dit import DiT2Config
from ln3diff_tpu_torch.models.unet import UNetConfig, UNetModel
from ln3diff_tpu_torch.models.vae import TriplaneVAEConfig
from ln3diff_tpu_torch.render import renderer as tr
from ln3diff_tpu_torch.training import losses as tl
from ln3diff_tpu_torch.training.lsgm_trainer import (LSGMConfig, LSGMDraws,
                                                     LSGMTrainConfig,
                                                     LSGMTrainer)
from tests.test_lsgm_trainer import tiny_unet
from tests.test_models import small_vae_cfg

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

OPTS = dict(depth_resolution=4, depth_resolution_importance=4,
            ray_start='auto', ray_end='auto', box_warp=0.9,
            filter_out_of_bbox=True)
PATCH, RENDER, LR = 8, 16, 2e-3
CASES = {
    'default': dict(),
    'p_rendering': dict(p_rendering_loss=True),
    'no_vae': dict(train_vae=False),
}


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float64)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rel, msg=''):
    want, got = _np(want), _np(got)
    assert got.shape == want.shape, msg
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=msg)


def _tcfg():
    return TriplaneVAEConfig(
        encoder_in_channels=10, encoder_ch=8, encoder_ch_mult=(1, 2),
        encoder_res_blocks=1, img_resolution=32, num_views=2,
        ldm_z_channels=4, latent_size=16,
        dit2=DiT2Config(tokens_per_plane=64, hidden_size=32, depth=2,
                        num_heads=2, dtype=torch.float32),
        patch_size=2, conv_sr_ch=8, conv_sr_ch_mult=(1, 2),
        conv_sr_res_blocks=1, plane_channels=8, decoder_output_dim=8,
        dtype=torch.float32)


def _tunet():
    return UNetModel(UNetConfig(
        in_channels=4, model_channels=8, out_channels=4, num_res_blocks=1,
        attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
        use_spatial_transformer=False, roll_out=True, mixed_prediction=True,
        dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def _jax_init():
    """JAX's joint params (jitted inits of the LSGM trainer), every leaf
    perturbed by 0.05·N(0, 1) (the mixing logit by 2·N(0, 1) from −6, so
    that the U-Net's share of the prediction is not 0.25%)."""
    trainer = jlsgm.LSGMTrainer(
        small_vae_cfg(), tiny_unet(),
        jlsgm.LSGMTrainConfig(patch_resolution=PATCH,
                              render_resolution=RENDER),
        render_opts=jr.RenderOptions(**OPTS), seed=0,
        mesh=make_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    raw = jsyn.make_multiview_batch(2, 32, RENDER, seed=0)
    state = trainer.init_state(raw)
    rng = np.random.default_rng(1)

    def perturb(path, p):
        p = np.asarray(p)
        if 'mixing_logit' in str(path):
            return (np.zeros_like(p) + 2 * rng.standard_normal(p.shape)) \
                .astype(np.float32)
        return (p + 0.05 * rng.standard_normal(p.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, state.params)
    batch = trainer.prepare_batch(raw)
    return trainer, params, batch


def _draws(key, batch, latent_shape, mean_shape):
    """The port's draws from JAX's key (the module docstring's tree)."""
    k_vae, k_render, k_ddpm = jax.random.split(key, 3)
    k_strat, k_imp = jax.random.split(k_render)
    k_t, k_n = jax.random.split(k_ddpm)
    k_tq, k_nq = jax.random.split(jax.random.fold_in(k_ddpm, 1))
    BV, R, B = batch['c'].shape[0], PATCH**2, latent_shape[0]
    return LSGMDraws(
        eps=_t(jax.random.normal(k_vae, mean_shape)),
        render=tr.RenderDraws(
            _t(jax.random.uniform(k_strat, (BV, R, OPTS['depth_resolution'],
                                            1))),
            _t(jax.random.uniform(k_imp, (BV * R, OPTS[
                'depth_resolution_importance'])))),
        p_rho=_t(jax.random.uniform(k_t, (B,))),
        p_noise=_t(jax.random.normal(k_n, latent_shape)),
        q_rho=_t(jax.random.uniform(k_tq, (B,))),
        q_noise=_t(jax.random.normal(k_nq, latent_shape)))


@functools.lru_cache(maxsize=None)
def _jax_step(case):
    trainer, params, batch = _jax_init()
    lsgm_cfg = jlsgm.LSGMConfig(**CASES[case])
    loss_fn = jlsgm.make_joint_loss_fn(
        trainer.vae, trainer.denoiser, trainer.render_opts,
        jl.LossConfig(lpips_lambda=0.0), lsgm_cfg, PATCH, RENDER)
    key = jax.random.PRNGKey(7)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, {}, batch, key)
    tx = jts.make_optimizer(LR, 0.01, grad_clip=0.5)
    rates = (('ema', 0.5),)
    state = jts.create_train_state(params, tx, ema_rates=rates)
    new = jax.jit(lambda s, g: s.apply_gradients(g, ema_rates=rates))(
        state, grads)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(params=np_tree(params), loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=np_tree(grads), new_params=np_tree(new.params),
                new_ema=np_tree(new.ema_params['ema']), key=key,
                patch=(np.asarray(batch['patch_h']),
                       np.asarray(batch['patch_w'])))


def _port(case):
    want = _jax_step(case)
    trainer = LSGMTrainer(
        _tcfg(), _tunet(),
        LSGMTrainConfig(lr=LR, ema_rate=0.5, patch_resolution=PATCH,
                        render_resolution=RENDER),
        tl.LossConfig(lpips_lambda=0.0), LSGMConfig(**CASES[case]),
        render_opts=tr.RenderOptions(**OPTS), seed=0, device='cpu')
    trainer.joint.load_state_dict(bridge.lsgm_state_dict(want['params']))
    batch = trainer.prepare_batch(tsyn.make_multiview_batch(2, 32, RENDER,
                                                            seed=0))
    draws = _draws(want['key'], batch, (1, 16, 16, 12), (1, 16, 16, 4, 3))
    return want, trainer, batch, draws


@pytest.mark.parametrize('case', sorted(CASES))
def test_joint_step_matches_jax(case):
    """The loss, every metric and every grad of the joint loss, then the
    params and EMA after the AdamW step."""
    want, trainer, batch, draws = _port(case)
    assert np.array_equal(batch['patch_h'].numpy(), want['patch'][0])
    assert np.array_equal(batch['patch_w'].numpy(), want['patch'][1])
    trainer.build()
    loss, metrics = trainer.loss_fn(None, None, batch, draws)
    _close(loss, want['loss'], 1e-4, 'loss')
    assert sorted(metrics) == sorted(want['metrics'])
    for k, v in metrics.items():
        _close(v, want['metrics'][k], 1e-4, k)
    loss.backward()
    want_grads = bridge.lsgm_state_dict(want['grads'])
    params = dict(trainer.joint.named_parameters())
    assert sorted(want_grads) == sorted(params)
    floor = 1e-6 * max(float(g.abs().max()) for g in want_grads.values())
    for k, p in params.items():
        w = want_grads[k]
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(
            _np(g), _np(w), rtol=0, err_msg=k,
            atol=max(1e-4 * float(w.abs().max()), floor))
    trainer.joint.zero_grad(set_to_none=True)
    if case == 'no_vae':
        # the VAE gets no grad at all without the reconstruction and q terms
        assert all(float(want_grads[k].abs().max()) == 0
                   for k in params if k.startswith('vae.'))

    m = trainer.train_step(batch, draws=draws)
    _close(m['loss'], want['loss'], 1e-4)
    new_params = bridge.lsgm_state_dict(want['new_params'])
    new_ema = bridge.lsgm_state_dict(want['new_ema'])
    for k in params:
        w = want_grads[k]
        resolved = _np(w.abs()) >= 10 * max(1e-4 * float(w.abs().max()),
                                            floor)
        for got, ref in ((trainer.state.params[k], new_params[k]),
                         (trainer.state.ema_params['ema'][k], new_ema[k])):
            err = np.abs(_np(got) - _np(ref))
            assert err.max() <= 2 * LR + 1e-6, k
            tol = 1e-5 * float(ref.abs().max()) + 1e-2 * LR
            assert (err[resolved] <= tol).all(), k


def test_q_term_does_not_train_the_unet():
    """The q term alone (its metric) reaches the VAE through the latent
    but no U-Net parameter, the mixing logit included."""
    want, trainer, batch, draws = _port('default')
    trainer.build()
    _, metrics = trainer.loss_fn(None, None, batch, draws)
    metrics['ce_balanced_kl'].backward()
    for k, p in trainer.joint.named_parameters():
        if k.startswith('ddpm.'):
            assert p.grad is None or not p.grad.any(), k
    assert any(p.grad is not None and p.grad.any()
               for p in trainer.vae.encoder.parameters())
    # frozen by detached parameters, not by flipping requires_grad
    assert all(p.requires_grad for p in trainer.denoiser.parameters())


def test_run_loop_stops_at_the_guard_and_moves_both_trees():
    _, trainer, _, _ = _port('default')
    before = {k: p.detach().clone() for k, p in
              trainer.joint.named_parameters()}

    class StopAfterTwo:
        calls = 0

        def should_stop(self):
            self.calls += 1
            return self.calls >= 2

    logs = []
    trainer.cfg.log_interval = 1
    raw = tsyn.make_multiview_batch(2, 32, RENDER, seed=1)
    state = trainer.run_loop(iter([raw] * 5), num_steps=5,
                             guard=StopAfterTwo(), log=logs.append)
    assert state.step == 2
    assert logs[-1] == {'stopped_after_step': 2}
    assert all(np.isfinite(v) for d in logs[:-1] for v in d.values())
    for tree in ('vae.', 'ddpm.'):
        assert any(not torch.equal(p, before[k])
                   for k, p in trainer.joint.named_parameters()
                   if k.startswith(tree)), tree


def test_prepare_batch_scales_the_bbox():
    """The bbox is scaled by render_resolution / img_resolution before
    the patch origins are drawn (JAX's LSGM trainer; the VAE trainer does
    not scale it)."""
    jtrainer, _, _ = _jax_init()
    raw = jsyn.make_multiview_batch(2, 32, RENDER, seed=3)
    raw['bbox'] = np.array([[4, 6, 30, 28], [0, 2, 20, 32]], np.int32)
    jtrainer.rng = np.random.default_rng([0, 0])
    want = jtrainer.prepare_batch(raw)
    _, trainer, _, _ = _port('default')
    trainer.rng = np.random.default_rng([0, 0])
    got = trainer.prepare_batch(raw)
    for k in ('patch_h', 'patch_w'):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_trainer_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        LSGMTrainer(_tcfg(), _tunet())
    with pytest.raises(ValueError, match='p_rendering_loss requires'):
        LSGMTrainer(_tcfg(), _tunet(), lsgm_cfg=LSGMConfig(
            p_rendering_loss=True, train_vae=False), device='cpu').build()
