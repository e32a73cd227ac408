"""The stage-2 latent-diffusion trainer of the port against the JAX
trainer, on the toy text DiT of ``tests/test_training.py`` (latent 8² × 3
planes × 4 channels, hidden 32, depth 2, context 7 × 16), f32 on the CPU.

Every JAX parameter is perturbed with seeded numpy noise (flax
zero-initialises the adaLN modulations and the final layer, which would
make most grads vanish) and carried across by ``bridge.dit_state_dict``,
which maps JAX's grad tree onto the port's names too.  The port is fed
the draws of JAX's ``_loss_fn`` key (t, the noise and the EDM σ indices,
rebuilt from its ``jax.random.split``s).  Tolerances: 1e-5 of scale for a
module's output, 1e-4 of each tensor's scale for the loss, every grad and
the AdamW + EMA step (f32 sums in another order through the network), as
the VAE trainer's test; remat recomputes the same ops, so its grads
match the plain ones to 1e-6 of scale.  JAX compiles slowly, so each
case's JAX step is computed once (``functools.lru_cache``).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.conditioning import conditioner as jcond
from ln3diff_tpu.data import objaverse as jobj
from ln3diff_tpu.data import synthetic as jsyn
from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.models import vit as jvit
from ln3diff_tpu.parallel.mesh import MeshConfig, make_mesh
from ln3diff_tpu.training import ldm_trainer as jldm
from ln3diff_tpu.training import train_state as jts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.conditioning import conditioner as tcond
from ln3diff_tpu_torch.data import objaverse as tobj
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models import vit as tvit
from ln3diff_tpu_torch.training import train_state as tts
from ln3diff_tpu_torch.training.ldm_trainer import (LDMDraws, LDMTrainConfig,
                                                    LDMTrainer)

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
           depth=2, num_heads=2, variant='text', context_dim=16)
B = 4
LR, EMA_RATE = 2e-3, 0.5
# objective → trainer options (ddpm: the learned-range hybrid loss)
CASES = {
    'flow_matching': dict(learn_sigma=False, cfg={}),
    'ddpm': dict(learn_sigma=True, cfg=dict(var_type='learned_range',
                                            loss_type='rescaled_mse')),
    'edm': dict(learn_sigma=False, cfg={}),
}


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float64)


def close_to_scale(got, want, rel, msg=''):
    want, got = _np(want), _np(got)
    assert got.shape == want.shape, msg
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=msg)


def _t(x):
    return torch.from_numpy(np.array(x))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32)), params)


def _batch(seed=0, lead=(B,)):
    rng = np.random.default_rng(seed)
    return {'latent': rng.standard_normal(lead + (8, 8, 12)).astype(
                np.float32),
            'context': {'crossattn': rng.standard_normal(
                lead + (7, 16)).astype(np.float32)}}


def _jcfg(learn_sigma, dtype=jnp.float32):
    return jdit.DiTConfig(learn_sigma=learn_sigma, dtype=dtype, **DIT)


def _tcfg(learn_sigma, dtype=torch.float32, **kw):
    return tdit.DiTConfig(learn_sigma=learn_sigma, dtype=dtype, **DIT, **kw)


def _train_cfg(objective):
    return dict(objective=objective, lr=LR, ema_rate=EMA_RATE,
                log_interval=1000, **CASES[objective]['cfg'])


@functools.lru_cache(maxsize=None)
def _jax_init(learn_sigma):
    """Perturbed params of the toy DiT from JAX's trainer init."""
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    trainer = jldm.LDMTrainer(jdit.DiT_TriLatent(_jcfg(learn_sigma)),
                              jldm.LDMTrainConfig(), mesh=mesh)
    state = trainer.init_state(_batch())
    return mesh, _perturbed(state.params, 1), state.constants


def _draws(objective, key, trainer):
    """The draws of JAX's ``_loss_fn(rng=key)`` for ``objective``."""
    shape = (B, 8, 8, 12)
    k1, k2 = jax.random.split(key)
    noise = _t(jax.random.normal(k2, shape))
    if objective == 'flow_matching':
        t = trainer.transport.sample_t(k1, B)
        return LDMDraws(_t(t), noise)
    if objective == 'ddpm':
        n = trainer.diffusion.num_timesteps
    else:
        n = 1000
    return LDMDraws(_t(jax.random.randint(k1, (B,), 0, n)).long(), noise)


@functools.lru_cache(maxsize=None)
def _jax_step(objective, dtype='float32'):
    """JAX's loss, metrics, grads and one AdamW + EMA step for
    ``objective`` (compute dtype ``dtype``), and the draws of its key."""
    learn_sigma = CASES[objective]['learn_sigma']
    mesh, params, constants = _jax_init(learn_sigma)
    trainer = jldm.LDMTrainer(
        jdit.DiT_TriLatent(_jcfg(learn_sigma, jnp.dtype(dtype))),
        jldm.LDMTrainConfig(**_train_cfg(objective)), mesh=mesh)
    batch = jax.tree_util.tree_map(jnp.asarray, _batch())
    key = jax.random.PRNGKey(7)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        trainer._loss_fn, has_aux=True))(params, constants, batch, key)
    rates = (('ema', EMA_RATE),)
    state = jts.create_train_state(params, jts.make_optimizer(LR, 0.01),
                                   ema_rates=rates)
    new = jax.jit(lambda s, g: s.apply_gradients(g, ema_rates=rates))(
        state, grads)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(params=np_tree(params), loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=np_tree(grads), new_params=np_tree(new.params),
                new_ema=np_tree(new.ema_params['ema']),
                draws=_draws(objective, key, trainer))


def _port_trainer(objective, dtype=torch.float32, **cfg_kw):
    want = _jax_step(objective)
    model = tdit.DiT_TriLatent(_tcfg(CASES[objective]['learn_sigma'], dtype,
                                     **cfg_kw))
    trainer = LDMTrainer(model, LDMTrainConfig(**_train_cfg(objective)),
                         device='cpu')
    trainer.model.load_state_dict(bridge.dit_state_dict(want['params']))
    batch = {'latent': _t(_batch()['latent']),
             'context': {'crossattn': _t(_batch()['context']['crossattn'])}}
    return want, trainer, batch


def _grads_of(trainer, batch, draws):
    loss, metrics = trainer._loss_fn(None, None, batch, draws)
    loss.backward()
    # the caption embedder's null embedding is not read: no grad (zero)
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for k, p in trainer.model.named_parameters()}
    trainer.model.zero_grad(set_to_none=True)
    return loss, metrics, grads


@pytest.mark.parametrize('objective', sorted(CASES))
def test_train_step_matches_jax(objective):
    """One step of the port's trainer against JAX's from the same params,
    batch and draws: the loss and metrics, every grad, and the params and
    EMA after the clip, AdamW and EMA."""
    want, trainer, batch = _port_trainer(objective)
    loss, metrics, grads = _grads_of(trainer, batch, want['draws'])
    close_to_scale(loss, want['loss'], 1e-4, 'loss')
    assert sorted(metrics) == sorted(want['metrics'])
    for k, v in metrics.items():
        close_to_scale(v, want['metrics'][k], 1e-4, k)
    want_grads = bridge.dit_state_dict(want['grads'])
    assert sorted(want_grads) == sorted(grads)
    # the attention's key bias has a zero grad in exact arithmetic: both
    # sides hold f32 noise there, so the bound has a floor of 1e-6 of the
    # model's largest grad
    floor = 1e-6 * max(float(g.abs().max()) for g in want_grads.values())
    for k, g in grads.items():
        w = want_grads[k]
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, err_msg=k,
                                   atol=max(1e-4 * float(w.abs().max()),
                                            floor))

    m = trainer.train_step(batch, draws=want['draws'])
    close_to_scale(m['loss'], want['loss'], 1e-4)
    new_params = bridge.dit_state_dict(want['new_params'])
    new_ema = bridge.dit_state_dict(want['new_ema'])
    state = trainer.state
    # A first AdamW step moves a weight by lr·ĝ/(|ĝ| + 1e-8): where the
    # grad is resolved it matches to 1e-5 of scale plus 1e-2·lr; at the
    # noise floor it may differ by up to 2·lr (tests/test_torch_training.py)
    for k, w in want_grads.items():
        resolved = _np(w.abs()) >= 10 * max(1e-4 * float(w.abs().max()),
                                            floor)
        for got, ref in ((state.params[k], new_params[k]),
                         (state.ema_params['ema'][k], new_ema[k])):
            err = np.abs(_np(got) - _np(ref))
            assert err.max() <= 2 * LR + 1e-6, k
            tol = 1e-5 * float(ref.abs().max()) + 1e-2 * LR
            assert (err[resolved] <= tol).all(), k


def test_learn_sigma_dit_matches_jax():
    """The DiT with the variance head: (B, 8, 8, 24) in (mean C, var C) ×
    planes, f32, within 1e-5 of scale."""
    _, params, constants = _jax_init(True)
    b = _batch(2)
    t = np.array([3.0, 250.0, 999.0, 10.0], np.float32)
    want = jdit.DiT_TriLatent(_jcfg(True)).apply(
        {'params': params, **constants}, jnp.asarray(b['latent']),
        jnp.asarray(t), {'crossattn': jnp.asarray(b['context']['crossattn'])})
    model = tdit.DiT_TriLatent(_tcfg(True))
    model.load_state_dict(bridge.dit_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = model(_t(b['latent']), _t(t),
                    {'crossattn': _t(b['context']['crossattn'])})
    assert tuple(got.shape) == want.shape == (B, 8, 8, 24)
    close_to_scale(got, want, 1e-5)


@pytest.mark.parametrize('policy', ['full', 'dots'])
def test_remat_grads_equal_plain_grads(policy):
    """``remat`` recomputes each DiT block (and each DiT2 pair) in the
    backward pass; the loss and every grad equal those without it."""
    want, plain, batch = _port_trainer('ddpm')
    _, remat, _ = _port_trainer('ddpm', remat=True, remat_policy=policy)
    draws = want['draws']
    l0, _, g0 = _grads_of(plain, batch, draws)
    l1, _, g1 = _grads_of(remat, batch, draws)
    close_to_scale(l1, l0, 1e-6)
    for k in g0:
        close_to_scale(g1[k], g0[k], 1e-6, k)

    cfg = tdit.DiT2Config(tokens_per_plane=16, hidden_size=32, depth=2,
                          num_heads=2, dtype=torch.float32)
    d2 = tdit.DiT2(cfg)
    d2r = tdit.DiT2(dataclasses.replace(cfg, remat=True,
                                        remat_policy=policy))
    d2r.load_state_dict(d2.state_dict())
    c = torch.randn(2, 48, 32, generator=torch.Generator().manual_seed(0))
    grads = []
    for m in (d2, d2r):
        (m(c)**2).mean().backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
    for k in grads[0]:
        close_to_scale(grads[1][k], grads[0][k], 1e-6, k)


def test_bf16_step_gap_within_twice_jax_bf16():
    """The port's bf16 step (autocast over f32 params) against JAX's f32
    step is no further than twice JAX's own bf16 step (``dtype=bfloat16``
    over f32 params): the loss and the grads, as max |Δ| over all
    tensors relative to JAX f32's largest value."""
    f32, jbf16 = _jax_step('flow_matching'), _jax_step('flow_matching',
                                                       'bfloat16')
    _, trainer, batch = _port_trainer('flow_matching', torch.bfloat16)
    loss, _, grads = _grads_of(trainer, batch, f32['draws'])
    ref = bridge.dit_state_dict(f32['grads'])
    jb = bridge.dit_state_dict(jbf16['grads'])
    scale = max(float(g.abs().max()) for g in ref.values())

    def gap(gs):
        return max(float((gs[k] - ref[k]).abs().max()) for k in ref) / scale

    assert abs(float(loss.detach()) - f32['loss']) <= 2 * abs(jbf16['loss']
                                                     - f32['loss'])
    assert gap(grads) <= 2 * gap(jb), (gap(grads), gap(jb))


def test_per_sample_metrics_flattened_in_draw_order():
    """``build_train_step`` with two microbatches: rank-2 leaves split on
    their leading axis, lower ranks broadcast, ``per_sample*`` metrics
    concatenated in draw order and the others averaged (the port's
    counterpart of ``tests/test_training.py``'s microbatch scan test)."""
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.ones(()))
    state = tts.TrainState.create(module, tts.make_optimizer(1e-3))
    seen = []

    def loss_fn(params, constants, batch, draws):
        x = batch['x']
        seen.append((tuple(x.shape), float(batch['scale'])))
        return (params['w'] * x).sum() * batch['scale'], {
            'per_sample_loss': x, 'mean_metric': x.sum()}

    step = tts.build_train_step(loss_fn, microbatch_steps=2)
    metrics = step(state, {'x': torch.arange(8.0).reshape(2, 4),
                           'scale': torch.tensor(2.0)})
    assert seen == [((4,), 2.0), ((4,), 2.0)]
    assert torch.equal(metrics['per_sample_loss'], torch.arange(8.0))
    assert float(metrics['mean_metric']) == 14.0
    assert float(metrics['loss']) == 28.0 and state.step == 1
    # the grads are averaged: d(loss)/dw = mean over the microbatches
    assert float(metrics['grad_norm']) == 28.0


def test_microbatches_average_grads():
    """``microbatch_steps=2`` over two copies of one batch with the same
    draws takes the step of the batch itself."""
    want, one, batch = _port_trainer('edm')
    _, two, _ = _port_trainer('edm')
    two.cfg = dataclasses.replace(two.cfg, microbatch_steps=2)
    stacked = {'latent': torch.stack([batch['latent']] * 2),
               'context': {'crossattn': torch.stack(
                   [batch['context']['crossattn']] * 2)}}
    m1 = one.train_step(batch, draws=want['draws'])
    m2 = two.train_step(stacked, draws=[want['draws']] * 2)
    for k in m1:
        close_to_scale(m2[k], m1[k], 1e-6, k)
    for k, p in one.state.params.items():
        close_to_scale(two.state.params[k], p, 1e-6, k)


def test_resampler_feedback_with_microbatches():
    """``schedule_sampler='loss-second-moment'`` under two microbatches of
    three: t and its weights come from the host resampler for every
    sample, and every per-sample loss returns to its history; the loop's
    eval hook runs at its interval and a guard stops it."""
    model = tdit.DiT_TriLatent(_tcfg(True))
    trainer = LDMTrainer(model, LDMTrainConfig(
        objective='ddpm', diffusion_steps=100, triplane_scaling_divider=1.0,
        schedule_sampler='loss-second-moment', var_type='learned_range',
        loss_type='rescaled_mse', microbatch_steps=2, log_interval=1),
        device='cpu')
    data = (_batch(i, lead=(2, 3)) for i in range(10))
    logs, evals = [], []

    class Guard:
        calls = 0

        def should_stop(self):
            self.calls += 1
            return self.calls == 4

    trainer.run_loop(data, num_steps=6, eval_interval=2,
                     eval_fn=lambda s, step: evals.append(step),
                     guard=Guard(), log=logs.append)
    assert trainer.resampler._loss_counts.sum() == 4 * 2 * 3
    assert np.isfinite(trainer.resampler._loss_history).all()
    assert evals == [2, 4]
    assert [d['step'] for d in logs if 'step' in d] == [1, 2, 3, 4]
    assert logs[-1] == {'stopped_after_step': 4}
    assert trainer.state.step == 4


def test_trainer_refuses_what_it_cannot_train():
    with pytest.raises(ValueError, match='fused_attention'):
        LDMTrainer(tdit.DiT_TriLatent(_tcfg(False, fused_attention=True)),
                   device='cpu')
    # a mesh with a pipe axis drives the DiT's trunk: another model is
    # refused (a stand-in mesh: only its axis sizes are read)
    pipe_mesh = type('PipeMesh', (), {'shape': (1, 2, 1, 1)})()
    with pytest.raises(ValueError, match='pipeline parallelism'):
        LDMTrainer(torch.nn.Linear(2, 2), device='cpu', mesh=pipe_mesh)


def test_trainer_init_zeroes_what_jax_zeroes():
    """The trainer's random init is zero exactly where JAX's trainer init
    is: biases, adaLN modulations and the final linear (adaLN-zero)."""
    _jax_init(False)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    state = jldm.LDMTrainer(jdit.DiT_TriLatent(_jcfg(False)),
                            jldm.LDMTrainConfig(), mesh=mesh).init_state(
                                _batch())
    init = bridge.dit_state_dict(jax.tree_util.tree_map(np.asarray,
                                                        state.params))
    want = sorted(k for k, v in init.items() if not v.any())
    trainer = LDMTrainer(tdit.DiT_TriLatent(_tcfg(False)), device='cpu')
    got = sorted(k for k, p in trainer.model.named_parameters()
                 if not p.any())
    assert got == want
    assert 'final_layer.linear.weight' in got


# -- the conditioning of the multi-view and size-conditioned configs ----------

def test_plucker_embedding_matches_jax_bytewise():
    cams = jsyn.make_multiview_batch(3, 32, 16, seed=4)['c']
    for c in cams:
        for res in (7, 16):
            a = tobj.plucker_embedding(c, res)
            b = jobj.plucker_embedding(c, res)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_dino_mv_plucker_embedder_matches_jax():
    """Two samples of three views with their cameras through a toy 9-channel
    ViT: the tokens flattened across the first two views, and zeros as the
    unconditional value; within 1e-5 of scale."""
    kw = dict(img_size=28, patch_size=14, embed_dim=32, depth=1,
              num_heads=2, layerscale=True, exact_gelu=True)
    jm = jvit.VisionTransformer(jvit.ViTConfig(**kw))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 28, 28, 9)))
    variables = {'params': _perturbed(variables['params'], 5)}
    tm = tvit.VisionTransformer(tvit.ViTConfig(**kw), in_channels=9)
    tm.load_state_dict(bridge.vit_state_dict(
        jax.tree_util.tree_map(np.asarray, variables['params'])))
    rng = np.random.default_rng(6)
    images = rng.uniform(-1, 1, (2, 3, 28, 28, 3)).astype(np.float32)
    cams = np.stack([jsyn.make_multiview_batch(3, 32, 16, seed=s)['c']
                     for s in (1, 2)])
    je = jcond.make_dino_mv_plucker_embedder(variables, jm, n_cond_frames=2)
    te = tcond.make_dino_mv_plucker_embedder(tm, n_cond_frames=2)
    assert te.input_key == je.input_key == 'img-c'
    want = je.encode((images, cams))['dino']
    got = te.encode((images, cams))['dino']
    assert tuple(got.shape) == want.shape == (2, 2 * 5, 32)
    close_to_scale(got, want, 1e-5)
    assert np.array_equal(te.uncond(2)['dino'].numpy(),
                          np.asarray(je.uncond(2)['dino']))
    assert not te.is_trainable


def test_concat_timestep_embedder_matches_jax():
    je = jcond.make_concat_timestep_embedder(outdim=16)
    te = tcond.make_concat_timestep_embedder(outdim=16, device='cpu')
    sizes = np.array([[256.0, 256.0], [512.0, 384.0], [0.0, 17.0]],
                     np.float32)
    close_to_scale(te.encode(sizes)['vector'], je.encode(sizes)['vector'],
                   1e-5)
    close_to_scale(te.encode(sizes[:, 0])['vector'],
                   je.encode(sizes[:, 0])['vector'], 1e-5)
    close_to_scale(te.uncond(3)['vector'], je.uncond(3)['vector'], 1e-6)
    assert te.input_key == 'original_size_as_tuple'
