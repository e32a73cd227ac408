"""The ControlNet branch, its trainer and the confidence network of the
port against the JAX package's, at toy sizes, f32 on the CPU.

The U-Net is the toy of ``tests/test_unet_controlnet.py`` (8 model
channels, levels (1, 2), one res block, a spatial transformer at rate 2,
roll-out over 8² planes).  The JAX parameters are drawn with seeded
numpy in the shapes of ``jax.eval_shape(init)``, none of them zero (flax
zero-initialises the zero convs and the blocks' last convs, which would
stop every grad before them), and carried across by
``bridge.controlnet_state_dict`` / ``unet_state_dict`` /
``confnet_state_dict``; the trainer's step is fed the draws of JAX's key.
Tolerances: 1e-5 of scale for a module's outputs, 1e-4 of each tensor's
scale for the loss, the grads and the AdamW + EMA step (f32 sums in
another order through two networks), as the other trainer tests.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models import confnet as jconf
from ln3diff_tpu.models import controlnet as jcn
from ln3diff_tpu.models import unet as junet
from ln3diff_tpu.parallel.mesh import MeshConfig, make_mesh
from ln3diff_tpu.training import ldm_trainer as jldm
from ln3diff_tpu.training import train_state as jts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import confnet as tconf
from ln3diff_tpu_torch.models import controlnet as tcn
from ln3diff_tpu_torch.models import unet as tunet
from ln3diff_tpu_torch.training.ldm_trainer import (ControlNetTrainer,
                                                    LDMDraws, LDMTrainConfig)

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

UNET = dict(in_channels=4, model_channels=8, out_channels=4,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=2, use_spatial_transformer=True, context_dim=16,
            roll_out=True)
B = 2
LR, EMA_RATE = 2e-3, 0.5


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


def _inputs(hint_hw, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 8, 8, 12)).astype(np.float32),
            rng.uniform(-1, 1, (B, hint_hw, hint_hw, 3)).astype(np.float32),
            np.array([3.0, 600.0], np.float32),
            rng.standard_normal((B, 7, 16)).astype(np.float32))


def _drawn_like(shapes, seed):
    """Params in the shapes of ``jax.eval_shape(init)``, drawn with numpy
    (a jitted init of each toy costs about 10 s of XLA compile): kernels
    N(0, 1/fan_in), norm scales 1 + 0.05·N(0, 1), the rest 0.05·N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name == 'kernel':
            return z / np.sqrt(np.prod(s.shape[:-1]))
        return z * 0.05 + (1.0 if name == 'scale' else 0.0)

    return jax.tree_util.tree_map_with_path(draw, shapes['params'])


@functools.lru_cache(maxsize=None)
def _jax_params():
    """Params of the toy U-Net and of its ControlNet, none of them zero."""
    cfg = junet.UNetConfig(dtype=jnp.float32, **UNET)
    x, hint, t, ctx = (jnp.asarray(a) for a in _inputs(8))
    u = jax.eval_shape(junet.UNetModel(cfg).init, jax.random.PRNGKey(0), x,
                       t, ctx)
    c = jax.eval_shape(jcn.ControlNet(cfg).init, jax.random.PRNGKey(1), x,
                       hint, t, ctx)
    return _drawn_like(u, 2), _drawn_like(c, 3)


def _port_modules():
    uparams, cparams = _jax_params()
    cfg = tunet.UNetConfig(dtype=torch.float32, **UNET)
    unet, cn = tunet.UNetModel(cfg), tcn.ControlNet(cfg)
    unet.load_state_dict(bridge.unet_state_dict(uparams))
    cn.load_state_dict(bridge.controlnet_state_dict(cparams))
    return unet, cn


@pytest.mark.parametrize('hint_hw', [8, 64, 128])
def test_controlnet_and_controlled_unet_match_jax(hint_hw):
    """The residuals and the controlled U-Net's output: the hint at the
    latent's size (its encoding upsampled), at 8× (tiled over the
    rolled-out planes, no resize) and at 16× (downsampled, antialiased)."""
    uparams, cparams = _jax_params()
    cfg = junet.UNetConfig(dtype=jnp.float32, **UNET)
    x, hint, t, ctx = _inputs(hint_hw, seed=hint_hw)
    J = jnp.asarray
    want = jcn.ControlNet(cfg).apply({'params': cparams}, J(x), J(hint),
                                     J(t), J(ctx))
    want_out = junet.UNetModel(cfg).apply({'params': uparams}, J(x), J(t),
                                          J(ctx), control=want)
    unet, cn = _port_modules()
    with torch.no_grad():
        got = cn(_t(x), _t(hint), _t(t), _t(ctx))
        got_out = unet(_t(x), _t(t), _t(ctx), control=got)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        close_to_scale(g.permute(0, 2, 3, 1), w, 1e-5, f'control {i}')
    close_to_scale(got_out, want_out, 1e-5)


def test_same_pad_matches_linen():
    """``same_pad`` + a stride-2 conv equals Linen's 'SAME' conv: the odd
    pixel of padding at the bottom and right."""
    x = torch.arange(2 * 7 * 6, dtype=torch.float32).reshape(1, 2, 7, 6)
    for k, s in ((3, 2), (4, 2), (3, 1)):
        out = tcn.same_pad(x, k, s)
        H, W = out.shape[2:]
        assert (H - k) // s + 1 == -(-7 // s)
        assert (W - k) // s + 1 == -(-6 // s)
    assert tcn.same_pad(x, 3, 2)[0, 0, :, -1].abs().sum() == 0
    assert tcn.same_pad(x, 3, 2)[0, 0, 0, 0] == 0          # 7 rows: (1, 1)


def test_confnet_matches_jax():
    jm = jconf.ConfNet(base_ch=16)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    params = _drawn_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                        jnp.asarray(x)), 5)
    want = jm.apply({'params': params}, jnp.asarray(x))
    tm = tconf.ConfNet(base_ch=16)
    tm.load_state_dict(bridge.confnet_state_dict(params))
    with torch.no_grad():
        got = tm(_t(x))
    assert tuple(got.shape) == want.shape == (2, 16, 16, 1)
    close_to_scale(got, want, 1e-5)
    target = np.random.default_rng(6).uniform(-1, 1, x.shape).astype(
        np.float32)
    close_to_scale(tconf.confidence_weighted_l2(_t(x), _t(target), got),
                   jconf.confidence_weighted_l2(jnp.asarray(x),
                                                jnp.asarray(target), want),
                   1e-5)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's ControlNet trainer: loss, grads of the branch and one AdamW +
    EMA step, and the draws of its key."""
    uparams, cparams = _jax_params()
    cfg = junet.UNetConfig(dtype=jnp.float32, **UNET)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    trainer = jldm.ControlNetTrainer(
        junet.UNetModel(cfg), jcn.ControlNet(cfg), uparams,
        jldm.LDMTrainConfig(objective='ddpm', lr=LR, ema_rate=EMA_RATE),
        mesh=mesh)
    x, hint, _, ctx = _inputs(8, seed=9)
    batch = {'latent': jnp.asarray(x), 'hint': jnp.asarray(hint),
             'context': {'crossattn': jnp.asarray(ctx)}}
    key = jax.random.PRNGKey(10)
    # the constants of JAX's init_state: the U-Net's params (the branch has
    # no other collection)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        trainer._loss_fn, has_aux=True))(cparams, {'unet': uparams}, batch,
                                         key)
    rates = (('ema', EMA_RATE),)
    st = jts.create_train_state(cparams, jts.make_optimizer(LR, 0.01),
                                ema_rates=rates)
    new = st.apply_gradients(grads, ema_rates=rates)
    k_t, k_n = jax.random.split(key)
    draws = LDMDraws(
        _t(jax.random.randint(k_t, (B,), 0, 1000)).long(),
        _t(jax.random.normal(k_n, x.shape)))
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(loss=float(loss), grads=np_tree(grads),
                new_params=np_tree(new.params),
                new_ema=np_tree(new.ema_params['ema']), draws=draws,
                batch={'latent': _t(x), 'hint': _t(hint),
                       'context': {'crossattn': _t(ctx)}})


def test_controlnet_trainer_step_matches_jax():
    """One ControlNet step against JAX's: the loss, the branch's grads and
    its AdamW + EMA step; the U-Net's parameters, frozen in the train
    state's constants, are bit for bit unchanged and get no grad."""
    want = _jax_step()
    unet, cn = _port_modules()
    trainer = ControlNetTrainer(
        unet, cn, LDMTrainConfig(objective='ddpm', lr=LR,
                                 ema_rate=EMA_RATE), device='cpu')
    # the trainer redraws the branch (zero convs at zero, as JAX's init):
    # load the perturbed JAX weights on top
    cn.load_state_dict(bridge.controlnet_state_dict(_jax_params()[1]))
    frozen = {k: p.detach().clone() for k, p in unet.named_parameters()}
    batch = want['batch']
    loss, _ = trainer._loss_fn(None, None, batch, want['draws'])
    loss.backward()
    close_to_scale(loss, want['loss'], 1e-4)
    want_grads = bridge.controlnet_state_dict(want['grads'])
    assert sorted(want_grads) == sorted(k for k, _ in cn.named_parameters())
    floor = 1e-6 * max(float(g.abs().max()) for g in want_grads.values())
    for k, p in cn.named_parameters():
        w = want_grads[k]
        np.testing.assert_allclose(_np(p.grad), _np(w), rtol=0, err_msg=k,
                                   atol=max(1e-4 * float(w.abs().max()),
                                            floor))
    assert all(p.grad is None for p in unet.parameters())
    cn.zero_grad(set_to_none=True)

    trainer.train_step(batch, draws=want['draws'])
    state = trainer.state
    assert sorted(state.params) == sorted(want_grads)
    assert sorted(state.constants['unet']) == sorted(frozen)
    new_params = bridge.controlnet_state_dict(want['new_params'])
    new_ema = bridge.controlnet_state_dict(want['new_ema'])
    for k, w in want_grads.items():
        resolved = _np(w.abs()) >= 10 * max(1e-4 * float(w.abs().max()),
                                            floor)
        for got, ref in ((state.params[k], new_params[k]),
                         (state.ema_params['ema'][k], new_ema[k])):
            err = np.abs(_np(got) - _np(ref))
            assert err.max() <= 2 * LR + 1e-6, k
            assert (err[resolved] <= 1e-5 * float(ref.abs().max())
                    + 1e-2 * LR).all(), k
    for k, p in unet.named_parameters():
        assert torch.equal(p, frozen[k]), k


def test_controlnet_trainer_init_and_three_steps():
    """From the trainer's own init the zero convs stop every grad before
    them: the first step's grads reach only the zero convs, the second's
    the blocks' zero-initialised last convs, the third's the whole branch.
    After three steps every zero-initialised tensor of the branch has
    moved (weight decay cannot move a zero, only a grad can); the U-Net
    never moves."""
    unet, cn = _port_modules()
    trainer = ControlNetTrainer(unet, cn, LDMTrainConfig(
        objective='ddpm', lr=LR, log_interval=1), device='cpu')
    zero = [k for k, p in cn.named_parameters() if not p.any()]
    assert {'zero_0.weight', 'zero_mid.bias', 'hint_encoder.conv_out.weight',
            'down_0_res_0.out_conv.weight',
            'hint_encoder.conv_0.bias'} <= set(zero)
    frozen = {k: p.detach().clone() for k, p in unet.named_parameters()}
    x, hint, _, ctx = _inputs(8, seed=11)
    data = iter([{'latent': x, 'hint': hint,
                  'context': {'crossattn': ctx}}] * 3)
    logs = []
    trainer.run_loop(data, num_steps=3, log=logs.append)
    assert [d['step'] for d in logs] == [1, 2, 3]
    assert all(np.isfinite(d['cldm_mse']) for d in logs)
    for k, p in unet.named_parameters():
        assert torch.equal(p, frozen[k]), k
    params = dict(cn.named_parameters())
    assert [k for k in zero if not params[k].any()] == []


def test_controlnet_trainer_takes_only_ddpm():
    unet, cn = _port_modules()
    with pytest.raises(ValueError, match='DDPM'):
        ControlNetTrainer(unet, cn, LDMTrainConfig(objective='edm'),
                          device='cpu')
