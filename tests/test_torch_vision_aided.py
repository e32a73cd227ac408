"""The port's vision-aided discriminator (``training/vision_aided.py``)
against the JAX package's, f32, over a toy CLIP vision tower: the CLIP
preprocessing (the antialiased bilinear resize of ``jax.image.resize``),
the multilevel logits (3- and 6-channel), the loss pair with its
one-sided label smoothing, the freeze labels and one discriminator step
(its grads; the backbone out of the optimizer).  JAX's parameters
(perturbed) are carried by ``bridge.vision_aided_state_dict``; tolerance
1e-5 of each output's scale, 1e-4 for the grads of the step.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.conditioning import clip as jclip
from ln3diff_tpu.training import vision_aided as jva
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.conditioning import clip as tclip
from ln3diff_tpu_torch.training import vision_aided as tva

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

CLIP = dict(hidden_size=32, num_layers=4, num_heads=2, intermediate_size=64,
            patch_size=8, image_size=32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rel=1e-5, msg=''):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=msg)


def _cfgs(channels=3):
    return (jva.VisionAidedConfig(clip=jclip.CLIPVisionConfig(**CLIP),
                                  taps=(2, 4), head_width=8,
                                  in_channels=channels),
            tva.VisionAidedConfig(clip=tclip.CLIPVisionConfig(**CLIP),
                                  taps=(2, 4), head_width=8,
                                  in_channels=channels))


@functools.lru_cache(maxsize=None)
def _models(channels=3):
    jcfg, tcfg = _cfgs(channels)
    jm = jva.VisionAidedDiscriminator(jcfg)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, 32, 32, channels)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(p.shape))
        .astype(np.float32), v['params'])
    tm = tva.VisionAidedDiscriminator(tcfg)
    tm.load_state_dict(bridge.vision_aided_state_dict(params))
    return jm, params, tm


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


@pytest.mark.parametrize('size', [16, 32, 48])
def test_clip_preprocess_matches_jax(size):
    jcfg, tcfg = _cfgs()
    x = _images((2, size, size, 3), size)
    _close(tva.clip_preprocess(_t(x), tcfg),
           jva.clip_preprocess(jnp.asarray(x), jcfg))
    jcfg6, tcfg6 = _cfgs(6)
    x6 = _images((1, size, size, 6), size + 1)
    _close(tva.clip_preprocess(_t(x6), tcfg6),
           jva.clip_preprocess(jnp.asarray(x6), jcfg6))
    with pytest.raises(ValueError):
        tva.clip_preprocess(_t(x6), tcfg)


@pytest.mark.parametrize('channels', [3, 6])
def test_multilevel_logits_match_jax(channels):
    jm, params, tm = _models(channels)
    x = _images((2, 16, 16, channels), 2)
    want = jm.apply({'params': params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, msg=str(i))


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    lr = [rng.standard_normal((2, 16)).astype(np.float32),
          rng.standard_normal((2, 1)).astype(np.float32)]
    lf = [rng.standard_normal((2, 16)).astype(np.float32),
          rng.standard_normal((2, 1)).astype(np.float32)]
    J = [[jnp.asarray(a) for a in v] for v in (lr, lf)]
    T = [[_t(a) for a in v] for v in (lr, lf)]
    for s in (0.1, 0.0):
        _close(tva.multilevel_d_loss(*T, smoothing=s),
               jva.multilevel_d_loss(*J, smoothing=s))
    _close(tva.multilevel_g_loss(T[1]), jva.multilevel_g_loss(J[1]))


@pytest.mark.parametrize('channels', [3, 6])
def test_trainable_labels_match_jax(channels):
    jm, params, tm = _models(channels)
    got = tva.trainable_labels([n for n, _ in tm.named_parameters()],
                               channels)
    frozen = {n for n, lab in got.items() if lab == 'frozen'}
    assert frozen and all(n.startswith('backbone.') for n in frozen)
    pe = 'backbone.patch_embedding.weight'
    assert got[pe] == ('trainable' if channels == 6 else 'frozen')
    # the same count of frozen leaves as JAX's label tree
    n_frozen = sum(v == 'frozen' for v in jax.tree_util.tree_leaves(
        jva.trainable_labels(params, channels)))
    assert len(frozen) == n_frozen


@pytest.mark.parametrize('channels', [3, 6])
def test_disc_step_matches_jax(channels):
    """One ``VisionAidedHead`` step: the loss and the trainable grads
    against JAX's; the backbone (but a 6-channel patch embedding) stays
    bit for bit; the heads move by JAX's Adam step."""
    jm, params, _ = _models(channels)
    jcfg, tcfg = _cfgs(channels)
    head = tva.VisionAidedHead(tcfg, device='cpu')
    head.model.load_state_dict(bridge.vision_aided_state_dict(params))
    real, fake = _images((2, 16, 16, channels), 4), _images(
        (2, 16, 16, channels), 5)

    def jloss(p):
        lr = jm.apply({'params': p}, jnp.asarray(real))
        lf = jm.apply({'params': p}, jnp.asarray(fake))
        return jva.multilevel_d_loss(lr, lf, 0.1)

    want, grads = jax.value_and_grad(jloss)(params)
    loss, _ = head.d_loss(_t(real), _t(fake))
    _close(loss, want, 1e-5)
    loss.backward()
    want_g = bridge.vision_aided_state_dict(grads)
    trained = set(head.state.params)
    labels = tva.trainable_labels(list(want_g), channels)
    assert trained == {n for n, lab in labels.items()
                       if lab == 'trainable'}
    gmax = max(float(want_g[k].abs().max()) for k in trained)
    for k, p in head.model.named_parameters():
        if k in trained:
            np.testing.assert_allclose(
                p.grad.numpy(), want_g[k].numpy(), rtol=0, err_msg=k,
                atol=max(1e-4 * float(want_g[k].abs().max()), 1e-6 * gmax))
        else:
            assert p.grad is None, k
    head.model.zero_grad(set_to_none=True)
    before = {k: p.detach().clone() for k, p in
              head.model.named_parameters()}
    head.disc_step(_t(real), _t(fake))
    for k, p in head.model.named_parameters():
        moved = not torch.equal(p, before[k])
        assert moved == (k in trained and bool(want_g[k].any())), k


def test_head_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tva.VisionAidedHead(_cfgs()[1])
    assert tva._vit_b32() == tclip.CLIPVisionConfig(
        hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
        patch_size=32, image_size=224)
    assert dataclasses.asdict(tva.VisionAidedConfig())['adv_lambda'] == 0.025
