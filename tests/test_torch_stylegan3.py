"""The port's StyleGAN3 generator against the JAX package:
``design_lowpass_filter`` bit for bit (separable, radial, identity),
``filtered_lrelu`` with the explicit padding on the upsampled grid,
``SynthesisInput`` (its Fourier buffers equal, a perturbed affine so that
the features rotate and shift), ``SynthesisLayerSG3`` (a conv layer with a
non-unit ``magnitude_ema``, and the ToRGB layer) and a tiny
``GeneratorSG3`` (32², 6 layers, channel base 1024 and max 32 as
``tests/test_stylegan3.py``'s ``TINY``) with every 'stats' leaf injected
(``w_avg``, the magnitude EMAs), at ψ = 0.7 and with ``update_emas``.
JAX's weights, every leaf perturbed off its init, are carried by
``bridge.sg3_generator_state_dict``; f32 on both sides; tolerance 1e-5 of
each output's scale."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models import stylegan3 as jsg3
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import stylegan3 as tsg3

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-5
TINY = dict(w_dim=32, img_resolution=32, img_channels=3, channel_base=1024,
            channel_max=32, num_layers=6)


def _close(got, want, rel=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _perturbed(tree, seed, amount=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + amount * rng.standard_normal(p.shape))
        .astype(np.float32), tree)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize('args', [
    (12, 4.0, 4.0, 32.0, False), (12, 4.0, 4.0, 32.0, True),
    (24, 11.3, 9.7, 64.0, False), (6, 2.0, 3.0, 16.0, True),
    (1, 4.0, 4.0, 32.0, False)])
def test_design_lowpass_filter_is_bit_equal(args):
    want = jsg3.design_lowpass_filter(*args[:4], radial=args[4])
    got = tsg3.design_lowpass_filter(*args[:4], radial=args[4])
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_filtered_lrelu_with_padding_matches_jax():
    """up 2, down 2, the asymmetric padding (5, 4, 5, 4) of a layer,
    a separable up filter and a radial down filter, clamp 1."""
    x = _rand((2, 10, 10, 6), 0) * 3
    b = _rand((6,), 1)
    fu = jsg3.design_lowpass_filter(12, 4.0, 4.0, 32.0)
    fd = jsg3.design_lowpass_filter(12, 5.0, 6.0, 32.0, radial=True)
    pad = (5, 4, 5, 4)
    want = jsg3.filtered_lrelu(jnp.asarray(x), fu, fd, jnp.asarray(b), 2,
                               2, pad, np.sqrt(2), 0.2, 1.0)
    got = tsg3.filtered_lrelu(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(tsg3._as_2d(fu)), torch.from_numpy(tsg3._as_2d(fd)),
        torch.from_numpy(b), 2, 2, pad, np.sqrt(2), 0.2, 1.0)
    _close(got.permute(0, 2, 3, 1), want)


def _net_design():
    net = jsg3.SynthesisNetworkSG3(**TINY)
    return net._design()


def test_synthesis_input_matches_jax():
    cutoffs, rates, _, sizes, channels = _net_design()
    args = (32, int(channels[0]), int(sizes[0]), float(rates[0]),
            float(cutoffs[0]))
    jm = jsg3.SynthesisInput(*args)
    w = _rand((2, 32), 2)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), w)
    v = {'params': _perturbed(v['params'], 3), 'stats': v['stats']}
    tm = tsg3.SynthesisInput(*args)
    for k in ('freqs', 'phases', 'transform'):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(v['stats'][k]))
    tm.load_state_dict(bridge.sg3_generator_state_dict(v))
    want = jax.jit(jm.apply)(v, w)
    with torch.no_grad():
        got = tm(torch.from_numpy(w))
    _close(got, want)


@pytest.mark.parametrize('idx', [1, 6], ids=['conv', 'torgb'])
def test_synthesis_layer_matches_jax(idx):
    cutoffs, rates, hw, sizes, channels = _net_design()
    prev = idx - 1
    kw = dict(w_dim=32, is_torgb=idx == 6, is_critically_sampled=idx >= 4,
              out_channels=int(channels[idx]), in_size=int(sizes[prev]),
              out_size=int(sizes[idx]),
              in_sampling_rate=float(rates[prev]),
              out_sampling_rate=float(rates[idx]),
              in_cutoff=float(cutoffs[prev]), out_cutoff=float(cutoffs[idx]),
              in_half_width=float(hw[prev]), out_half_width=float(hw[idx]))
    jm = jsg3.SynthesisLayerSG3(**kw)
    x = _rand((2, int(sizes[prev]), int(sizes[prev]), int(channels[prev])),
              4)
    w = _rand((2, 32), 5)
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), x, w)
    v = {'params': _perturbed(v['params'], 6),
         'stats': {'magnitude_ema': np.float32(2.5)}}
    tm = tsg3.SynthesisLayerSG3(in_channels=int(channels[prev]), **kw)
    tm.load_state_dict(bridge.sg3_generator_state_dict(v))
    want = jax.jit(jm.apply)(v, x, w)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(w))
    assert tm.padding == tuple(int(p) for p in tm.padding)
    _close(got.permute(0, 2, 3, 1), want)


@functools.lru_cache(maxsize=None)
def _generator():
    """The tiny ``GeneratorSG3``'s variables (jitted init, params
    perturbed, ``w_avg`` and every ``magnitude_ema`` drawn) and the port's
    generator with them."""
    kw = dict(z_dim=32, **{k: v for k, v in TINY.items()})
    jm = jsg3.GeneratorSG3(**kw)
    z = jnp.zeros((2, 32))
    v = jax.jit(jm.init)(jax.random.PRNGKey(2), z)
    rng = np.random.default_rng(7)
    stats = jax.tree_util.tree_map(np.asarray, v['stats'])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: ((1.0 + rng.uniform(0, 2, s.shape)).astype(
            np.float32) if 'magnitude_ema' in str(path) else
            rng.standard_normal(s.shape).astype(np.float32)
            if 'w_avg' in str(path) else s), stats)
    v = {'params': _perturbed(v['params'], 8), 'stats': stats}
    tm = tsg3.GeneratorSG3(**kw)
    tm.load_state_dict(bridge.sg3_generator_state_dict(v))
    return jm, v, tm.eval()


def test_sg3_state_dict_covers_the_port():
    _, v, tm = _generator()
    assert sorted(bridge.sg3_generator_state_dict(v)) == sorted(
        tm.state_dict())


def test_generator_sg3_matches_jax():
    """ψ = 0.7 toward the injected ``w_avg``; the output (2, 32, 32, 3)."""
    jm, v, tm = _generator()
    z = _rand((2, 32), 9)
    want = jax.jit(lambda v, z: jm.apply(v, z, truncation_psi=0.7))(v, z)
    with torch.no_grad():
        got = tm(torch.from_numpy(z), truncation_psi=0.7)
    assert tuple(got.shape) == (2, 32, 32, 3)
    _close(got, want)


def test_generator_sg3_update_emas_matches_jax():
    """``update_emas``: the output and every updated 'stats' leaf (the
    mapping's ``w_avg``, each layer's ``magnitude_ema``)."""
    jm, v, _ = _generator()
    tm = tsg3.GeneratorSG3(z_dim=32, **TINY)
    tm.load_state_dict(bridge.sg3_generator_state_dict(v))
    z = _rand((2, 32), 10)
    want, new = jax.jit(lambda v, z: jm.apply(
        v, z, update_emas=True, mutable=['stats']))(v, z)
    with torch.no_grad():
        got = tm(torch.from_numpy(z), update_emas=True)
    _close(got, want)
    new_sd = bridge.sg3_generator_state_dict({'params': v['params'],
                                              **new})
    for k, t in tm.state_dict().items():
        if k.endswith(('magnitude_ema', 'w_avg')):
            _close(t, new_sd[k].numpy())
