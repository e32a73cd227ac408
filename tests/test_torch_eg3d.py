"""The port's EG3D generator against the JAX package: the Gaussian and
uniform pose samplers (bit for bit from one ``numpy.random.Generator``
seed), the StyleGAN2 synthesis block with a ToRGB of other than 3
channels and a w of other than 512 (the widths the EG3D backbone needs),
and ``TriPlaneGenerator``'s ``generate_planes``, ``forward`` (truncation
ψ = 0.7 toward a non-zero ``w_avg``: image, depth, planes, ws) and
``query_points`` at the toy size of ``tests/test_eg3d_warmup.py`` (z 16,
w 32, 16² planes of 8 channels).  JAX's weights, every leaf perturbed off
its init, are carried by ``bridge.eg3d_generator_state_dict``; f32 on
both sides; tolerance 1e-5 of each output's scale."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models import eg3d as jeg3d
from ln3diff_tpu.models import stylegan as jsg
from ln3diff_tpu.render import camera as jcam
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import eg3d as teg3d
from ln3diff_tpu_torch.models import stylegan as tsg
from ln3diff_tpu_torch.render import camera as tcam
from ln3diff_tpu_torch.render.renderer import RenderOptions

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TOL = 1e-5
OPTS = dict(depth_resolution=4, depth_resolution_importance=4,
            ray_start=2.25, ray_end=3.3, box_warp=1.0, white_back=False)
GEN = dict(z_dim=16, c_dim=25, w_dim=32, plane_resolution=16,
           plane_channels=8, decoder_output_dim=8)


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


@pytest.mark.parametrize('sampler', ['gaussian_pose', 'uniform_pose'])
def test_pose_samplers_are_bit_equal(sampler):
    """The warm-up's camera distribution (and its uniform twin), from the
    same seeded generator, equal JAX's bit for bit."""
    kw = dict(horizontal_stddev=0.3, vertical_stddev=0.155, radius=2.7,
              batch_size=7)
    want = getattr(jcam, sampler)(np.random.default_rng([3, 0]),
                                  np.pi / 2, np.pi / 2, **kw)
    got = getattr(tcam, sampler)(np.random.default_rng([3, 0]),
                                 np.pi / 2, np.pi / 2, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('skip', [True, False], ids=['skip', 'first'])
def test_synthesis_block_wide_rgb_matches_jax(skip):
    """``SynthesisBlockSG2`` 8² → 16² with a 24-channel image skip and a
    w of 32, and without a skip (``img=None``)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    img = rng.standard_normal((2, 8, 8, 24)).astype(np.float32)
    w = rng.standard_normal((2, 32)).astype(np.float32)
    jm = jsg.SynthesisBlockSG2(12, 16, img_channels=24)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), x, img, w)
    v = {'params': _perturbed(v['params'], 1)}
    tm = tsg.SynthesisBlockSG2(16, 12, 16, img_channels=24, w_dim=32)
    tm.load_state_dict(bridge.unet_state_dict(v))
    img = img if skip else None
    want = jax.jit(jm.apply)(v, x, img, w)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 None if img is None else
                 torch.from_numpy(img).permute(0, 3, 1, 2),
                 torch.from_numpy(w))
    for g, wnt in zip(got, want):
        _close(g.permute(0, 2, 3, 1), wnt)


@functools.lru_cache(maxsize=None)
def _generator():
    """JAX's ``TriPlaneGenerator`` variables (jitted init, perturbed, a
    random ``w_avg``) and the port's generator with them."""
    cfg = jeg3d.TriPlaneGeneratorConfig(**GEN)
    jm = jeg3d.TriPlaneGenerator(cfg)
    cam = tcam.orbit_cameras(2, radius=2.7, fov=18.837, pitch_deg=0.0)
    v = jax.jit(lambda k: jm.init(
        k, jnp.zeros((2, 16)), jnp.asarray(cam), JOpts(**OPTS), 8,
        jnp.zeros((2, 25))))(jax.random.PRNGKey(0))
    w_avg = np.random.default_rng(2).standard_normal(32).astype(np.float32)
    v = {'params': _perturbed(v['params'], 1),
         'stats': {'mapping': {'w_avg': w_avg}}}
    tm = teg3d.TriPlaneGenerator(teg3d.TriPlaneGeneratorConfig(**GEN))
    tm.load_state_dict(bridge.eg3d_generator_state_dict(v))
    return jm, v, tm.eval()


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2, 16)).astype(np.float32)
    c = rng.standard_normal((2, 25)).astype(np.float32)
    cam = jcam.gaussian_pose(rng, np.pi / 2, np.pi / 2, 0.3, 0.155, 2.7, 2)
    intr = jcam.fov_to_intrinsics(18.837)
    cam25 = np.concatenate([cam.reshape(2, 16),
                            np.tile(intr.reshape(1, 9), (2, 1))], 1)
    return z, c, cam25.astype(np.float32)


def test_generator_state_dict_covers_the_port():
    """Every parameter and the ``w_avg`` buffer come from JAX's
    variables."""
    _, v, tm = _generator()
    sd = bridge.eg3d_generator_state_dict(v)
    assert sorted(sd) == sorted(tm.state_dict())
    np.testing.assert_array_equal(tm.mapping.w_avg.numpy(),
                                  v['stats']['mapping']['w_avg'])


def test_generate_planes_matches_jax():
    jm, v, tm = _generator()
    z, c, _ = _inputs()
    want = jax.jit(lambda v, z, c: jm.apply(
        v, z, c, 0.7, method=jm.generate_planes))(v, z, c)
    with torch.no_grad():
        got = tm.generate_planes(torch.from_numpy(z), torch.from_numpy(c),
                                 truncation_psi=0.7)
    assert tuple(got.shape) == (2, 3, 16, 16, 8)
    _close(got, want)


def test_forward_matches_jax():
    """The teacher's call of the warm-up: zeroed pose label, ψ = 0.7,
    16² render, every output."""
    jm, v, tm = _generator()
    z, _, cam = _inputs(4)
    c0 = np.zeros((2, 25), np.float32)
    want = jax.jit(lambda v, z, cam, c: jm.apply(
        v, z, cam, JOpts(**OPTS), 16, c, truncation_psi=0.7,
        return_ws=True))(v, z, cam, c0)
    with torch.no_grad():
        got = tm(torch.from_numpy(z), torch.from_numpy(cam),
                 RenderOptions(**OPTS), 16, torch.from_numpy(c0),
                 truncation_psi=0.7, return_ws=True)
    assert sorted(got) == sorted(want)
    assert tuple(got['ws'].shape) == (2, 3, 32)
    for k in want:
        _close(got[k], want[k])


def test_query_points_matches_jax():
    jm, v, tm = _generator()
    rng = np.random.default_rng(5)
    planes = rng.standard_normal((2, 3, 16, 16, 8)).astype(np.float32)
    coords = rng.uniform(-0.5, 0.5, (2, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, p, x: jm.apply(
        v, p, x, 1.0, method=jm.query_points))(v, planes, coords)
    with torch.no_grad():
        got = tm.query_points(torch.from_numpy(planes),
                              torch.from_numpy(coords), 1.0)
    for g, w in zip(got, want):
        _close(g, w)


def test_random_teacher_draws_at_jax_init_scale():
    """``random_init_`` draws the mapping's equalized-lr weights (lr
    multiplier 0.01) at JAX's N(0, 1/lr²), so that a random teacher's w
    has JAX's unit scale instead of collapsing through eight layers of
    0.01 gain: both sides' sample std within 10% of 100 (5 standard
    errors of a std over 1,024 draws)."""
    from ln3diff_tpu_torch.models.layers import random_init_
    jm, v, _ = _generator()
    tm = teg3d.TriPlaneGenerator(teg3d.TriPlaneGeneratorConfig(**GEN))
    random_init_(tm, torch.Generator().manual_seed(0))
    init = jax.jit(lambda k: jm.init(
        k, jnp.zeros((2, 16)), jnp.asarray(_inputs()[2]), JOpts(**OPTS), 8,
        jnp.zeros((2, 25))))(jax.random.PRNGKey(1))['params']
    for i in range(8):
        want = float(np.std(np.asarray(init['mapping'][f'fc{i}']['kernel'])))
        got = float(getattr(tm.mapping, f'fc{i}').weight.detach().std())
        assert abs(got / 100 - 1) < 0.1 and abs(want / 100 - 1) < 0.1, (
            i, got, want)
    z, _, _ = _inputs(6)
    with torch.no_grad():
        ws = tm.mapping(torch.from_numpy(z), torch.zeros((2, 25)))
    assert 0.1 < float(ws.std()) < 10
