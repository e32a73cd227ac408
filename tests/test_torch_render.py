"""The port's render core against ``ln3diff_tpu.render``.

Same numpy inputs through both; JAX runs its deterministic paths
(``key=None``), which are the port's only ones.  Tolerances are f32 ones (1e-5 abs for
single functions) unless a test says otherwise.
"""

import numpy as np
import os
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.render import camera as jcam
from ln3diff_tpu.render import math_utils as jmu
from ln3diff_tpu.render import mesh as jmesh
from ln3diff_tpu.render import ray_marcher as jrm
from ln3diff_tpu.render import ray_sampler as jrs
from ln3diff_tpu.render import renderer as jr
from ln3diff_tpu.ops.fused_render import FusedOSG as JFusedOSG
from ln3diff_tpu_torch.ops.fused_render import FusedOSG
from ln3diff_tpu_torch.render import camera as tcam
from ln3diff_tpu_torch.render import math_utils as tmu
from ln3diff_tpu_torch.render import mesh as tmesh
from ln3diff_tpu_torch.render import ray_marcher as trm
from ln3diff_tpu_torch.render import ray_sampler as trs
from ln3diff_tpu_torch.render import renderer as tr

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


def _rays(n=40, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (1, n, 3)).astype(np.float32)
    d = rng.standard_normal((1, n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_orbit_cameras_identical():
    close(tcam.orbit_cameras(7, 1.7, 35.0, 15.0),
          jcam.orbit_cameras(7, 1.7, 35.0, 15.0), atol=0, rtol=0)


def test_ray_limits_and_linspace():
    o, d = _rays()
    jt = jmu.fix_invalid_ray_limits(*jmu.get_ray_limits_box(
        jnp.asarray(o), jnp.asarray(d), 0.9))
    tt = tmu.fix_invalid_ray_limits(*tmu.get_ray_limits_box(T(o), T(d), 0.9))
    for a, b in zip(tt, jt):
        close(a, b, atol=1e-6)
    close(tmu.linspace_vec(tt[0], tt[1], 5),
          jmu.linspace_vec(jt[0], jt[1], 5), atol=1e-6)


def test_full_rays():
    cams = jcam.orbit_cameras(3)
    jo, jd = jrs.sample_full_rays(*jrs.unpack_25d_camera(jnp.asarray(cams)),
                                  8)
    to, td = trs.sample_full_rays(*trs.unpack_25d_camera(T(cams)), 8)
    close(to, jo, atol=1e-6)
    close(td, jd, atol=1e-6)


def _planes(B=1, H=16, C=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 3, H, H, C)) * 0.3).astype(np.float32)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_packed_gather(dtype):
    """Corner table and gather: rows bitwise, fractions to 1e-6."""
    planes = _planes(B=2)
    rng = np.random.default_rng(1)
    coords = rng.uniform(-0.7, 0.7, (2, 90, 3)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jr.pack_corner_table(jnp.asarray(planes).astype(jd))
    tp = tr.pack_corner_table(T(planes).to(td))
    close(tp.float(), np.asarray(jp.astype(jnp.float32)), atol=0, rtol=0)
    jproj = jr.project_onto_planes(jnp.asarray(coords) * (2.0 / 0.9))
    tproj = tr.project_onto_planes(T(coords) * (2.0 / 0.9))
    close(tproj, jproj, atol=0, rtol=0)
    jout = jr.packed_gather(jp, jproj, 16, 16)
    tout = tr.packed_gather(tp, tproj, 16, 16)
    close(tout[0].float(), np.asarray(jout[0].astype(jnp.float32)), atol=0,
          rtol=0)
    for a, b in zip(tout[1:], jout[1:]):
        close(a.float(), np.asarray(b.astype(jnp.float32)), atol=1e-6)
    assert tout[3].dtype == td


def test_sample_from_planes():
    planes = _planes()
    coords = np.random.default_rng(2).uniform(
        -0.6, 0.6, (1, 50, 3)).astype(np.float32)
    close(tr.sample_from_planes(T(planes), T(coords), 0.9),
          jr.sample_from_planes(jnp.asarray(planes), jnp.asarray(coords),
                                0.9), atol=1e-6)


def _samples(S=12, n=10, C=4, seed=3):
    rng = np.random.default_rng(seed)
    depths = np.sort(rng.uniform(1.0, 2.5, (1, n, S, 1)), axis=2)
    return (depths.astype(np.float32),
            rng.uniform(-1, 1, (1, n, S, C)).astype(np.float32),
            (rng.standard_normal((1, n, S, 1)) * 3).astype(np.float32))


def test_march_rays():
    d, c, s = _samples()
    want = jrm.march_rays(jnp.asarray(c), jnp.asarray(s), jnp.asarray(d))
    got = trm.march_rays(T(c), T(s), T(d))
    for a, b in zip(got, want):
        close(a, b)


def test_sample_importance_det():
    d, c, s = _samples()
    coarse = jrm.march_rays(jnp.asarray(c), jnp.asarray(s), jnp.asarray(d))
    want = jr.sample_importance(None, jnp.asarray(d), coarse.weights, 9)
    got = tr.sample_importance(T(d), T(np.asarray(coarse.weights)), 9)
    close(got, want)


@pytest.mark.parametrize('fn', ['unify_samples', 'merge_and_march'])
def test_merge_coarse_fine(fn):
    d1, c1, s1 = _samples(seed=4)
    d2, c2, s2 = _samples(S=9, seed=5)
    args = (d1, c1, s1, d2, c2, s2)
    want = getattr(jr, fn)(*map(jnp.asarray, args))
    got = getattr(tr, fn)(*map(T, args))
    for a, b in zip(got, want):
        close(a, b)


def _osg(C=8, seed=6):
    rng = np.random.default_rng(seed)
    return dict(w1=(rng.standard_normal((C, 64)) * 0.3).astype(np.float32),
                b1=(rng.standard_normal(64) * 0.1).astype(np.float32),
                w2=(rng.standard_normal((64, 9)) * 0.3).astype(np.float32),
                b2=(rng.standard_normal(9) * 0.1
                    + np.array([2.0] + [0.0] * 8)).astype(np.float32))


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('bbox', [False, True])
def test_render_rays_deterministic(fused, bbox):
    """Two-pass render, JAX with key=None (the port is deterministic),
    through the plain decoder or the fused point pipeline (its plain
    version on the CPU)."""
    planes = _planes(seed=7)
    w = _osg()
    cams = jcam.orbit_cameras(2, radius=1.8)
    opts_kw = dict(depth_resolution=8, depth_resolution_importance=8,
                   ray_start='auto', ray_end='auto', box_warp=0.9,
                   filter_out_of_bbox=bbox)
    jopts, topts = jr.RenderOptions(**opts_kw), tr.RenderOptions(**opts_kw)

    def jdec(feats, dirs):
        x = jnp.mean(feats, axis=1)
        h = jax.nn.softplus(x @ w['w1'] + w['b1'])
        out = h @ w['w2'] + w['b2']
        return jax.nn.sigmoid(out[..., 1:]) * 1.002 - 0.001, out[..., :1]

    def tdec(feats, dirs):
        x = torch.mean(feats, dim=1)
        h = torch.nn.functional.softplus(x @ T(w['w1']) + T(w['b1']))
        out = h @ T(w['w2']) + T(w['b2'])
        return torch.sigmoid(out[..., 1:]) * 1.002 - 0.001, out[..., :1]

    o, d = jrs.sample_full_rays(*jrs.unpack_25d_camera(jnp.asarray(cams)),
                                6)
    jplanes = jnp.broadcast_to(jnp.asarray(planes), (2,) + planes.shape[1:])
    want = jr.render_rays(
        None, jplanes, jdec, o, d, jopts,
        fused_osg=JFusedOSG(**{k: jnp.asarray(v) for k, v in w.items()})
        if fused else None)
    got = tr.render_rays(
        T(np.asarray(jplanes)), tdec, T(np.asarray(o)), T(np.asarray(d)),
        topts,
        fused_osg=FusedOSG(**{k: T(v) for k, v in w.items()})
        if fused else None)
    for a, b in zip(got, want):
        close(a, b, atol=1e-5, rtol=1e-4)


def test_sigma_grid_query_and_smoothing():
    """Chunked σ grid with the 3³ smoothing vs JAX.  The raw field is
    held to 1e-3 relative (one f16 rounding of the same f32 σ).  The
    smoothed one runs three separable f16 passes whose sums XLA rounds
    elsewhere than torch's per-op f16, measured at up to 3 f16 ulps:
    6e-3 relative (6 ulps of f16's 2^-10)."""
    planes = _planes(seed=8)
    w = _osg(seed=9)

    def jdec(coords):
        feats = jr.sample_from_planes(jnp.asarray(planes), coords, 0.9)
        h = jax.nn.softplus(jnp.mean(feats, 1) @ w['w1'] + w['b1'])
        out = h @ w['w2'] + w['b2']
        return out[..., 1:], out[..., :1]

    def tdec(coords):
        feats = tr.sample_from_planes(T(planes), coords, 0.9)
        h = torch.nn.functional.softplus(feats.mean(1) @ T(w['w1'])
                                         + T(w['b1']))
        out = h @ T(w['w2']) + T(w['b2'])
        return out[..., 1:], out[..., :1]

    for smooth in (False, True):
        want = jmesh.query_grid_sigma(jdec, 12, chunk=500, smooth=smooth)
        got = tmesh.query_grid_sigma(tdec, 12, chunk=500, smooth=smooth)
        assert got.dtype == torch.float16 and got.shape == (12**3,)
        close(got.float(), np.asarray(want, np.float32), atol=2e-3,
              rtol=6e-3 if smooth else 1e-3)
