"""The port's mesh stage against the JAX package on the CPU.

``ln3diff_tpu_torch.render.mesh`` and ``ln3diff_tpu.render.mesh`` get the
same numpy σ grids, vertices and planes (made from seeds with numpy):
the crossing census must agree exactly, both marchers (the same C++
source, built with the same flags) must give identical triangles, the
writers identical bytes, and the vertex colours, which go through the
fused point kernel's plain version on the port's side, must agree within
the tolerances the port's VAE tests hold that path to.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models.dit import DiT2Config as JDiT2Config
from ln3diff_tpu.models.vae import TriplaneVAE as JVAE
from ln3diff_tpu.models.vae import TriplaneVAEConfig as JVAEConfig
from ln3diff_tpu.render import mesh as jmesh
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models.dit import DiT2Config
from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
from ln3diff_tpu_torch.render import mesh as tmesh

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _field(kind, g=32, seed=0):
    rng = np.random.default_rng(seed)
    lin = np.linspace(-1, 1, g)
    x, y, z = np.meshgrid(lin, lin, lin, indexing='ij')
    if kind == 'blob':        # a real iso-surface with some roughness
        f = 12 - 9 * np.sqrt(x**2 + y**2 + z**2) + rng.normal(0, 0.5, x.shape)
    elif kind == 'noise':     # nearly every cell crosses
        f = rng.normal(10.0, 8.0, x.shape)
    elif kind == 'empty':
        f = np.zeros(x.shape)
    else:                     # solid: every corner above the threshold
        f = np.full(x.shape, 99.0)
    return f.astype(np.float32)


@pytest.mark.parametrize('dtype', [np.float32, np.float16])
@pytest.mark.parametrize('kind', ['blob', 'noise', 'empty', 'solid'])
def test_count_crossing_cells_matches_jax(kind, dtype):
    f = _field(kind, g=24, seed=2).astype(dtype)
    got = tmesh.count_crossing_cells(torch.from_numpy(f.reshape(-1)), 24)
    want = jmesh.count_crossing_cells(jnp.asarray(f.reshape(-1)), 24)
    assert int(got) == int(want) == tmesh._crossing_cells(
        f.astype(np.float32), 10.0).size


@pytest.mark.parametrize('kind', ['blob', 'noise', 'empty'])
def test_march_grid_identical_to_jax(kind):
    f = _field(kind, g=32, seed=3)
    tv, tf = tmesh.march_grid(f, 32)
    jv, jf = jmesh.march_grid(f, 32)
    assert tv.dtype == jv.dtype and tf.dtype == jf.dtype
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert len(tf) == len(tv) // 3
    if kind != 'empty':
        assert len(tf) > 0


def test_march_grid_realloc_and_cap(monkeypatch):
    """A first buffer smaller than the mesh is reallocated once to the
    exact size; over ``max_tris_cap`` the cell-order prefix comes back
    with a warning, the same triangles as JAX's capped run."""
    f = _field('noise', g=32, seed=1)
    full_v, full_f = tmesh.march_grid(f, 32)
    monkeypatch.setattr(tmesh, 'FIRST_GUESS_TRIS', 8)
    v, fc = tmesh.march_grid(f, 32)
    np.testing.assert_array_equal(v, full_v)
    np.testing.assert_array_equal(fc, full_f)
    cap = max(len(full_f) // 3, 1)
    with pytest.warns(RuntimeWarning, match='max_tris_cap'):
        v, fc = tmesh.march_grid(f, 32, max_tris_cap=cap)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        jv, _ = jmesh.march_grid(f, 32, max_tris_cap=cap)
    assert len(fc) == cap
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(v, full_v[:cap * 3])


def test_rotate_x_exact():
    v = np.random.default_rng(4).uniform(-0.45, 0.45, (500, 3)) \
        .astype(np.float32)
    for deg in (-90.0, 30.0):
        got = tmesh.rotate_x(v, deg)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jmesh.rotate_x(v, deg))


def test_export_obj_and_ply_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    verts = rng.uniform(-0.45, 0.45, (300, 3)).astype(np.float32)
    colors = rng.uniform(-0.1, 1.1, (300, 3)).astype(np.float32)
    faces = np.arange(300, dtype=np.int64).reshape(100, 3)
    for ext, tw, jw in (('obj', tmesh.export_obj, jmesh.export_obj),
                        ('ply', tmesh.export_ply, jmesh.export_ply)):
        tw(str(tmp_path / f'port.{ext}'), verts, colors, faces)
        jw(str(tmp_path / f'jax.{ext}'), verts, colors, faces)
        assert (tmp_path / f'port.{ext}').read_bytes() == \
            (tmp_path / f'jax.{ext}').read_bytes()
    with pytest.raises(OSError):
        tmesh.export_obj(str(tmp_path / 'missing' / 'x.obj'), verts, colors,
                         faces)


# -- point decoders ----------------------------------------------------------

def _sphere(radius=0.3):
    """σ = 10 + 200·(radius − r): the iso-surface σ = 10 is the sphere."""
    def jdec(pts):
        r = jnp.linalg.norm(pts, axis=-1, keepdims=True)
        return jnp.clip(pts * 0.5 + 0.5, 0, 1), 10.0 + (radius - r) * 200.0

    def tdec(pts):
        r = torch.linalg.norm(pts, dim=-1, keepdim=True)
        return torch.clamp(pts * 0.5 + 0.5, 0, 1), 10.0 + (radius - r) * 200.0
    return jdec, tdec


def test_extract_mesh_sphere_from_shared_grid():
    """The analytic sphere: σ grids agree to f16 rounding; from the same
    grid both extract identical triangles; every vertex lies within one
    voxel of the sphere; colours agree to f32 rounding."""
    jdec, tdec = _sphere()
    g = 40
    jgrid = jmesh.query_grid_sigma(jdec, g, chunk=4096)
    tgrid = tmesh.query_grid_sigma(tdec, g, chunk=4096)
    np.testing.assert_allclose(tgrid.float().numpy(),
                               np.asarray(jgrid, np.float32), rtol=1e-3,
                               atol=2e-2)
    jv, jc, jf = jmesh.extract_mesh(jdec, g, chunk=4096, sigma_grid=jgrid)
    tv, tc, tf = tmesh.extract_mesh(
        tdec, g, chunk=4096,
        sigma_grid=torch.from_numpy(np.array(jgrid)))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tc, jc, atol=1e-6)
    radii = np.linalg.norm(tv, axis=-1)
    voxel = 0.9 / (g - 1)
    assert len(tf) > 100
    assert np.abs(radii - 0.3).max() < voxel
    assert (tc >= 0).all() and (tc <= 1).all()


def _vaes():
    d2 = dict(tokens_per_plane=16, hidden_size=32, depth=2, num_heads=2)
    kw = dict(ldm_z_channels=4, latent_size=8, patch_size=2, conv_sr_ch=8,
              conv_sr_ch_mult=(1, 2), conv_sr_res_blocks=1,
              plane_channels=8, decoder_output_dim=8)
    jm = JVAE(JVAEConfig(encoder_ch=8, encoder_ch_mult=(1, 2),
                         img_resolution=32, num_views=2,
                         dit2=JDiT2Config(dtype=jnp.float32, **d2),
                         dtype=jnp.float32, **kw))
    v = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 12)),
                jnp.zeros((1, 25)), JOpts(depth_resolution=4,
                                          depth_resolution_importance=4), 4,
                method=jm.init_decoder_paths)
    v = {'params': jax.tree_util.tree_map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.PRNGKey(8),
                                               p.shape), v['params'])}
    tm = TriplaneVAE(TriplaneVAEConfig(
        dit2=DiT2Config(dtype=torch.float32, **d2), dtype=torch.float32,
        **kw))
    tm.load_state_dict(bridge.vae_state_dict(
        jax.tree_util.tree_map(np.asarray, v)))
    return jm, v, tm


@pytest.mark.parametrize('planes_dtype', ['float32', 'bfloat16'])
def test_dispatch_vertex_colors_matches_jax(planes_dtype):
    """Per-vertex colours through the fused point path (JAX: its jnp
    reference off the TPU; port: the kernel's plain version), 700
    vertices in ragged chunks of 256.  f32 planes: 1e-5, as the port's VAE
    point query is held; bf16 planes: 2e-2, the gap between the bf16-lerp
    plain version and JAX's f32-lerp reference (ROADMAP §3).  The uint8
    colours agree to one level where the floats do not straddle a step."""
    jm, v, tm = _vaes()
    planes = (np.random.default_rng(8).standard_normal((1, 3, 8, 8, 8))
              * 0.5).astype(np.float32)
    verts = np.random.default_rng(9).uniform(-0.45, 0.45, (700, 3)) \
        .astype(np.float32)
    jp = jnp.asarray(planes, getattr(jnp, planes_dtype))
    tp = torch.from_numpy(planes).to(getattr(torch, planes_dtype))

    def jdec(coords):
        return jm.apply(v, jp, coords, 0.9, use_fused_osg=True,
                        method=jm.query_points)

    def tdec(coords):
        return tm.query_points(tp, coords, 0.9, use_fused_osg=True)

    tol = 1e-5 if planes_dtype == 'float32' else 2e-2
    want = np.asarray(jmesh.dispatch_vertex_colors(jdec, verts, chunk=256))
    with torch.no_grad():
        got = tmesh.dispatch_vertex_colors(tdec, verts, chunk=256)
        got8 = tmesh.dispatch_vertex_colors(tdec, verts, chunk=256,
                                            as_uint8=True)
    assert got.shape == (700, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    want8 = np.asarray(jmesh.dispatch_vertex_colors(jdec, verts, chunk=256,
                                                    as_uint8=True))
    assert got8.dtype == torch.uint8
    np.testing.assert_array_equal(
        got8.numpy(), (np.clip(got.numpy(), 0, 1) * 255).astype(np.uint8))
    assert np.abs(got8.numpy().astype(int) - want8.astype(int)).max() <= \
        (1 if planes_dtype == 'float32' else 6)
    assert tmesh.dispatch_vertex_colors(tdec, np.zeros((0, 3),
                                                       np.float32)) is None
