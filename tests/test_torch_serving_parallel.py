"""Sharded serving (``ln3diff_tpu_torch/parallel/serving.py``) on four
gloo ranks against the one-rank call.

* ``shard_orbit_render`` and ``shard_points_query`` on toy per-frame and
  per-point functions: equal to the direct call, with a point count that
  is neither a multiple of the ranks nor of the chunk; an indivisible
  frame count is refused.
* The toy text→3D ``__call__`` (``build_t23d_pipeline`` with
  ``serving_mesh``: the orbit's frames and the σ grid's points over the
  data ranks) against the same call without it, from the same seed and
  start noise: latents, frames and σ grid bit for bit (every rank runs
  the one-rank code on its share), and the same mesh vertices; with the
  flat-ray renderer the frames within 1e-6 (a rank's ray batch holds its
  own frames).
* DDIM sampling with CFG through a toy DiT split over four tensor ranks
  (``tp_shard_denoiser_params``) against the whole DiT, within 2e-4 of
  scale (JAX's ``test_tp_sharded_sampling_matches_single_device``): every
  projection split (qkv in the per-head layout, the attention on
  heads/4), and a threshold that splits qkv and the MLP but leaves the
  output projection whole (the qkv output gathered).
"""

import os

import numpy as np
import pytest
import torch

import _torch_parallel_tasks as tasks
from _torch_ranks import RankPool

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp('ranks'))
    yield p
    p.close()


@pytest.mark.parametrize('n_points,chunk', [(4 * 37 + 3, 16), (40, 64)])
def test_shard_orbit_and_points(pool, n_points, chunk):
    for o in pool.run(tasks.shard_functions, n_points, chunk):
        np.testing.assert_array_equal(o['orbit'], o['orbit_ref'])
        np.testing.assert_allclose(o['rgb'], o['rgb_ref'], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(o['sigma'], o['sigma_ref'], rtol=0,
                                   atol=1e-6)
        assert o['sigma'].shape == (1, n_points, 1)
        assert o['refused']


@pytest.mark.parametrize('flat', [False, True])
def test_serving_mesh_call_matches_one_rank(pool, tmp_path, flat):
    for o in pool.run(tasks.serving_call, str(tmp_path), 8, 20, flat):
        s, p = o['sharded'], o['plain']
        assert s['video'].shape == p['video'].shape == (1, 8, 8, 8, 3)
        for k in ('latents', 'sigma'):
            np.testing.assert_array_equal(s[k], p[k], err_msg=k)
        # flat rays: a rank folds its own frames into one ray batch, so
        # the point MLP's row blocks differ from the one-rank call's
        np.testing.assert_allclose(s['video'], p['video'], rtol=0,
                                   atol=0 if not flat else 1e-6)
        np.testing.assert_array_equal(s['verts'], p['verts'])


@pytest.mark.parametrize('min_size', [0, 16384])
def test_tp_sampling_matches_whole_denoiser(pool, min_size):
    outs = pool.run(tasks.tp_sampling, min_size)
    for o in outs:
        scale = max(1.0, float(np.abs(o['ref']).max()))
        np.testing.assert_allclose(o['got'], o['ref'], rtol=0,
                                   atol=2e-4 * scale)
        np.testing.assert_array_equal(o['got'], outs[0]['got'])
    kinds = outs[0]['kinds']
    assert kinds['attn.qkv'] == 'ColumnParallelLinear'
    assert kinds['mlp.fc1'] == 'ColumnParallelLinear'
    assert kinds['mlp.fc2'] == 'RowParallelLinear'
    if min_size == 0:
        assert kinds['attn.proj'] == 'RowParallelLinear'
        assert outs[0]['heads'] == 1
    else:
        assert 'attn.proj' not in kinds
        assert outs[0]['heads'] == 4
