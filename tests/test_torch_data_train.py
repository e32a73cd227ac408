"""The shard-fed training flow of ``tests/test_integration_wds.py`` on the
port against JAX's: shards → ``load_wds_data`` with ``PostProcess`` → the
views flattened → one VAE step; and latent shards → ``DiffPostProcess`` →
one ``LDMTrainer`` step.

* Shards of three synthetic instances (2 views of 32²) are written by the
  port's ``ShardWriter``; each package streams them with its own
  ``PostProcess(reso_encoder=32, reso_render=16, num_views_input=2)``, and
  the raw batches are equal bit for bit.
* The tiny VAE of ``tests/test_torch_training.py`` (f32, JAX's perturbed
  params through ``bridge.vae_state_dict``) takes that batch: the patch
  origins equal JAX's; fed JAX's draws (``k_vae, k_render = split(key)``,
  ``k_strat, k_imp = split(k_render)``), the loss is within 1e-5 relative
  of JAX's ``_loss_fn`` and every grad within 1e-4 of its scale (floor:
  1e-6 of the model's largest grad, for grads that are zero in exact
  arithmetic); then ``train_step`` gives finite metrics.
* Latent shards through ``DiffPostProcess`` give JAX's batches, and one
  flow-matching ``LDMTrainer`` step of a toy DiT on the streamed batch
  equals, bit for bit, the step on the same latents stacked in memory.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax

from ln3diff_tpu.data import objaverse as jobj
from ln3diff_tpu.data import wds as jwds
from ln3diff_tpu.parallel.mesh import MeshConfig, make_mesh
from ln3diff_tpu.render import renderer as jr
from ln3diff_tpu.training import losses as jl
from ln3diff_tpu.training.vae_trainer import VAETrainConfig as JTrainConfig
from ln3diff_tpu.training.vae_trainer import VAETrainer as JTrainer
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.data import objaverse as tobj
from ln3diff_tpu_torch.data import synthetic as tsyn
from ln3diff_tpu_torch.data import wds as twds
from ln3diff_tpu_torch.render import renderer as tr
from ln3diff_tpu_torch.training import losses as tl
from ln3diff_tpu_torch.training.vae_trainer import (TrainDraws,
                                                    VAETrainConfig,
                                                    VAETrainer)

from test_torch_data import same
from test_torch_training import OPTS, _jcfg, _np, _perturbed, _t, _tcfg

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

PP = dict(reso_encoder=32, reso_render=16, num_views_input=2)
STREAM = dict(batch_size=1, shuffle_buffer=2, seed=0, rank=0,
              num_replicas=1)


def flatten_views(r):
    """The integration test's view flattening (instances × views → rows)."""
    return {
        'img_to_encoder': r['img_to_encoder'].reshape(-1, 32, 32, 10),
        'img': r['img'].reshape(-1, 16, 16, 3),
        'depth': r['depth'].reshape(-1, 16, 16),
        'depth_mask': r['depth_mask'].reshape(-1, 16, 16),
        'c': r['c'].reshape(-1, 25),
        'bbox': r['bbox'].reshape(-1, 4),
    }


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp('shards')
    w = twds.ShardWriter(str(d / 'objv-%06d.tar'), maxcount=4)
    for i in range(3):
        b = tsyn.make_multiview_batch(num_views=2, resolution=32,
                                      render_resolution=32, seed=i)
        w.write(f'{i:06d}', {
            'rgb.npy': ((b['img_hr'] + 1) / 2).astype(np.float32),
            'depth.npy': b['depth'].astype(np.float32),
            'alpha.npy': b['depth_mask'].astype(np.float32),
            'c.npy': b['c'],
            'caption.txt': f'sphere {i}',
        })
    w.close()
    return w.paths


@functools.lru_cache(maxsize=None)
def _jax_step(paths):
    """JAX's trainer on the first streamed batch: params (perturbed), patch
    origins, loss, terms, grads and the draws of its key."""
    raw = next(jwds.load_wds_data(list(paths), transform=jobj.PostProcess(
        **PP), **STREAM))
    flat = flatten_views(raw)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    trainer = JTrainer(_jcfg(), JTrainConfig(patch_resolution=8,
                                             render_resolution=16),
                       jl.LossConfig(lpips_lambda=0.0),
                       render_opts=jr.RenderOptions(**OPTS), mesh=mesh,
                       seed=0)
    params = _perturbed(trainer.init_state(flat).params, 31)
    batch = trainer.prepare_batch(flat)
    key = jax.random.PRNGKey(11)
    (loss, terms), grads = jax.jit(jax.value_and_grad(
        trainer._loss_fn, has_aux=True))(params, None, batch, key)
    k_vae, k_render = jax.random.split(key)
    k_strat, k_imp = jax.random.split(k_render)
    R, S = 8 * 8, OPTS['depth_resolution']
    draws = TrainDraws(
        _t(jax.random.normal(k_vae, (1, 16, 16, 4, 3))),
        tr.RenderDraws(
            _t(jax.random.uniform(k_strat, (2, R, S, 1))),
            _t(jax.random.uniform(k_imp, (2 * R, OPTS[
                'depth_resolution_importance'])))))
    tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(raw=raw, params=tree(params), loss=float(loss),
                terms={k: float(v) for k, v in terms.items()},
                grads=tree(grads), draws=draws,
                patch=(np.asarray(batch['patch_h']),
                       np.asarray(batch['patch_w'])))


def test_shard_batch_matches_jax(shards):
    got = next(twds.load_wds_data(shards, transform=tobj.PostProcess(**PP),
                                  **STREAM))
    same(got, _jax_step(tuple(shards))['raw'])
    assert got['img_to_encoder'].shape == (1, 2, 32, 32, 10)


def test_shard_fed_vae_step_matches_jax(shards):
    want = _jax_step(tuple(shards))
    raw = next(twds.load_wds_data(shards, transform=tobj.PostProcess(**PP),
                                  **STREAM))
    trainer = VAETrainer(
        _tcfg(), VAETrainConfig(patch_resolution=8, render_resolution=16),
        tl.LossConfig(lpips_lambda=0.0),
        render_opts=tr.RenderOptions(**OPTS), seed=0, device='cpu')
    trainer.model.load_state_dict(bridge.vae_state_dict(want['params']))
    batch = trainer.prepare_batch(flatten_views(raw))
    assert np.array_equal(batch['patch_h'].numpy(), want['patch'][0])
    assert np.array_equal(batch['patch_w'].numpy(), want['patch'][1])

    loss, terms = trainer.loss_fn(batch, draws=want['draws'])
    got_loss = float(loss.detach())
    assert abs(got_loss - want['loss']) <= 1e-5 * abs(want['loss'])
    assert sorted(terms) == sorted(want['terms'])
    loss.backward()
    want_grads = bridge.vae_state_dict(want['grads'])
    params = dict(trainer.model.named_parameters())
    assert sorted(want_grads) == sorted(params)
    floor = 1e-6 * max(float(g.abs().max()) for g in want_grads.values())
    for k, p in params.items():
        w = want_grads[k]
        np.testing.assert_allclose(
            _np(p.grad), _np(w), rtol=0, err_msg=k,
            atol=max(1e-4 * float(w.abs().max()), floor))
    trainer.model.zero_grad(set_to_none=True)
    metrics = trainer.train_step(batch, draws=want['draws'])
    assert np.isfinite(float(metrics['loss']))
    assert float(metrics['grad_norm']) > 0


DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
           depth=2, num_heads=2, variant='text', context_dim=16)


def test_latent_shards_feed_the_ldm_step(tmp_path):
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
    from ln3diff_tpu_torch.training.ldm_trainer import (LDMDraws,
                                                        LDMTrainConfig,
                                                        LDMTrainer)
    rng = np.random.default_rng(9)
    latents = {f'{i:06d}': rng.standard_normal((8, 8, 12)).astype(
        np.float32) for i in range(6)}
    w = twds.ShardWriter(str(tmp_path / 'lat-%06d.tar'), maxcount=4)
    for k, v in latents.items():
        w.write(k, {'latent.npy': v, 'caption.txt': f'latent {k}'})
    w.close()
    kw = dict(batch_size=4, shuffle_buffer=3, seed=2, rank=0,
              num_replicas=1)
    got = next(twds.load_wds_data(w.paths, transform=tobj.DiffPostProcess(),
                                  **kw))
    same(got, next(jwds.load_wds_data(
        w.paths, transform=jobj.DiffPostProcess(), **kw)))
    keys = [c.split()[1] for c in got['caption']]
    memory = np.stack([latents[k] for k in keys])
    same(got['latent'], memory)

    ctx = torch.from_numpy(rng.standard_normal((4, 5, 16)).astype(
        np.float32))
    draws = LDMDraws(torch.tensor([0.2, 0.4, 0.6, 0.8]),
                     torch.from_numpy(rng.standard_normal(
                         (4, 8, 8, 12)).astype(np.float32)))

    def step(latent):
        trainer = LDMTrainer(
            DiT_TriLatent(DiTConfig(**DIT, dtype=torch.float32)),
            LDMTrainConfig(objective='flow_matching', lr=1e-3,
                           log_interval=10**9), seed=4, device='cpu')
        trainer.build()
        m = trainer.train_step({'latent': torch.from_numpy(latent),
                                'context': {'crossattn': ctx}}, draws)
        return m, {k: v.detach().clone()
                   for k, v in trainer.model.named_parameters()}

    m_a, p_a = step(got['latent'])
    m_b, p_b = step(memory)
    assert np.isfinite(float(m_a['loss']))
    assert float(m_a['loss']) == float(m_b['loss'])
    for k in p_a:
        assert torch.equal(p_a[k], p_b[k]), k
