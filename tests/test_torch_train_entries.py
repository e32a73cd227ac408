"""The port's training entry points (``ln3diff_tpu_torch/scripts/``) at
toy sizes on the CPU, and their multi-rank halves on two gloo ranks.

* Each CLI's ``run([... '--device', 'cpu'])`` (``main`` over it) with toy
  models: ``vit_triplane_train`` trains 2 steps, writes a checkpoint,
  resumes it to step 3 and runs ``--inference --save_latent``;
  ``vit_triplane_diffusion_train`` per objective and ``vpsde_joint``;
  ``vit_triplane_sit_train``; ``vit_triplane_cvD_train`` with either
  discriminator; ``vit_triplane_cldm_train`` (its random U-Net moved off
  the zero init, so that the loss depends on the ControlNet).  Finite
  metrics, a nonzero ``grad_norm`` and a trained parameter that the steps
  changed, the step count, the files written.
* ``vit_triplane_train`` on two ranks against one: the same global batch
  (two instances, one per rank) and the same global draws, full-view
  patches (patch = render resolution, so that the per-rank host draw of
  patch origins picks the one origin): the first step's averaged grads
  within 1e-5 of each grad's scale (floors 1e-4 of it and 1e-6 of the
  largest: grads that are zero in exact arithmetic hold f32 noise), after
  2 steps the last loss within 1e-5 relative and every parameter whose
  grad is resolved within 1e-5 of its scale plus 1e-2·lr (the others
  within the 2·2 AdamW steps of lr that noise can take).
* ``PreemptionGuard`` across the two ranks: SIGTERM to one rank stops
  both after the same step (the next poll whose count is a multiple of
  ``check_interval``), as ``tests/test_distributed_smoke.py`` shows for
  JAX; ``StatsCollector.sync`` sums the moments of both ranks and
  ``report0`` reports on rank 0 only.
"""

import os

import numpy as np
import pytest
import torch

from ln3diff_tpu_torch import cli as tcli
from ln3diff_tpu_torch.models.dit import DiTConfig
from ln3diff_tpu_torch.models.stylegan import DiscriminatorConfig
from ln3diff_tpu_torch.models.unet import UNetConfig
from ln3diff_tpu_torch.conditioning.clip import CLIPVisionConfig
from ln3diff_tpu_torch.scripts import (vit_triplane_cldm_train,
                                       vit_triplane_cvD_train,
                                       vit_triplane_diffusion_train,
                                       vit_triplane_sit_train,
                                       vit_triplane_train)

import _torch_parallel_tasks as tasks
from _torch_ranks import RankPool

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

COMMON = ['--device', 'cpu', '--total_steps', '2', '--save_interval', '2',
          '--log_interval', '1', '--batch_size', '2']
VIEWS = ['--num_views', '2', '--encoder_resolution', '32',
         '--render_resolution', '16', '--patch_rendering_resolution', '16']
DIT = DiTConfig(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
                depth=2, num_heads=2, variant='text', context_dim=16,
                dtype=torch.float32)
UNET = dict(in_channels=4, model_channels=8, out_channels=4,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=2, context_dim=16, roll_out=True, dtype=torch.float32)
LR = 1e-4          # ExperimentConfig's


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    p = RankPool(2, tmp_path_factory.mktemp('ranks'))
    yield p
    p.close()


def _finite(metrics):
    assert metrics and all(np.isfinite(v) for v in metrics.values()), \
        metrics


@pytest.fixture
def first(monkeypatch):
    """The trained parameters of each trainer before its first step, by
    ``id(trainer)``."""
    from ln3diff_tpu_torch.training import (ldm_trainer, lsgm_trainer,
                                            vae_trainer)
    seen = {}
    for cls in (vae_trainer.VAETrainer, ldm_trainer.LDMTrainer,
                lsgm_trainer.LSGMTrainer):
        def step(self, *a, _fn=cls.train_step, **k):
            seen.setdefault(id(self), {
                n: v.detach().clone() for n, v in self.state.params.items()})
            return _fn(self, *a, **k)
        monkeypatch.setattr(cls, 'train_step', step)
    return seen


def _trained(trainer, metrics, first):
    """The steps trained: a nonzero grad norm, and a parameter moved."""
    assert metrics['grad_norm'] > 0, metrics
    before = first[id(trainer)]
    assert any(not torch.equal(v, trainer.state.params[n])
               for n, v in before.items())


def test_vae_entry_trains_resumes_and_infers(tmp_path, first):
    argv = COMMON + VIEWS + ['--logdir', str(tmp_path)]
    cfg = tasks.TOY_VAE_CFG()
    trainer, metrics = vit_triplane_train.run(argv, model_cfg=cfg)
    _finite(metrics)
    _trained(trainer, metrics, first)
    assert trainer.state.step == 2 and metrics['step'] == 2
    assert sorted(os.listdir(tmp_path / 'checkpoints')) == ['2']
    assert (tmp_path / 'args.json').exists()
    resumed, metrics = vit_triplane_train.run(
        argv + ['--resume_checkpoint', '1', '--total_steps', '3'],
        model_cfg=cfg)
    assert resumed.state.step == 3 and metrics['step'] == 3
    _trained(resumed, metrics, first)
    vit_triplane_train.run(argv + ['--resume_checkpoint', '1',
                                   '--inference', '1', '--save_latent', '1'],
                           model_cfg=cfg)
    files = sorted(os.listdir(tmp_path / 'eval'))
    assert files[:8] == [f'latent_0000.npy'] + [
        f'nv_0000_{i:03d}.png' for i in range(7)]
    assert np.load(tmp_path / 'eval' / 'latent_0000.npy').shape == \
        (2, 16, 16, 12)


def test_vae_entry_two_ranks_equal_one(pool, tmp_path):
    argv = COMMON + VIEWS
    one = tasks.vae_entry(argv + ['--logdir', str(tmp_path / 'one')])
    two = pool.run(tasks.vae_entry, argv + ['--logdir',
                                            str(tmp_path / 'two')])
    gmax = max(float(np.abs(g).max()) for g in one['grads'].values())
    for o in two:
        assert o['step'] == 2
        np.testing.assert_allclose(o['metrics']['loss'],
                                   one['metrics']['loss'], rtol=1e-5)
        for k, g in one['grads'].items():
            floor = max(1e-4 * float(np.abs(g).max()), 1e-6 * gmax)
            np.testing.assert_allclose(o['grads'][k], g, rtol=0,
                                       atol=max(1e-5 * float(
                                           np.abs(g).max()), floor),
                                       err_msg=k)
            v, got = one['params'][k], o['params'][k]
            # where the grad is resolved the two steps agree closely; a
            # grad that is zero in exact arithmetic (a conv bias before a
            # GroupNorm) holds f32 noise, which AdamW turns into steps of
            # up to lr: at most 2 steps of lr·(1 + wd·|p|) per run
            resolved = np.abs(g) >= 10 * floor
            scale = max(float(np.abs(v).max()), 1e-30)
            err = np.abs(got - v)
            assert (err[resolved] <= 1e-5 * scale + 1e-2 * LR).all(), k
            assert (err <= 4 * LR * (1 + 0.01 * np.abs(v))).all(), k


@pytest.mark.parametrize('objective', ['flow_matching', 'ddpm', 'edm'])
def test_diffusion_entry(tmp_path, objective, first):
    trainer, metrics = vit_triplane_diffusion_train.run(
        COMMON + ['--objective', objective, '--logdir', str(tmp_path)],
        den_cfg=DIT)
    _finite(metrics)
    _trained(trainer, metrics, first)
    assert trainer.state.step == 2
    assert os.listdir(tmp_path / 'checkpoints') == ['2']


def test_diffusion_entry_lsgm_joint(tmp_path, first):
    trainer, metrics = vit_triplane_diffusion_train.run(
        COMMON + ['--objective', 'vpsde_joint',
                  '--patch_rendering_resolution', '8',
                  '--logdir', str(tmp_path)],
        vae_cfg=tasks.TOY_VAE_CFG(),
        unet_cfg=UNetConfig(**dict(UNET, use_spatial_transformer=False,
                                   mixed_prediction=True)))
    _finite(metrics)
    _trained(trainer, metrics, first)
    assert trainer.state.step == 2
    assert {'p_eps_loss', 'rec_kl'} <= set(metrics)


def test_sit_entry(tmp_path, first):
    trainer, metrics = vit_triplane_sit_train.run(
        COMMON + ['--path_type', 'linear', '--t_sampling', 'uniform',
                  '--logdir', str(tmp_path)], den_cfg=DIT)
    _finite(metrics)
    _trained(trainer, metrics, first)
    assert trainer.transport.spec.t_sampling == 'uniform'
    assert trainer.state.step == 2


@pytest.mark.parametrize('disc_type', ['stylegan', 'vision_aided'])
def test_cvd_entry(tmp_path, disc_type, first):
    va_kw = dict(clip=CLIPVisionConfig(
        hidden_size=32, num_layers=4, num_heads=2, intermediate_size=64,
        patch_size=8, image_size=32), taps=(2, 4), head_width=8)
    trainer, metrics = vit_triplane_cvD_train.run(
        COMMON + VIEWS + ['--disc_type', disc_type,
                          '--logdir', str(tmp_path)],
        model_cfg=tasks.TOY_VAE_CFG(),
        disc_cfg=DiscriminatorConfig(img_resolution=16, base_channels=8,
                                     max_channels=16),
        va_kw=va_kw)
    _finite(metrics)
    _trained(trainer, metrics, first)
    assert 'g_adv' in metrics and trainer.state.step == 2


def test_cldm_entry(tmp_path, first, monkeypatch):
    from ln3diff_tpu_torch.models import layers
    zero_init = layers.zero_init_like_jax

    def perturbed(model):
        zero_init(model)
        g = torch.Generator().manual_seed(2)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
        return model
    monkeypatch.setattr(layers, 'zero_init_like_jax', perturbed)
    trainer, metrics = vit_triplane_cldm_train.run(
        ['--device', 'cpu', '--total_steps', '3', '--log_interval', '1',
         '--batch_size', '2', '--logdir', str(tmp_path)],
        unet_cfg=UNetConfig(**UNET))
    _finite(metrics)
    _trained(trainer, metrics, first)
    assert trainer.state.step == 3 and 'cldm_mse' in metrics
    assert not any(p.requires_grad for p in trainer.model.parameters())


def test_training_console_scripts(monkeypatch):
    text = open(os.path.join(os.path.dirname(__file__), '..',
                             'pyproject.toml')).read()
    for name, fn in (('train-vae', 'train_vae'),
                     ('train-diffusion', 'train_diffusion'),
                     ('train-sit', 'train_sit')):
        assert f'ln3diff-torch-{name} = "ln3diff_tpu_torch.cli:{fn}"' \
            in text
        monkeypatch.setattr('sys.argv', ['x', '--help'])
        with pytest.raises(SystemExit) as e:
            getattr(tcli, fn)()
        assert e.value.code == 0


def test_preemption_stops_every_rank_at_once(pool):
    out = pool.run(tasks.preempt_loop, 1, 5)
    # the poll after step 5 whose count is a multiple of 3: step 6
    assert [o['stopped'] for o in out] == [6, 6]
    assert [o['local'] for o in out] == [False, True]
    assert all(o['preempted'] for o in out)


def test_stats_sync_across_ranks(pool):
    out = pool.run(tasks.stats_sync)
    assert 'only0' in out[0]['before'] and 'only0' not in out[1]['before']
    for o in out:
        loss = o['after']['loss']
        assert loss['num'] == 4 and loss['mean'] == 1.0
        assert o['after']['only0'] == {'num': 1, 'mean': 5.0, 'std': 0.0}
