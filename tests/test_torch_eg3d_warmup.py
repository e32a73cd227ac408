"""The port's EG3D warm-up trainer against the JAX package's.

One step of ``EG3DWarmupTrainer`` in two students, f32 on both sides,
against ``jax.value_and_grad`` of JAX's ``_loss_fn`` (jitted, so that the
unread SR output drops out as in JAX's step):

* ``'tiny'``: the toy ``TriplaneVAE`` of ``tests/test_eg3d_warmup.py``
  (mono SD encoder over 32², 16² renders upsampled 16 → 32 for it), the
  toy teacher (z 16, w 16, 16² planes of 8 channels);
* ``'ffhq'``: a toy ``FFHQVAE`` (the ``FAMILIES['ffhq']`` sizes of
  ``tests/test_torch_vae_shapenet.py``: a 2-block ViT at 56², the 8XDC
  head with its ``sr_ws``) under a teacher with w 512 and 32² planes, so
  that the ws term and the 16 → 56 resize of the encoder input run.

JAX's student and teacher params (every leaf perturbed off its init) and
a random ``w_avg`` (so that ψ = 0.7 pulls toward something) are carried
by ``bridge.vae_state_dict`` and
``bridge.eg3d_generator_state_dict``; the port is fed JAX's draws:
``k_z, k_pts, k_vae = split(rng, 3)``, z from ``k_z``, the box
coordinates from ``k_pts``, and inside the VAE ``k_eps, k_render =
split(k_vae)``, ε from ``k_eps`` and the render's uniforms from
``split(k_render)``.  Tolerances: the loss within 1e-6 relative, each
term within 1e-5 relative, every grad within 1e-4 of scale (a floor of
1e-6 of the largest grad: grads that are zero in exact arithmetic hold
f32 noise on both sides), the params after the AdamW step within 1e-5 of
scale plus 1e-2·lr where the grad is resolved and 2·lr elsewhere.

One exception, shown by ``test_tiny_encoder_input_is_ill_conditioned``:
the toy SD encoder's grads (``encoder.*``, ``quant_conv.*``) in the
``'tiny'`` case are held to ``TOL_TINY_ENCODER`` = 3e-4 of scale.  Its
input, the random teacher's flat 16² render upsampled, leaves channels
of near-constant features at the first GroupNorm, and the posterior's
std (logvar up to 5) multiplies the moments' error into the latent:
against the port run in f64 on the same input, JAX's f32 moments are
2.1e-5 of scale off and the port's 0.8–1.7e-5 (by torch's thread
count), where on a random input each is under 1e-6.  The encoder's grads
of the two then differ by up to 1.8e-4 of their scale; the ``'ffhq'``
student (a ViT, no GroupNorm) holds 1e-4 everywhere.

Also: the cameras equal JAX's bit for bit; ``run_loop`` with a checkpoint
and a guard; the shared loop's ``eval_fn`` cadence in ``VAETrainer`` and
``LDMTrainer`` (the latter step for step equal to its loop before it moved
onto ``train_loop``); the teacher's ``.npz`` (a JAX-tree file loads as
JAX's ``load_numpy_checkpoint`` reads it, a torch-named one raises) and
the entry point's parser."""

import dataclasses
import functools
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.models import eg3d as jeg3d
from ln3diff_tpu.models import vae as jvae
from ln3diff_tpu.models import vae_shapenet as jvs
from ln3diff_tpu.models import vit as jvit
from ln3diff_tpu.render.renderer import RenderOptions as JOpts
from ln3diff_tpu.training import checkpoint as jckpt
from ln3diff_tpu.training import eg3d_warmup as jwarm
from ln3diff_tpu.training import train_state as jts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models import eg3d as teg3d
from ln3diff_tpu_torch.models import vae_shapenet as tvs
from ln3diff_tpu_torch.models import vit as tvit
from ln3diff_tpu_torch.models.vae import TriplaneVAEConfig
from ln3diff_tpu_torch.render.renderer import RenderDraws, RenderOptions
from ln3diff_tpu_torch.training import eg3d_warmup as twarm
from ln3diff_tpu_torch.training.checkpoint import CheckpointManager
from ln3diff_tpu_torch.training.ldm_trainer import LDMTrainConfig, LDMTrainer
from ln3diff_tpu_torch.training.vae_trainer import train_loop

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

OPTS = dict(depth_resolution=4, depth_resolution_importance=4,
            ray_start=2.25, ray_end=3.3, box_warp=1.0, white_back=False)
LR = 2e-3
WARM = dict(batch_size=2, render_resolution=16, num_shape_points=64,
            log_interval=10**6, lr=LR, ema_rate=0.5)
TOL_GRAD = 1e-4
TOL_TINY_ENCODER = 3e-4
FFHQ_KW = dict(token_size=4, decoder_embed_dim=32, decoder_fusion_depth=2,
               decoder_num_heads=2, channel_multiplier=2, plane_channels=8,
               triplane_resolution=32, decoder_output_dim=8)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float64)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _students(case):
    """(JAX config, JAX module or None, port config, port module or None,
    teacher config kwargs) of a case."""
    if case == 'tiny':
        common = dict(
            encoder_in_channels=3, encoder_ch=8, encoder_ch_mult=(1, 2),
            encoder_res_blocks=1, img_resolution=32, num_views=1,
            ldm_z_channels=4, latent_size=16, patch_size=2, conv_sr_ch=8,
            conv_sr_ch_mult=(1, 2), conv_sr_res_blocks=1, plane_channels=8,
            decoder_output_dim=8)
        dit2 = dict(tokens_per_plane=64, hidden_size=32, depth=2,
                    num_heads=2)
        jcfg = jvae.TriplaneVAEConfig(
            dit2=jdit.DiT2Config(dtype=jnp.float32, **dit2),
            dtype=jnp.float32, **common)
        tcfg = TriplaneVAEConfig(
            dit2=tdit.DiT2Config(dtype=torch.float32, **dit2),
            dtype=torch.float32, **common)
        gen = dict(z_dim=16, c_dim=25, w_dim=16, plane_resolution=16,
                   plane_channels=8, decoder_output_dim=8)
        return jcfg, None, tcfg, None, gen
    enc = dict(img_size=56, embed_dim=32, depth=2, num_heads=2)
    jcfg = jvs.FFHQVAEConfig(
        encoder_vit=jvit.vit_registry('dinov2-s/14', **enc), **FFHQ_KW)
    tcfg = tvs.FFHQVAEConfig(
        encoder_vit=tvit.vit_registry('dinov2-s/14', **enc), **FFHQ_KW)
    gen = dict(z_dim=16, c_dim=25, w_dim=512, plane_resolution=32,
               plane_channels=8, decoder_output_dim=8)
    return (jcfg, jvs.FFHQVAE(jcfg), tcfg,
            tvs.FFHQVAE(tcfg, encoder=True), gen)


@functools.lru_cache(maxsize=None)
def _jax_step(case):
    """JAX's trainer (jitted inits), its perturbed params, a random
    ``w_avg``, and one ``value_and_grad`` of ``_loss_fn`` followed by the
    AdamW step."""
    jcfg, jmodel, _, _, gen = _students(case)
    tr = jwarm.EG3DWarmupTrainer(
        jcfg, jeg3d.TriPlaneGeneratorConfig(**gen),
        jwarm.WarmupConfig(**WARM), render_opts=JOpts(**OPTS), seed=0,
        model=jmodel)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(p.shape))
        .astype(np.float32), tr.state.params)
    teacher = {'params': jax.tree_util.tree_map(
                   lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(
                       p.shape)).astype(np.float32),
                   tr.teacher_variables['params']),
               'stats': {'mapping': {'w_avg': rng.standard_normal(
                   gen['w_dim']).astype(np.float32)}}}
    cam = tr._sample_cameras(2)
    key = jax.random.PRNGKey(7)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        tr._loss_fn, has_aux=True))(params, teacher, tr.state.constants,
                                    jnp.asarray(cam), key)
    rates = (('ema', 0.5),)
    state = jts.create_train_state(
        params, jts.make_optimizer(LR, 0.01, grad_clip=0.5),
        ema_rates=rates)
    new = jax.jit(lambda s, g: s.apply_gradients(g, ema_rates=rates))(
        state, grads)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(trainer=tr, params=np_tree(params), teacher=np_tree(teacher),
                cam=cam, key=key, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=np_tree(grads), new_params=np_tree(new.params))


def _draws(key, cfg, n_gen_z, mean_shape):
    k_z, k_pts, k_vae = jax.random.split(key, 3)
    k_eps, k_render = jax.random.split(k_vae)
    k_strat, k_imp = jax.random.split(k_render)
    B, R = 2, WARM['render_resolution']**2
    half = OPTS['box_warp'] / 2
    return twarm.WarmupDraws(
        z=_t(jax.random.normal(k_z, (B, n_gen_z))),
        coords=_t(jax.random.uniform(k_pts, (B, WARM['num_shape_points'], 3),
                                     minval=-half, maxval=half)),
        eps=_t(jax.random.normal(k_eps, mean_shape)),
        render=RenderDraws(
            _t(jax.random.uniform(k_strat, (B, R, OPTS['depth_resolution'],
                                            1))),
            _t(jax.random.uniform(k_imp, (B * R, OPTS[
                'depth_resolution_importance'])))))


def _port(case):
    want = _jax_step(case)
    _, _, tcfg, tmodel, gen = _students(case)
    tr = twarm.EG3DWarmupTrainer(
        tcfg, teg3d.TriPlaneGeneratorConfig(**gen),
        twarm.WarmupConfig(**WARM), render_opts=RenderOptions(**OPTS),
        seed=0, model=tmodel, device='cpu')
    tr.model.load_state_dict(bridge.vae_state_dict(want['params']))
    tr.teacher.load_state_dict(
        bridge.eg3d_generator_state_dict(want['teacher']))
    h = tcfg.latent_size
    draws = _draws(want['key'], tcfg, gen['z_dim'],
                   (2, h, h, tcfg.ldm_z_channels, 3))
    return want, tr, torch.from_numpy(want['cam']), draws


def test_cameras_are_bit_equal():
    """From the same seed, after each trainer's construction, three
    batches of cameras equal JAX's bit for bit."""
    jtr = _jax_step('tiny')['trainer']
    jtr.rng = np.random.default_rng([5, 0])
    jtr._sample_cameras(2)
    _, _, tcfg, _, gen = _students('tiny')
    ttr = twarm.EG3DWarmupTrainer(
        tcfg, teg3d.TriPlaneGeneratorConfig(**gen),
        twarm.WarmupConfig(**WARM), render_opts=RenderOptions(**OPTS),
        seed=5, device='cpu')
    for n in (2, 3, 4):
        want = jtr._sample_cameras(n)
        got = ttr._sample_cameras(n)
        assert got.dtype == np.float32 and got.shape == (n, 25)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('case', ['tiny', 'ffhq'])
def test_warmup_step_matches_jax(case):
    """The loss, each term, every grad, then the params after AdamW."""
    want, tr, cam, draws = _port(case)
    loss, terms = tr.loss_fn(None, None, {'c': cam}, draws)
    expected = {'img', 'depth', 'shape', 'plane'} | (
        {'ws'} if case == 'ffhq' else set())
    assert set(terms) == expected
    assert set(want['metrics']) == expected | {'loss'}
    assert abs(loss.item() - want['loss']) <= 1e-6 * abs(want['loss'])
    for k, v in terms.items():
        w = want['metrics'][k]
        assert abs(v.item() - w) <= 1e-5 * abs(w), (k, v.item(), w)
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             for k, p in tr.model.named_parameters()}
    tr.model.zero_grad(set_to_none=True)
    jgrads = bridge.vae_state_dict(want['grads'])
    assert sorted(grads) == sorted(jgrads)
    gmax = max(float(g.abs().max()) for g in jgrads.values())
    assert gmax > 0
    for k, g in jgrads.items():
        tol = TOL_TINY_ENCODER if case == 'tiny' and k.startswith(
            ('encoder.', 'quant_conv.')) else TOL_GRAD
        bound = max(tol * float(g.abs().max()), 1e-6 * gmax)
        err = float((grads[k] - g).abs().max())
        assert err <= bound, (k, err, bound)
    if case == 'ffhq':
        assert float(jgrads['sr_ws'].abs().max()) > 0
    assert not any(p.grad is not None for p in tr.teacher.parameters())

    metrics = tr.train_step(cam, draws=draws)
    assert abs(metrics['loss'].item() - want['loss']) <= \
        1e-6 * abs(want['loss'])
    new = bridge.vae_state_dict(want['new_params'])
    for k, p in tr.state.params.items():
        g = jgrads[k]
        resolved = g.abs() >= 10 * max(1e-4 * float(g.abs().max()),
                                       1e-6 * gmax)
        perr = (p.detach() - new[k]).abs()
        assert float(perr.max()) <= 2 * LR + 1e-6, k
        tol = 1e-5 * float(new[k].abs().max()) + 1e-2 * LR
        assert bool((perr[resolved] <= tol).all()), k


def test_tiny_encoder_input_is_ill_conditioned():
    """Why the toy SD encoder's grads get ``TOL_TINY_ENCODER``: on the
    warm-up's encoder input (JAX's teacher render, resized as JAX resizes
    it) the f32 moments of both sides lie at least 5 times farther from
    the port's f64 moments than on a random input of the same shape
    (where both are within 2e-6 of scale), and within 3e-5 of scale."""
    import copy
    want, tr, cam, draws = _port('tiny')
    jtr = want['trainer']
    t_out = jax.jit(lambda v, z, c: jtr.gen.apply(
        v, z, c, JOpts(**OPTS), 16, jnp.zeros((2, 25)), truncation_psi=0.7,
        return_ws=True))(want['teacher'], draws.z.numpy(), want['cam'])
    render = np.array(jax.image.resize(t_out['image_raw'], (2, 32, 32, 3),
                                       'bilinear'))
    rand = np.random.default_rng(0).uniform(-1, 1, render.shape).astype(
        np.float32)
    encode = jax.jit(lambda p, x: jtr.model.apply(
        {'params': p, **jtr.state.constants}, x, method=jtr.model.encode))
    m64 = copy.deepcopy(tr.model).double()
    errs = {}
    for name, x in (('render', render), ('random', rand)):
        j32 = np.asarray(encode(want['params'], x), np.float64)
        with torch.no_grad():
            t32 = _np(tr.model.encode(torch.from_numpy(x)))
            t64 = _np(m64.encode(torch.from_numpy(x).double()))
        scale = np.abs(t64).max()
        errs[name] = (np.abs(t32 - t64).max() / scale,
                      np.abs(j32 - t64).max() / scale)
    for side in (0, 1):
        assert errs['random'][side] <= 2e-6, errs
        assert 5 * errs['random'][side] <= errs['render'][side] <= 3e-5, \
            errs


def test_run_loop_checkpoints_and_stops_at_the_guard(tmp_path):
    """``run_loop`` on the shared loop: a save every 2 steps through the
    eval hook, logs at ``log_interval``, the guard's stop after step 3;
    the checkpoint restores into another trainer equal."""
    _, _, tcfg, _, gen = _students('tiny')

    def make(seed):
        return twarm.EG3DWarmupTrainer(
            tcfg, teg3d.TriPlaneGeneratorConfig(**gen),
            twarm.WarmupConfig(**dict(WARM, log_interval=1)),
            render_opts=RenderOptions(**OPTS), seed=seed, device='cpu')

    class StopAfter:
        calls = 0

        def should_stop(self):
            self.calls += 1
            return self.calls >= 3

    tr, logs = make(0), []
    ckpt = CheckpointManager(str(tmp_path / 'ck'))
    state = tr.run_loop(num_steps=50, ckpt=ckpt, save_interval=2,
                        guard=StopAfter(), log=logs.append)
    assert state.step == 3
    assert ckpt.all_steps() == [2]
    assert [d['step'] for d in logs if 'step' in d] == [1, 2, 3]
    assert logs[-1] == {'stopped_after_step': 3}
    assert all(np.isfinite(d['loss']) for d in logs if 'loss' in d)
    ckpt.save(int(state.step), state)
    twin = make(1)
    ckpt.restore(twin.state)
    assert twin.state.step == 3
    for k, p in tr.state.params.items():
        assert torch.equal(p, twin.state.params[k]), k
        assert torch.equal(tr.state.ema_params['ema'][k],
                           twin.state.ema_params['ema'][k]), k


def test_train_loop_eval_cadence():
    """Per step: the step, the log every ``log_interval`` steps, then
    ``eval_fn(step)`` every ``eval_interval`` steps, then the guard; none
    of the hook without an interval."""
    events = []

    class Guard:
        calls = 0

        def should_stop(self):
            self.calls += 1
            return self.calls == 5

    train_loop(lambda raw, i: events.append(('step', i)) or {},
               iter(range(10)), 7, 2, 10,
               lambda m: events.append(('log', m.get('step'),
                                        m.get('stopped_after_step'))),
               Guard(),
               eval_fn=lambda step: events.append(('eval', step)),
               eval_interval=3)
    assert events == [('step', 10), ('step', 11), ('log', 12, None),
                      ('step', 12), ('eval', 13), ('step', 13),
                      ('log', 14, None), ('step', 14), ('log', None, 15)]
    evals = []
    train_loop(lambda raw, i: {}, iter(range(3)), 3, 1, 0, lambda m: None,
               eval_fn=evals.append)
    assert evals == []


def test_vae_trainer_run_loop_eval_hook():
    """``VAETrainer.run_loop`` passes ``eval_fn`` and ``eval_interval``
    through with the live train state."""
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.training.vae_trainer import (VAETrainConfig,
                                                        VAETrainer)
    cfg = TriplaneVAEConfig(
        encoder_in_channels=10, encoder_ch=8, encoder_ch_mult=(1, 2),
        encoder_res_blocks=1, img_resolution=32, num_views=2,
        ldm_z_channels=4, latent_size=16,
        dit2=tdit.DiT2Config(tokens_per_plane=64, hidden_size=32, depth=2,
                             num_heads=2, dtype=torch.float32),
        patch_size=2, conv_sr_ch=8, conv_sr_ch_mult=(1, 2),
        conv_sr_res_blocks=1, plane_channels=8, decoder_output_dim=8,
        dtype=torch.float32)
    tr = VAETrainer(cfg, VAETrainConfig(patch_resolution=8,
                                        render_resolution=16,
                                        log_interval=10**6),
                    render_opts=RenderOptions(
                        depth_resolution=4, depth_resolution_importance=4,
                        box_warp=0.9), device='cpu')
    raw = make_multiview_batch(2, 32, 16, seed=0)
    evals = []
    tr.run_loop(iter([raw] * 4), num_steps=4, eval_interval=2,
                eval_fn=lambda s, step: evals.append((s.step, step)))
    assert evals == [(2, 2), (4, 4)]


DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
           depth=2, num_heads=2, variant='text', context_dim=16)


def _ldm_batches(n, lead):
    rng = np.random.default_rng(0)
    return [{'latent': rng.standard_normal(lead + (8, 8, 12)).astype(
                 np.float32),
             'context': {'crossattn': rng.standard_normal(
                 lead + (7, 16)).astype(np.float32)}} for _ in range(n)]


def test_ldm_run_loop_is_unchanged():
    """``LDMTrainer.run_loop`` on the shared loop equals, bit for bit,
    the steps of its former loop body replayed by hand: the batch to the
    device, t and its weights from the loss-aware resampler, the step,
    the per-sample losses back to the resampler."""
    cfg = LDMTrainConfig(
        objective='ddpm', diffusion_steps=100, triplane_scaling_divider=1.0,
        schedule_sampler='loss-second-moment', log_interval=2)

    def make():
        return LDMTrainer(tdit.DiT_TriLatent(tdit.DiTConfig(
            learn_sigma=False, dtype=torch.float32, **DIT)), cfg,
            device='cpu')

    batches = _ldm_batches(3, (2,))
    a, logs = make(), []
    a.run_loop(iter(batches), num_steps=3, log=logs.append)
    b = make()
    b.build()
    for raw in batches:
        batch = {'latent': torch.as_tensor(raw['latent']),
                 'context': {'crossattn': torch.as_tensor(
                     raw['context']['crossattn'])}}
        t_np, w_np = b.resampler.sample(b._resampler_rng, 2)
        batch['t'] = torch.as_tensor(t_np)
        batch['t_weights'] = torch.as_tensor(w_np)
        m = b.train_step(batch)
        b.resampler.update_with_losses(
            t_np, m.pop('per_sample_loss').numpy())
    assert [d['step'] for d in logs] == [2]
    assert 'per_sample_loss' not in logs[0]
    np.testing.assert_array_equal(a.resampler._loss_history,
                                  b.resampler._loss_history)
    for k, p in a.state.params.items():
        assert torch.equal(p, b.state.params[k]), k


def _teacher_npz(tmp_path):
    """JAX's teacher params written with the JAX package's
    ``save_numpy_checkpoint`` (slash-joined names, ``np.savez``)."""
    want = _jax_step('tiny')
    path = str(tmp_path / 'teacher.npz')
    jckpt.save_numpy_checkpoint(path, want['teacher']['params'])
    return want, path


def test_teacher_npz_loads_as_jax_reads_it(tmp_path):
    want, path = _teacher_npz(tmp_path)
    jtr = want['trainer']
    loaded = jckpt.load_numpy_checkpoint(path, jtr.teacher_params)
    _, _, tcfg, _, gen = _students('tiny')
    ttr = twarm.EG3DWarmupTrainer(
        tcfg, teg3d.TriPlaneGeneratorConfig(**gen),
        twarm.WarmupConfig(**WARM), render_opts=RenderOptions(**OPTS),
        seed=3, device='cpu')
    w_avg = ttr.teacher.mapping.w_avg.clone()
    ttr.load_teacher_npz(path)
    sd = bridge.eg3d_generator_state_dict(
        {'params': jax.tree_util.tree_map(np.asarray, loaded)})
    got = ttr.teacher.state_dict()
    assert sorted(sd) == sorted(k for k in got if k != 'mapping.w_avg')
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(got['mapping.w_avg'], w_avg)


def test_teacher_npz_torch_names_raise(tmp_path):
    """A torch-named dict is not a JAX tree: ``load_teacher_npz`` raises,
    naming the key (``main`` sends such a file to
    ``load_teacher_state_dict``, ``test_torch_entry_points.py``)."""
    path = str(tmp_path / 'legacy.npz')
    np.savez(path, **{'G_ema.backbone.mapping.w_avg':
                      np.zeros(16, np.float32)})
    _, _, tcfg, _, gen = _students('tiny')
    ttr = twarm.EG3DWarmupTrainer(
        tcfg, teg3d.TriPlaneGeneratorConfig(**gen),
        twarm.WarmupConfig(**WARM), render_opts=RenderOptions(**OPTS),
        device='cpu')
    with pytest.raises(KeyError, match='G_ema.backbone.mapping.w_avg'):
        ttr.load_teacher_npz(path)


def test_entry_point_parser_matches_the_script():
    """``main``'s parser has the JAX entry point's options and defaults
    (the output directory under the temporary directory, and the port's
    ``--device``)."""
    spec = importlib.util.spec_from_file_location(
        'warmup_script', os.path.join(os.path.dirname(__file__), '..',
                                      'scripts',
                                      'vit_triplane_eg3d_warmup.py'))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    want = vars(script.build_parser().parse_args([]))
    got = vars(twarm.build_parser().parse_args([]))
    assert got.pop('device') == 'cuda'
    assert os.path.basename(got.pop('outdir')) == os.path.basename(
        want.pop('outdir'))
    assert got == want
    fields = {f.name: f.default for f in dataclasses.fields(
        twarm.WarmupConfig)}
    assert fields == {f.name: f.default for f in dataclasses.fields(
        jwarm.WarmupConfig)}
