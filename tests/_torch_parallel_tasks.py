"""Tasks that the gloo ranks of ``tests/_torch_ranks.py`` run for the
port's multi-rank tests, and that ``scripts/parallel_card_check.py`` runs
on CUDA ranks under NCCL (``device='cuda'``; ``mesh_kw=None``: the same
work without a mesh, the one-rank reference).  Torch and the port only:
no JAX.  Inputs and outputs are numpy arrays, numbers and containers of
them."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ln3diff_tpu_torch.parallel import mesh as pmesh


def _t(tree, device='cpu'):
    return pmesh.tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(
        device) if isinstance(a, np.ndarray) else a, tree)


def _mesh(mesh_kw, device):
    """The mesh of ``mesh_kw`` over the world, or none (``None``)."""
    if mesh_kw is None:
        return pmesh.LocalMesh(torch.device(device).type)
    return pmesh.make_mesh(pmesh.MeshConfig(**mesh_kw))


def _np(tree):
    return pmesh.tree_map(lambda a: a.detach().cpu().numpy()
                          if torch.is_tensor(a) else a, tree)


def rank_info():
    mesh = pmesh.make_mesh(pmesh.MeshConfig(data=2, fsdp=2))
    return dict(rank=dist.get_rank(), world=dist.get_world_size(),
                coord=list(mesh.get_coordinate()),
                dp=pmesh.axis_index(mesh, 'data', 'fsdp'))


# ---------------------------------------------------------------------------
# the generic step (build_train_step) on a tiny DiT
# ---------------------------------------------------------------------------

def _tiny_dit(cfg_kw, sd, device='cpu'):
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
    model = DiT_TriLatent(DiTConfig(**cfg_kw, dtype=torch.float32))
    model.load_state_dict(_t(sd), strict=False)
    return model.to(device)


def dit_train_step(cfg_kw, sd, batch, mesh_kw, rules=None, min_size=0,
                   lr=1e-3, microbatch_steps=1, device='cpu'):
    """One ``build_train_step`` step of the MSE loss ``mean((model(x, 1,
    ctx) − x)²)`` on a mesh: the loss, the whole params after the step
    (``TrainState.payload``), the local and whole sizes of every sharded
    state tensor, the module's parameter numels, the bytes of the module's
    parameters and the bytes the rank holds in all (module parameters,
    the grads the optimizer was given, moments and EMA, each storage
    once), and, from a forward pre-hook on every module, the most units
    with whole sharded parameters alive at once (and after the step)."""
    from ln3diff_tpu_torch.training import train_state as ts
    mesh = _mesh(mesh_kw, device)
    model = _tiny_dit(cfg_kw, sd, device)
    placements = None
    if rules == 'fsdp':
        placements = pmesh.param_sharding_rules(model, mesh, min_size)
    elif rules == 'tensor':
        placements = pmesh.tensor_parallel_rules(model, mesh, min_size)
    state = ts.TrainState.create(model, ts.make_optimizer(lr),
                                 ema_rates=(('ema', 0.5),), mesh=mesh,
                                 placements=placements)
    units = [0]
    if state.sharded is not None:
        for m in model.modules():
            m.register_forward_pre_hook(lambda m, a: units.__setitem__(
                0, max(units[0], state.sharded.units_whole())))
    grads_seen = {}
    apply = state.apply_gradients

    def capture(grads, g_norm=None):
        grads_seen.update(grads)
        return apply(grads, g_norm)

    state.apply_gradients = capture

    def loss_fn(params, consts, b, d):
        x = b['x']
        out = model(x, torch.ones(x.shape[0], device=x.device),
                    {'crossattn': b['ctx']})
        loss = torch.mean((out - x)**2)
        terms = {'mse': loss.detach()}
        if 'step' in b:
            loss = loss * (b['step'] * 0 + 1)
            terms['step'] = torch.as_tensor(b['step'], device=x.device)
        return loss, terms

    step = ts.build_train_step(loss_fn, microbatch_steps, mesh=mesh)
    metrics = step(state, _t(batch, device))
    after = state.sharded.units_whole() if state.sharded is not None else 0
    payload = state.payload()
    sizes = {}
    for k, v in state.params.items():
        if ts._is_dtensor(v):
            sizes[k] = dict(
                param=(v.to_local().numel(), v.numel()),
                mu=(state.opt_state['mu'][k].to_local().numel(),),
                nu=(state.opt_state['nu'][k].to_local().numel(),),
                ema=(state.ema_params['ema'][k].to_local().numel(),))
    held = {}
    for t in (list(model.parameters()) + list(state.params.values())
              + list(grads_seen.values())
              + list(state.opt_state['mu'].values())
              + list(state.opt_state['nu'].values())
              + list(state.ema_params['ema'].values())):
        st = (t.to_local() if ts._is_dtensor(t) else t).untyped_storage()
        held[st.data_ptr()] = st.nbytes()
    return dict(loss=float(metrics['loss']), mse=float(metrics['mse']),
                step=float(metrics.get('step', np.nan)),
                grad_norm=float(metrics['grad_norm']),
                params=_np(payload['params']), sizes=sizes,
                numels={k: p.numel() for k, p in model.named_parameters()},
                module_bytes=sum(p.nbytes for p in model.parameters()),
                held_bytes=sum(held.values()), units_whole=units[0],
                units_whole_after=after)


def batch_roundtrip(rows=8):
    """``data_sharding`` and ``replicated`` over a (2, 1, 2, 1) mesh, and
    the rank's host draws."""
    mesh = pmesh.make_mesh(pmesh.MeshConfig(data=2, fsdp=2))
    tree = {'a': torch.arange(2 * rows).reshape(rows, 2), 'step': 7.0}
    local = pmesh.data_sharding(mesh, tree)
    micro = pmesh.data_sharding(mesh, {'a': torch.arange(8).reshape(2, 4)},
                                axis=1)
    return dict(local=local['a'].numpy(), step=local['step'],
                micro_local=micro['a'].numpy(),
                gathered=pmesh.replicated(mesh, local)['a'].numpy(),
                coord=list(mesh.get_coordinate()),
                host_draw=pmesh.host_rng(5).integers(0, 99, 4))


# ---------------------------------------------------------------------------
# the GPipe schedule and the pipelined trainer
# ---------------------------------------------------------------------------

def pipeline_forward_grads(cfg_kw, sd, x, t, ctx, cot, mesh_kw, n_micro,
                           remat=False, device='cpu'):
    """``dit_pipeline_apply`` on a mesh: the output and the grads of
    ``Σ out · cot`` of every parameter that got one on this rank (its
    stage's blocks, the embed and the head)."""
    from ln3diff_tpu_torch.parallel.pipeline import dit_pipeline_apply
    mesh = _mesh(mesh_kw, device)
    model = _tiny_dit(cfg_kw, sd, device)
    x, t, ctx, cot = _t((x, t, ctx, cot), device)
    out = dit_pipeline_apply(model, x, t, {'crossattn': ctx}, mesh=mesh,
                             n_micro=n_micro, remat=remat)
    (out * cot).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    return _np(dict(out=out.detach(), grads=grads))


def ldm_step(cfg_kw, sd, batch, draws, mesh_kw, pp_microbatches,
             device='cpu'):
    """One flow-matching ``LDMTrainer`` step on a mesh with explicit global
    draws: the loss and the whole params after the step."""
    from ln3diff_tpu_torch.training.ldm_trainer import (LDMDraws,
                                                        LDMTrainConfig,
                                                        LDMTrainer)
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
    mesh = _mesh(mesh_kw, device)
    trainer = LDMTrainer(
        DiT_TriLatent(DiTConfig(**cfg_kw, dtype=torch.float32)),
        LDMTrainConfig(objective='flow_matching', lr=1e-3,
                       pp_microbatches=pp_microbatches, log_interval=10**9),
        device=device, mesh=mesh)
    trainer.model.load_state_dict(_t(sd), strict=False)
    trainer.build()
    m = trainer.train_step(_t(batch, device),
                           LDMDraws(*_t(draws, device)))
    payload = trainer.state.payload()
    return dict(loss=float(m['loss']), grad_norm=float(m['grad_norm']),
                params=_np(payload['params']),
                held=sorted(trainer.state.params),
                on_device=_blocks_on_device(trainer.model))


def _blocks_on_device(model) -> list:
    """The trunk blocks with a parameter or buffer off the meta device."""
    return sorted(i for i, b in enumerate(model.blocks)
                  if any(not t.is_meta for t in (*b.parameters(),
                                                  *b.buffers())))


# ---------------------------------------------------------------------------
# sharded serving
# ---------------------------------------------------------------------------

def shard_functions(n_points, chunk):
    """``shard_orbit_render`` and ``shard_points_query`` over the data
    ranks against the direct calls, on toy per-frame and per-point
    functions; and the orbit's refusal of an indivisible frame count."""
    from ln3diff_tpu_torch.parallel.serving import (shard_orbit_render,
                                                    shard_points_query)
    mesh = pmesh.make_mesh()
    g = torch.Generator().manual_seed(0)
    planes = torch.randn(1, 3, 4, 4, 2, generator=g)
    w = torch.randn(2, 3, generator=g)

    def render_fn(planes_f, cams):
        feat = (planes_f.mean(dim=(1, 2, 3)) @ w)[:, :2] * cams[:, :1]
        return feat[:, None, None, :].expand(-1, 5, 5, -1)

    def point_fn(planes, coords):
        h = torch.tanh(coords @ w.T + planes.mean())
        return h, h.sum(-1, keepdim=True)

    cams = torch.randn(8, 25, generator=g)
    coords = torch.rand(1, n_points, 3, generator=g) - 0.5
    orbit = shard_orbit_render(render_fn, mesh)(planes, cams)
    rgb, sigma = shard_points_query(point_fn, mesh, chunk=chunk)(planes,
                                                                 coords)
    try:
        shard_orbit_render(render_fn, mesh)(planes, cams[:6])
        refused = False
    except ValueError as e:
        refused = 'divisible' in str(e)
    ref_rgb, ref_sigma = point_fn(planes, coords)
    return dict(orbit=_np(orbit),
                orbit_ref=_np(render_fn(planes.repeat(8, 1, 1, 1, 1), cams)),
                rgb=_np(rgb), sigma=_np(sigma), rgb_ref=_np(ref_rgb),
                sigma_ref=_np(ref_sigma), refused=refused)


TOY_T23D = dict(
    den=dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
             depth=2, num_heads=2, context_dim=32, exact_gelu=False),
    d2=dict(tokens_per_plane=16, hidden_size=32, depth=2, num_heads=2),
    vae=dict(ldm_z_channels=4, latent_size=8, patch_size=2, conv_sr_ch=8,
             conv_sr_ch_mult=(1, 2), conv_sr_res_blocks=1, plane_channels=8,
             decoder_output_dim=8),
    text=dict(hidden_size=32, num_layers=1, num_heads=2,
              intermediate_size=64),
    opts=dict(depth_resolution=6, depth_resolution_importance=6,
              ray_start='auto', ray_end='auto', box_warp=0.9,
              filter_out_of_bbox=True, sampler_bbox_min=-0.45,
              sampler_bbox_max=0.45))


def serving_call(tmpdir, num_frames, grid, flat=False, device='cpu'):
    """The toy text→3D ``__call__`` with ``serving_mesh`` (the data ranks)
    and without, from the same seed and start noise: the latents, the
    frames and the σ grid of both; with ``flat`` both render through the
    flat-ray renderer (``TriplaneVAE.render_rays_flat``).  On a card the
    VAE keeps kernel 1's 32 plane and colour channels."""
    from ln3diff_tpu_torch.conditioning.clip import CLIPTextConfig
    from ln3diff_tpu_torch.models.dit import DiT2Config, DiTConfig
    from ln3diff_tpu_torch.models.vae import TriplaneVAEConfig
    from ln3diff_tpu_torch.pipeline import SamplerSpec, build_t23d_pipeline
    from ln3diff_tpu_torch.render.renderer import RenderOptions
    c = TOY_T23D
    vae_kw = dict(c['vae'])
    if torch.device(device).type == 'cuda':
        vae_kw.update(plane_channels=32, decoder_output_dim=32)
    kw = dict(device=device, seed=0,
              den_cfg=DiTConfig(dtype=torch.float32, **c['den']),
              vae_cfg=TriplaneVAEConfig(
                  dit2=DiT2Config(dtype=torch.float32, **c['d2']),
                  dtype=torch.float32, **vae_kw),
              text_cfg=CLIPTextConfig(**c['text']),
              render_opts=RenderOptions(**c['opts']), render_resolution=8,
              sampler=SamplerSpec(kind='ddim', num_steps=2,
                                  latent_shape=(8, 8, 12)),
              render_dtype=None)
    mesh = pmesh.make_mesh()
    x_init = torch.randn(1, 8, 8, 12, generator=torch.Generator()
                         .manual_seed(3)).to(device)
    out = {}
    rank = dist.get_rank()
    for name, m in (('sharded', mesh), ('plain', None)):
        pipe, _, mods = build_t23d_pipeline(serving_mesh=m, **kw)
        if flat:
            vae, opts = mods['vae'], kw['render_opts']
            pipe.render_rays_fn = lambda planes, o, d: vae.render_rays_flat(
                planes, o, d, opts, use_fused_osg=True)
        # a fixed context, not the tokenizer: its hash fallback (no BPE
        # merges file) is salted per process, so ranks would disagree
        g = torch.Generator().manual_seed(4)
        cond = {'crossattn': torch.randn(1, 77, 32, generator=g).to(device)}
        uncond = {'crossattn': torch.zeros(1, 77, 32, device=device)}
        sigma = pipe.dispatch_mesh_sigma(
            pipe.decode_fn(x_init * pipe.spec.triplane_scaling_divider),
            grid, smooth=True)
        res = pipe(cond, uncond, num_frames=num_frames, x_init=x_init,
                   mesh_path=f'{tmpdir}/{name}_{rank}.obj', mesh_grid=grid,
                   render_resolution=8)
        out[name] = dict(latents=_np(res['latents']),
                         video=_np(res['video']), sigma=_np(sigma.float()),
                         verts=res['mesh'][0])
    return out


def tp_sampling(min_size, device='cpu'):
    """DDIM sampling with CFG through a toy DiT split over the tensor
    ranks (``tp_shard_denoiser_params``) and through the whole one: the
    two latents, and which of the first block's layers were split."""
    from ln3diff_tpu_torch.diffusion.gaussian import make_diffusion
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.parallel.serving import (ColumnParallelLinear,
                                                    RowParallelLinear,
                                                    tp_shard_denoiser_params)
    from ln3diff_tpu_torch.pipeline import SamplerSpec, TextTo3DPipeline
    mesh = pmesh.make_mesh(pmesh.MeshConfig(tensor=dist.get_world_size()))
    cfg = DiTConfig(input_size=8, patch_size=2, in_channels=4,
                    hidden_size=64, depth=2, num_heads=4, variant='text',
                    context_dim=16, dtype=torch.float32)
    model = DiT_TriLatent(cfg)
    random_init_(model, torch.Generator().manual_seed(0))
    model.to(device)
    cond = {'crossattn': torch.ones(1, 7, 16, device=device)}
    uncond = {'crossattn': torch.zeros(1, 7, 16, device=device)}
    x_init = torch.randn(2, 8, 8, 12, generator=torch.Generator()
                         .manual_seed(1)).to(device)

    def sample():
        pipe = TextTo3DPipeline(
            lambda x, t, c: model(x, t, c), None, None, None,
            sampler=SamplerSpec(kind='ddim', num_steps=4, cfg_scale=2.0,
                                latent_shape=(8, 8, 12)),
            diffusion=make_diffusion(steps=100, timestep_respacing='4'),
            device=device)
        return pipe.sample_latents(2, cond, uncond, x_init=x_init)

    ref = sample()
    tp_shard_denoiser_params(model, mesh, min_size_to_shard=min_size)
    got = sample()
    blk = model.blocks[0]
    kinds = {n: type(m).__name__ for n, m in blk.named_modules()
             if isinstance(m, (ColumnParallelLinear, RowParallelLinear))}
    return dict(ref=_np(ref), got=_np(got), kinds=kinds,
                heads=blk.attn.num_heads)


# ---------------------------------------------------------------------------
# entry points, preemption and statistics across ranks
# ---------------------------------------------------------------------------

def TOY_VAE_CFG():
    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.vae import TriplaneVAEConfig
    return TriplaneVAEConfig(
        encoder_in_channels=10, encoder_ch=8, encoder_ch_mult=(1, 2),
        encoder_res_blocks=1, img_resolution=32, num_views=2,
        ldm_z_channels=4, latent_size=16,
        dit2=DiT2Config(tokens_per_plane=64, hidden_size=32, depth=2,
                        num_heads=2, dtype=torch.float32),
        patch_size=2, conv_sr_ch=8, conv_sr_ch_mult=(1, 2),
        conv_sr_res_blocks=1, plane_channels=8, decoder_output_dim=8,
        dtype=torch.float32)


def vae_entry(argv):
    """``vit_triplane_train`` in process on this rank's share: the last
    metrics, the grads of the first step (averaged over the ranks) and the
    whole params."""
    from ln3diff_tpu_torch.scripts import vit_triplane_train
    from ln3diff_tpu_torch.training.train_state import TrainState
    first = {}
    apply = TrainState.apply_gradients

    def record(self, grads, g_norm=None):
        if not first:
            first.update(_np(grads))
        return apply(self, grads, g_norm)

    TrainState.apply_gradients = record
    try:
        trainer, metrics = vit_triplane_train.run(argv,
                                                  model_cfg=TOY_VAE_CFG())
    finally:
        TrainState.apply_gradients = apply
    return dict(metrics=metrics, step=trainer.state.step, grads=first,
                params=_np(trainer.state.payload()['params']))


def preempt_loop(signal_rank, signal_at, steps=40, check_interval=3):
    """A loop polling ``PreemptionGuard`` once per step; rank
    ``signal_rank`` sends itself SIGTERM after step ``signal_at``.
    Returns the step each rank stopped after, and its flags."""
    import os
    import signal

    from ln3diff_tpu_torch.training.preemption import PreemptionGuard
    stopped = None
    with PreemptionGuard(check_interval=check_interval) as guard:
        for step in range(1, steps + 1):
            if dist.get_rank() == signal_rank and step == signal_at:
                os.kill(os.getpid(), signal.SIGTERM)
            if guard.should_stop():
                stopped = step
                break
        local, agreed = guard.local_signal, guard.preempted
    return dict(stopped=stopped, local=local, preempted=agreed)


def stats_sync():
    """``StatsCollector`` moments summed over the ranks; ``report0`` on
    rank 0 only."""
    from ln3diff_tpu_torch.utils.training_stats import StatsCollector
    c = StatsCollector()
    r = dist.get_rank()
    c.report('loss', [float(r), float(r) + 1])
    c.report0('only0', [5.0])
    before = c.as_dict()
    c.sync()
    return dict(before=before, after=c.as_dict())


def checkpoint_roundtrip(directory, cfg_kw, sd, batch, draws, mesh_kw,
                         fsdp=False, device='cpu'):
    """A flow-matching ``LDMTrainer`` step on a mesh (with ``fsdp`` its
    state sharded by ``param_sharding_rules``; on a pipe axis each stage
    holds its blocks), saved with ``CheckpointManager`` (rank 0 writes the
    gathered state) and restored into a second trainer drawn from another
    seed: whether every held tensor — a rank's shard of a sharded one —
    and every module parameter came back equal, and the saved params."""
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
    from ln3diff_tpu_torch.training import train_state as ts
    from ln3diff_tpu_torch.training.checkpoint import CheckpointManager
    from ln3diff_tpu_torch.training.ldm_trainer import (LDMDraws,
                                                        LDMTrainConfig,
                                                        LDMTrainer)
    mesh = pmesh.make_mesh(pmesh.MeshConfig(**mesh_kw))

    def trainer(seed, weights=None):
        tr = LDMTrainer(DiT_TriLatent(DiTConfig(**cfg_kw,
                                                dtype=torch.float32)),
                        LDMTrainConfig(objective='flow_matching', lr=1e-3,
                                       pp_microbatches=2),
                        seed=seed, device=device, mesh=mesh)
        if weights is not None:
            tr.model.load_state_dict(_t(weights), strict=False)
        if fsdp:
            tr.state = ts.TrainState.create(
                tr.model, ts.make_optimizer(tr.cfg.lr, tr.cfg.weight_decay,
                                            grad_clip=tr.cfg.grad_clip),
                ema_rates=(('ema', tr.cfg.ema_rate),), mesh=mesh,
                placements=pmesh.param_sharding_rules(tr.model, mesh, 1024))
        return tr.build()

    a = trainer(0, sd)
    a.train_step(_t(batch, device), LDMDraws(*_t(draws, device)))
    ckpt = CheckpointManager(directory)
    ckpt.save(a.state.step, a.state)
    b = trainer(5)
    ckpt.restore(b.state)

    def same(x, y):
        x, y = (v.to_local() if ts._is_dtensor(v) else v for v in (x, y))
        return bool(torch.equal(x, y))

    return dict(
        held=all(same(b.state.params[k], v)
                 for k, v in a.state.params.items()),
        moments=all(same(b.state.opt_state[m][k], v) for m in ('mu', 'nu')
                    for k, v in a.state.opt_state[m].items()),
        ema=all(same(b.state.ema_params['ema'][k], v)
                for k, v in a.state.ema_params['ema'].items()),
        modules=all(torch.equal(p, b.state.module_params()[k])
                    for k, p in a.state.module_params().items()),
        step=b.state.step, count=b.state.opt_state['count'],
        sharded=sum(ts._is_dtensor(v) for v in a.state.params.values()),
        absent=len(a.state.absent),
        saved=_np(torch.load(f'{directory}/1/state.pt',
                             weights_only=True)['params']))


def _ldm_trainer(cfg_kw, sd, mesh, seed, device, fsdp):
    """A flow-matching ``LDMTrainer`` on ``mesh``, with ``sd`` loaded and,
    with ``fsdp``, its state sharded by ``param_sharding_rules`` at a toy
    threshold (1024 elements)."""
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
    from ln3diff_tpu_torch.training import train_state as ts
    from ln3diff_tpu_torch.training.ldm_trainer import (LDMTrainConfig,
                                                        LDMTrainer)
    tr = LDMTrainer(DiT_TriLatent(DiTConfig(**cfg_kw, dtype=torch.float32)),
                    LDMTrainConfig(objective='flow_matching', lr=1e-3,
                                   pp_microbatches=2),
                    seed=seed, device=device, mesh=mesh)
    if sd is not None:
        tr.model.load_state_dict(_t(sd), strict=False)
    if fsdp:
        tr.state = ts.TrainState.create(
            tr.model, ts.make_optimizer(tr.cfg.lr, tr.cfg.weight_decay,
                                        grad_clip=tr.cfg.grad_clip),
            ema_rates=(('ema', tr.cfg.ema_rate),), mesh=mesh,
            placements=pmesh.param_sharding_rules(tr.model, mesh, 1024))
    return tr.build()


def _payload_np(state) -> dict:
    p = state.payload()
    return _np(dict(params=p['params'], ema=p['ema']['ema'],
                    mu=p['opt']['mu'], nu=p['opt']['nu'],
                    count=p['opt']['count'], step=p['step']))


def checkpoint_layout(directory, cfg_kw, sd, batch, draws, mesh_kw, fsdp,
                      restore_from=None, device='cpu'):
    """A checkpoint across layouts: without ``restore_from``, one
    flow-matching step on ``mesh_kw`` saved under ``directory`` (rank 0
    writes the gathered state); with it, a trainer from another seed on
    ``mesh_kw`` restored from ``restore_from`` (then saved under
    ``directory`` when given).  Returns the whole state
    (``TrainState.payload``: params, EMA, moments, counts) and whether
    the module's trained parameters are the restored ones."""
    from ln3diff_tpu_torch.training.checkpoint import CheckpointManager
    from ln3diff_tpu_torch.training.ldm_trainer import LDMDraws
    mesh = pmesh.make_mesh(pmesh.MeshConfig(**mesh_kw))
    if restore_from is None:
        tr = _ldm_trainer(cfg_kw, sd, mesh, 0, device, fsdp)
        tr.train_step(_t(batch, device), LDMDraws(*_t(draws, device)))
        CheckpointManager(directory).save(tr.state.step, tr.state)
    else:
        tr = _ldm_trainer(cfg_kw, None, mesh, 5, device, fsdp)
        CheckpointManager(restore_from).restore(tr.state)
        if directory is not None:
            CheckpointManager(directory).save(tr.state.step, tr.state)
    out = _payload_np(tr.state)
    named = dict(tr.model.named_parameters())
    out['module_is_state'] = all(
        torch.equal(named[k], v.to_local() if hasattr(v, 'to_local') else v)
        for k, v in tr.state.params.items())
    out['sharded'] = tr.state.sharded is not None
    out['absent'] = len(tr.state.absent)
    return out


def fsdp_module_checks(mesh_kw):
    """A two-layer MLP sharded in the module by the FSDP rules (threshold
    1024) against its unsharded twin: the output under ``no_grad``, the
    input's grad through ``frozen_apply`` (no parameter grad), the
    module's shard shapes, ``load_module`` of whole tensors and a second
    ``TrainState.create`` (it must raise)."""
    from ln3diff_tpu_torch.training import train_state as ts
    torch.manual_seed(0)
    plain = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.GELU(),
                                torch.nn.Linear(64, 32))
    model = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.GELU(),
                                torch.nn.Linear(64, 32))
    model.load_state_dict(plain.state_dict())
    mesh = pmesh.make_mesh(pmesh.MeshConfig(**mesh_kw))
    rules = pmesh.param_sharding_rules(model, mesh, 1024)
    state = ts.TrainState.create(model, ts.make_optimizer(1e-3), mesh=mesh,
                                 placements=rules)
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        same_out = bool(torch.equal(model(x), plain(x)))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ts.frozen_apply(model, xa).square().sum().backward()
    ts.frozen_apply(plain, xb).square().sum().backward()
    grads_in = float((xa.grad - xb.grad).abs().max())
    no_param_grads = all(p.grad is None for p in model.parameters())
    whole = {k: torch.full_like(v, 3.0) for k, v in plain.state_dict().items()}
    state.load_module(whole)
    with torch.no_grad():
        loaded = bool(torch.equal(model(x), torch.func.functional_call(
            plain, whole, (x,))))
    try:
        ts.TrainState.create(model, ts.make_optimizer(1e-3), mesh=mesh,
                             placements=rules)
        twice = 'no error'
    except ValueError as e:
        twice = str(e)
    return dict(sharded=sorted(state.sharded.dims),
                shapes={k: tuple(p.shape) for k, p in
                        model.named_parameters()},
                same_out=same_out, grads_in=grads_in,
                no_param_grads=no_param_grads, loaded=loaded, twice=twice)
