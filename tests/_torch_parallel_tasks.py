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


# ---------------------------------------------------------------------------
# tensor-parallel int8 layers and convs
# ---------------------------------------------------------------------------

def _tensor_mesh():
    return pmesh.make_mesh(pmesh.MeshConfig(tensor=dist.get_world_size()))


def _int8_layer(cls, fan_in, fan_out, g, **kw):
    """An int8 layer whose kernel is quantized from a N(0, 1/fan_in) draw
    and whose bias is N(0, 0.1²)."""
    layer = cls(fan_in, fan_out, **kw)
    layer.load_weight(torch.randn(layer.kernel_q.shape, generator=g)
                      / fan_in ** 0.5)
    layer.bias.copy_(0.1 * torch.randn(fan_out, generator=g))
    return layer


def _split_run(mesh, layers, x):
    """``layers`` applied in turn to ``x``, whole and split over the tensor
    ranks (a ``Sequential`` through ``tp_shard_denoiser_params`` with every
    size sharded: the pairs of an ``fc1``/``fc2`` owner split together)."""
    from ln3diff_tpu_torch.parallel.serving import tp_shard_denoiser_params
    model = torch.nn.Sequential(*layers)
    with torch.no_grad():
        want = model(x)
        tp_shard_denoiser_params(model, mesh, min_size_to_shard=0)
        got = model(x)
    return got, want, [type(m).__name__ for m in model]


class _Pair(torch.nn.Module):
    """``fc2(gelu(fc1(x)))``: the executor's fc1/fc2 pair."""

    def __init__(self, fc1, fc2):
        super().__init__()
        self.fc1, self.fc2 = fc1, fc2

    def forward(self, x):
        return self.fc2(torch.nn.functional.gelu(self.fc1(x)))


class _Named(torch.nn.Module):
    """One layer under a marker name (``qkv``: column, ``proj``: row),
    unpaired."""

    def __init__(self, name, layer):
        super().__init__()
        self.name = name
        self.add_module(name, layer)

    def forward(self, x):
        return getattr(self, self.name)(x)


def tp_int8_layers(device='cpu'):
    """Each split layer of ``parallel/serving.py`` over the tensor ranks
    against the whole layer on the same input: ``Int8Linear`` column
    (gathered), row with a whole input (scattered), and row paired after a
    column layer (the per-token amax MAX-reduced); the 1x1 ``Int8Conv``
    column, row and paired; the float 1x1 conv column and row, on random
    data and on integer-valued data (every f32 product and sum exact, so
    the summation order cannot move a bit).  Each case → (got, want, the
    split types)."""
    import torch.nn as nn
    from ln3diff_tpu_torch.ops.int8 import Int8Conv, Int8Linear
    mesh = _tensor_mesh()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 48, generator=g)
    xc = torch.randn(2, 48, 3, 4, generator=g).contiguous(
        memory_format=torch.channels_last)
    lin = lambda i, o: _int8_layer(Int8Linear, i, o, g)     # noqa: E731
    conv = lambda i, o: _int8_layer(Int8Conv, i, o, g,      # noqa: E731
                                    kernel_size=1)
    out = {}
    for name, layers, inp in (
            ('int8_linear_column', [_Named('qkv', lin(48, 64))], x),
            ('int8_linear_row', [_Named('proj', lin(48, 32))], x),
            ('int8_linear_paired', [_Pair(lin(48, 64), lin(64, 40))], x),
            ('int8_conv_column', [_Named('qkv', conv(48, 32))], xc),
            ('int8_conv_row', [_Named('proj', conv(48, 40))], xc),
            ('int8_conv_paired', [_Pair(conv(48, 64), conv(64, 24))], xc)):
        got, want, kinds = _split_run(mesh, [m.to(device) for m in layers],
                                      inp.to(device))
        out[name] = dict(got=_np(got), want=_np(want),
                         kinds=[type(m).__name__ for layer in layers
                                for m in layer.children()] or kinds)
    for exact in (False, True):
        for name, marker, fan_out in (('conv_column', 'qkv', 32),
                                      ('conv_row', 'proj', 40)):
            c = nn.Conv2d(48, fan_out, 1)
            with torch.no_grad():
                if exact:
                    c.weight.copy_(torch.randint(-4, 5, c.weight.shape,
                                                 generator=g))
                    c.bias.copy_(torch.randint(-4, 5, c.bias.shape,
                                               generator=g))
                else:
                    c.weight.copy_(torch.randn(c.weight.shape, generator=g)
                                   / 48 ** 0.5)
                    c.bias.copy_(0.1 * torch.randn(fan_out, generator=g))
            inp = (torch.randint(-4, 5, xc.shape, generator=g).float()
                   if exact else xc)
            layer = _Named(marker, c.to(memory_format=torch.channels_last))
            got, want, _ = _split_run(mesh, [layer.to(device)],
                                      inp.to(device))
            out[f'float_{name}' + ('_exact' if exact else '')] = dict(
                got=_np(got), want=_np(want),
                kinds=[type(m).__name__ for m in layer.children()])
    return out


def _toy_denoiser(which, quantized, seed=0, device='cpu', spatial=True):
    """A toy DiT (4 heads) or U-Net (a spatial transformer with 1x1
    ``proj_in``/``proj_out`` and a GEGLU, or with ``spatial=False`` the
    ADM attention's 1x1 ``qkv``/``proj``), f32, random weights with the
    biases drawn too; with ``quantized`` its int8 twin
    (``quantize_dit`` / ``quantize_unet``)."""
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.unet import UNetConfig, UNetModel
    from ln3diff_tpu_torch.ops.int8 import quantize_dit, quantize_unet
    gen = torch.Generator().manual_seed(seed)
    if which == 'dit':
        model = DiT_TriLatent(DiTConfig(
            input_size=8, patch_size=2, in_channels=4, hidden_size=64,
            depth=2, num_heads=4, variant='text', context_dim=16,
            dtype=torch.float32))
    else:
        model = UNetModel(UNetConfig(
            in_channels=4, model_channels=16, out_channels=4,
            num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), num_heads=4, num_head_channels=-1
            if spatial else 8, use_spatial_transformer=spatial,
            context_dim=16, roll_out=True, mixed_prediction=True,
            dtype=torch.float32))
    random_init_(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('bias') or name == 'mixing_logit':
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    if quantized:
        model = (quantize_dit if which == 'dit' else quantize_unet)(model)
    return model.to(device).eval()


def tp_placement(which, quantized, spatial=True):
    """``tp_shard_denoiser_params`` of a toy denoiser (every size sharded):
    for each layer whose kernel ``tensor_parallel_rules`` places on
    'tensor', its type after the split and its kernel's local and whole
    element counts."""
    from ln3diff_tpu_torch.parallel.serving import tp_shard_denoiser_params
    mesh = _tensor_mesh()
    model = _toy_denoiser(which, quantized, spatial=spatial)
    t_i = pmesh.AXES.index('tensor')
    rules = pmesh.tensor_parallel_rules(model, mesh, 0)
    whole = dict(model.named_parameters())
    whole.update(model.named_buffers())
    tp_shard_denoiser_params(model, mesh, min_size_to_shard=0)
    mods = dict(model.named_modules())
    out = {}
    for name, pl in rules.items():
        if not pl[t_i].is_shard():
            continue
        owner, leaf = name.rsplit('.', 1)
        local = getattr(mods[owner], leaf)
        out[owner] = dict(kind=type(mods[owner]).__name__,
                          local=local.numel(), whole=whole[name].numel(),
                          dim=pl[t_i].dim)
    return out


def tp_refuses_unsplittable():
    """``tp_shard_denoiser_params`` on a layer that the rules shard (a
    ``Conv1d`` kernel under ``qkv``) but that has no split module: the
    error's text."""
    from ln3diff_tpu_torch.parallel.serving import tp_shard_denoiser_params
    model = torch.nn.Sequential(_Named('qkv', torch.nn.Conv1d(16, 32, 4)))
    try:
        tp_shard_denoiser_params(model, _tensor_mesh(), min_size_to_shard=0)
    except ValueError as e:
        return str(e)
    return 'not refused'


def tp_sampling(min_size, device='cpu', which='dit', quantized=False,
                spatial=True, steps=4):
    """DDIM sampling with CFG through a toy denoiser split over the tensor
    ranks (``tp_shard_denoiser_params``) and through the whole one: the
    two latents, and which of the layers were split.  ``which='dit'``:
    the DiT (v = ε prediction, no mixing), with ``quantized`` its int8
    twin; ``'unet'``: the U-Net LSGM (v-prediction with its mixing logit),
    with ``spatial=False`` its ADM attention in place of the transformer.
    For the DiT, ``kinds`` lists the first block's split layers and
    ``heads`` its attention's heads; for the U-Net every split layer."""
    from ln3diff_tpu_torch.diffusion.gaussian import make_diffusion
    from ln3diff_tpu_torch.parallel.serving import (SPLIT_CLASSES,
                                                    tp_shard_denoiser_params)
    from ln3diff_tpu_torch.pipeline import SamplerSpec, TextTo3DPipeline
    mesh = _tensor_mesh()
    if which == 'dit' and not quantized:
        from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
        from ln3diff_tpu_torch.models.layers import random_init_
        cfg = DiTConfig(input_size=8, patch_size=2, in_channels=4,
                        hidden_size=64, depth=2, num_heads=4,
                        variant='text', context_dim=16, dtype=torch.float32)
        model = DiT_TriLatent(cfg)
        random_init_(model, torch.Generator().manual_seed(0))
        model.to(device)
    else:
        model = _toy_denoiser(which, quantized, device=device,
                              spatial=spatial)
    cond = {'crossattn': torch.ones(1, 7, 16, device=device)}
    uncond = {'crossattn': torch.zeros(1, 7, 16, device=device)}
    x_init = torch.randn(2, 8, 8, 12, generator=torch.Generator()
                         .manual_seed(1)).to(device)
    unet = which == 'unet'

    def sample():
        pipe = TextTo3DPipeline(
            lambda x, t, c: model(x, t, c), None, None, None,
            sampler=SamplerSpec(kind='ddim', num_steps=steps, cfg_scale=2.0,
                                latent_shape=(8, 8, 12)),
            diffusion=make_diffusion(steps=100, timestep_respacing=str(steps),
                                     mean_type='v' if unet else 'eps',
                                     mixed_prediction=unet),
            mixing_logit=model.mixing_logit.detach() if unet else None,
            device=device)
        return pipe.sample_latents(2, cond, uncond, x_init=x_init)

    ref = sample()
    tp_shard_denoiser_params(model, mesh, min_size_to_shard=min_size)
    got = sample()
    root = model.blocks[0] if which == 'dit' else model
    kinds = {n: type(m).__name__ for n, m in root.named_modules()
             if isinstance(m, SPLIT_CLASSES)}
    heads = root.attn.num_heads if which == 'dit' else None
    return dict(ref=_np(ref), got=_np(got), kinds=kinds, heads=heads)


def tp_sampling_dit_l2_int8(steps=10):
    """On the cards: DDIM sampling with CFG 6.5 through the int8 DiT-L/2
    (the t23d preset with tanh GELU, ``quantize_dit``, bf16, fused
    attention) split over the tensor ranks, against the whole int8 DiT on
    the same rank.  Returns both latents; ``twin``, the whole DiT's
    latents with the condition's context scaled by 1 + 2^-8 (one bf16 ulp:
    the size of the rounding that a bf16 row shard's partial sums add);
    the first denoiser call's output split and whole (``call_got``,
    ``call_ref``) and the whole one's under that change (``call_twin``);
    kernel 3's launches in the split sampling and the first block's
    attention heads."""
    import dataclasses

    from ln3diff_tpu_torch.config import denoiser_preset
    from ln3diff_tpu_torch.diffusion.gaussian import make_diffusion
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.ops.fused_attention import FusedAttention
    from ln3diff_tpu_torch.ops.int8 import quantize_dit
    from ln3diff_tpu_torch.parallel.serving import tp_shard_denoiser_params
    from ln3diff_tpu_torch.pipeline import SamplerSpec, TextTo3DPipeline
    mesh = _tensor_mesh()
    cfg = dataclasses.replace(denoiser_preset('t23d-dit-l2'),
                              exact_gelu=False, fused_attention=True)
    with torch.device('cuda'):
        model = DiT_TriLatent(cfg)
    random_init_(model, torch.Generator(device='cuda').manual_seed(0))
    model = quantize_dit(model.to('cuda').to(cfg.dtype).eval())
    g = torch.Generator(device='cuda').manual_seed(1)
    cond = {'crossattn': torch.randn(1, 77, 768, generator=g,
                                     device='cuda')}
    uncond = {'crossattn': torch.zeros(1, 77, 768, device='cuda')}
    x_init = torch.randn(1, 32, 32, 12, generator=g, device='cuda')
    t999 = torch.full((2,), 999, device='cuda')
    both = {'crossattn': torch.cat([cond['crossattn'],
                                    uncond['crossattn']])}
    nudged = {'crossattn': cond['crossattn'] * (1 + 2**-8)}

    def sample(c):
        pipe = TextTo3DPipeline(
            model, None, None, None,
            sampler=SamplerSpec(kind='ddim', num_steps=steps, cfg_scale=6.5),
            diffusion=make_diffusion(steps=1000,
                                     timestep_respacing=f'ddim{steps}'),
            device='cuda')
        return pipe.sample_latents(1, c, uncond, x_init=x_init)

    with torch.no_grad():
        ref = sample(cond)
        twin = sample(nudged)
        call_ref = model(x_init.expand(2, -1, -1, -1), t999, both)
        call_twin = model(x_init.expand(2, -1, -1, -1), t999, {
            'crossattn': torch.cat([nudged['crossattn'],
                                    uncond['crossattn']])})
        tp_shard_denoiser_params(model, mesh)
        call_got = model(x_init.expand(2, -1, -1, -1), t999, both)
        FusedAttention.launches = 0
        got = sample(cond)
    torch.cuda.synchronize()
    return dict(ref=_np(ref.float()), got=_np(got.float()),
                twin=_np(twin.float()), call_ref=_np(call_ref.float()),
                call_got=_np(call_got.float()),
                call_twin=_np(call_twin.float()),
                fused_attention_launches=FusedAttention.launches,
                heads=model.blocks[0].attn.num_heads, depth=cfg.depth)


def tp_sampling_shapenet_unet(kind, steps=10):
    """On the cards: DDIM sampling of the ShapeNet U-Net-320 LSGM
    (v-prediction, the mixing logit, CFG 1.0 over batch 1) split over the
    tensor ranks against the whole U-Net on the same rank; ``kind``:
    ``'float32'``, ``'bfloat16'`` (the serving dtype) or ``'int8'``
    (``quantize_unet`` of the bf16 U-Net).  The mixing logit is drawn near
    0 so that the U-Net weighs in the prediction (the preset's −6 leaves
    it 0.25%)."""
    from ln3diff_tpu_torch.config import denoiser_preset, vae_preset
    from ln3diff_tpu_torch.diffusion.gaussian import make_diffusion
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.unet import UNetModel
    from ln3diff_tpu_torch.ops.int8 import quantize_unet
    from ln3diff_tpu_torch.parallel.serving import tp_shard_denoiser_params
    from ln3diff_tpu_torch.pipeline import SamplerSpec, TextTo3DPipeline
    mesh = _tensor_mesh()
    cfg = denoiser_preset('shapenet-unet')
    dtype = torch.float32 if kind == 'float32' else torch.bfloat16
    with torch.device('cuda'):
        model = UNetModel(cfg)
    g = torch.Generator(device='cuda').manual_seed(0)
    random_init_(model, g)
    with torch.no_grad():
        model.mixing_logit.normal_(0.0, 0.1, generator=g)
    model = model.to('cuda').to(dtype).eval()
    if kind == 'int8':
        model = quantize_unet(model)
    vae = vae_preset('shapenet')
    shape = (vae.latent_size, vae.latent_size, vae.latent_channels)
    cond = {'crossattn': torch.randn(1, 1, 768, generator=g, device='cuda')}
    x_init = torch.randn((1, *shape), generator=g, device='cuda')

    def sample():
        pipe = TextTo3DPipeline(
            model, None, None, None,
            sampler=SamplerSpec(kind='ddim', num_steps=steps, cfg_scale=1.0,
                                triplane_scaling_divider=1.0,
                                latent_shape=shape),
            diffusion=make_diffusion(steps=1000, mean_type='v',
                                     mixed_prediction=True,
                                     timestep_respacing=f'ddim{steps}'),
            mixing_logit=model.mixing_logit.detach(), device='cuda')
        return pipe.sample_latents(1, cond, cond, x_init=x_init)

    ref = sample()
    tp_shard_denoiser_params(model, mesh)
    got = sample()
    torch.cuda.synchronize()
    return dict(ref=_np(ref.float()), got=_np(got.float()))


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
