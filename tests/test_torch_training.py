"""The stage-1 VAE training slice of the port against the JAX trainer.

Toy sizes on the CPU, f32 on both sides: the tiny VAE of
``tests/test_training.py`` (2 views of 32², SD MVEncoder with multi-view
attention, DiT2 depth 2, 16² planes of 8 channels), patches of 8 (and 16)
of a 16² render, 8 + 8 samples per ray.  Every JAX parameter is perturbed
with seeded numpy noise (flax zero-initialises ``proj_out`` and the adaLN
weights, which would make many grads vanish) and carried across by
``ln3diff_tpu_torch.bridge``; the port is fed JAX's random draws (the
posterior's ε from ``k_vae`` and the render's uniforms from ``k_strat``
and ``k_imp``, ``rng → (k_vae, k_render)``, ``k_render → (k_strat,
k_imp)``).  The same holds for the modules of the slice one by one.

Tolerances: 1e-5 of scale for single functions (f32 sum order only),
1e-4 of each tensor's scale for whole networks and for the loss and every
grad of the training step (f32 sums in another order through the encoder,
DiT2, the conv decoder and the two-pass render), as the other
whole-network tests.  JAX compiles slowly, so each case's JAX step is
computed once and shared (``functools.lru_cache``).
"""

import dataclasses
import functools
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.data import synthetic as jsyn
from ln3diff_tpu.models import distributions as jdist
from ln3diff_tpu.models import sd_vae as jsd
from ln3diff_tpu.models.dit import DiT2Config as JDiT2Config
from ln3diff_tpu.models.vae import TriplaneVAEConfig as JVAEConfig
from ln3diff_tpu.parallel.mesh import MeshConfig, make_mesh
from ln3diff_tpu.render import camera as jcam
from ln3diff_tpu.render import ray_sampler as jrs
from ln3diff_tpu.render import renderer as jr
from ln3diff_tpu.training import losses as jl
from ln3diff_tpu.training import train_state as jts
from ln3diff_tpu.training.vae_trainer import VAETrainConfig as JTrainConfig
from ln3diff_tpu.training.vae_trainer import VAETrainer as JTrainer
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.data import synthetic as tsyn
from ln3diff_tpu_torch.models import distributions as tdist
from ln3diff_tpu_torch.models import sd_vae as tsd
from ln3diff_tpu_torch.models.dit import DiT2Config
from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
from ln3diff_tpu_torch.render import camera as tcam
from ln3diff_tpu_torch.render import ray_sampler as trs
from ln3diff_tpu_torch.render import renderer as tr
from ln3diff_tpu_torch.training import losses as tl
from ln3diff_tpu_torch.training import train_state as tts
from ln3diff_tpu_torch.training.vae_trainer import (TrainDraws,
                                                    VAETrainConfig,
                                                    VAETrainer)

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

TINY = dict(encoder_in_channels=10, encoder_ch=8, encoder_ch_mult=(1, 2),
            encoder_res_blocks=1, img_resolution=32, num_views=2,
            ldm_z_channels=4, latent_size=16, patch_size=2, conv_sr_ch=8,
            conv_sr_ch_mult=(1, 2), conv_sr_res_blocks=1, plane_channels=8,
            decoder_output_dim=8)
DIT2 = dict(tokens_per_plane=64, hidden_size=32, depth=2, num_heads=2)
OPTS = dict(depth_resolution=8, depth_resolution_importance=8,
            ray_start='auto', ray_end='auto', box_warp=1.0,
            filter_out_of_bbox=True)
LR, EMA_RATE, STEP = 2e-3, 0.5, 7.0


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float64)


def close_to_scale(got, want, rel, msg=''):
    """|Δ| <= rel · max(|want|, tiny)."""
    want = _np(want)
    got = _np(got)
    assert got.shape == want.shape, msg
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=msg)


def _perturbed(params, seed):
    """Every leaf plus 0.05·N(0, 1) noise from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32)), params)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# -- data, cameras and rays ---------------------------------------------------

@pytest.mark.parametrize('seed,views,sup', [(0, 2, 0), (3, 4, 2)])
def test_synthetic_batch_matches_jax_bytewise(seed, views, sup):
    want = jsyn.make_multiview_batch(views, 32, 16, seed=seed,
                                     num_views_sup=sup)
    got = tsyn.make_multiview_batch(views, 32, 16, seed=seed,
                                    num_views_sup=sup)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_camera_helpers_match_jax():
    yaw = np.linspace(0.1, 5.0, 5)
    pitch = np.linspace(0.3, 2.8, 5)
    assert np.array_equal(tcam.lookat_pose(yaw, pitch, radius=1.7),
                          jcam.lookat_pose(yaw, pitch, radius=1.7))
    assert np.array_equal(tcam.fov_to_intrinsics(40.0),
                          jcam.fov_to_intrinsics(40.0))


@pytest.mark.parametrize('with_bbox', [False, True])
def test_patch_origins_replay_jax_draws(with_bbox):
    """The same numpy generator gives the same foreground-biased origins."""
    bbox = np.array([[2, 3, 14, 12], [0, 0, 16, 16], [5, 4, 9, 10]],
                    np.int32) if with_bbox else None
    a = jrs.sample_patch_origins(np.random.default_rng([4, 0]), 3, 8, 16,
                                 bbox)
    b = trs.sample_patch_origins(np.random.default_rng([4, 0]), 3, 8, 16,
                                 bbox)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_patch_rays_match_jax():
    batch = jsyn.make_multiview_batch(3, 32, 16, seed=1)
    cams = batch['c']
    c2w, intr = jrs.unpack_25d_camera(jnp.asarray(cams))
    packed = jrs.pack_25d_camera(c2w, intr)
    t_c2w, t_intr = trs.unpack_25d_camera(_t(cams))
    assert np.array_equal(np.asarray(packed),
                          trs.pack_25d_camera(t_c2w, t_intr).numpy())
    h0 = np.array([0, 5, 8], np.int32)
    w0 = np.array([8, 2, 0], np.int32)
    want_uv = jrs.patch_uv(jnp.asarray(h0), jnp.asarray(w0), 8, 16)
    got_uv = trs.patch_uv(torch.from_numpy(h0), torch.from_numpy(w0), 8, 16)
    close_to_scale(got_uv, want_uv, 1e-7)
    want = jrs.sample_patch_rays(c2w, intr, jnp.asarray(h0),
                                 jnp.asarray(w0), 8, 16)
    got = trs.sample_patch_rays(t_c2w, t_intr, torch.from_numpy(h0),
                                torch.from_numpy(w0), 8, 16)
    for g, w in zip(got, want):
        close_to_scale(g, w, 1e-6)


# -- the renderer's random draws ----------------------------------------------

def _limits(B, R, seed):
    rng = np.random.default_rng(seed)
    start = rng.uniform(1.0, 1.5, (B, R, 1)).astype(np.float32)
    return start, start + rng.uniform(0.3, 0.8, (B, R, 1)).astype(np.float32)


@pytest.mark.parametrize('kind', ['per_ray', 'scalar', 'disparity'])
def test_jittered_stratified_with_jax_draws(kind):
    B, R, S = 1, 20, 8
    origins = np.zeros((B, R, 3), np.float32)
    key = jax.random.PRNGKey(11)
    u = jax.random.uniform(key, (B, R, S, 1))
    if kind == 'per_ray':
        start, end = _limits(B, R, 12)
        js, je, ts, te = (jnp.asarray(start), jnp.asarray(end), _t(start),
                          _t(end))
    else:
        js = ts = 0.8
        je = te = 2.2
    disp = kind == 'disparity'
    want = jr.sample_stratified(key, jnp.asarray(origins), js, je, S,
                                disparity_space_sampling=disp)
    got = tr.sample_stratified(_t(origins), ts, te, S,
                               disparity_space_sampling=disp, u=_t(u))
    close_to_scale(got, want, 1e-6)
    # without draws: the deterministic midpoints of JAX's key=None
    want = jr.sample_stratified(None, jnp.asarray(origins), js, je, S,
                                disparity_space_sampling=disp)
    got = tr.sample_stratified(_t(origins), ts, te, S,
                               disparity_space_sampling=disp)
    close_to_scale(got, want, 1e-6)


def test_importance_sampling_with_jax_draws():
    B, R, S, n_imp = 2, 30, 8, 8
    start, end = _limits(B, R, 13)
    z = jr.sample_stratified(None, jnp.zeros((B, R, 3)), jnp.asarray(start),
                             jnp.asarray(end), S)
    w = np.random.default_rng(14).uniform(0, 1, (B, R, S - 1, 1)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(15)
    u = jax.random.uniform(key, (B * R, n_imp))
    want = jr.sample_importance(key, z, jnp.asarray(w), n_imp)
    got = tr.sample_importance(_t(z), _t(w), n_imp, u=_t(u))
    close_to_scale(got, want, 1e-5)


def test_render_rays_with_jax_draws():
    """The two-pass render of random planes with JAX's key: the port fed
    JAX's uniforms renders the same features, depths and weights, to 1e-5
    abs and 1e-4 relative as ``tests/test_torch_render.py`` holds the
    deterministic render (α = 1 − exp(−σδ) cancels for small σδ)."""
    rng = np.random.default_rng(16)
    planes = (rng.standard_normal((2, 3, 8, 8, 8)) * 0.5).astype(np.float32)
    batch = jsyn.make_multiview_batch(2, 32, 16, seed=2)
    c2w, intr = jrs.unpack_25d_camera(jnp.asarray(batch['c']))
    h0 = jnp.asarray([2, 6])
    ray_o, ray_d = jrs.sample_patch_rays(c2w, intr, h0, h0[::-1], 8, 16)
    w1 = (rng.standard_normal((8, 64)) * 0.3).astype(np.float32)
    w2 = (rng.standard_normal((64, 9)) * 0.3).astype(np.float32)

    def jdec(f, d):
        h = jax.nn.softplus(jnp.mean(f, axis=1) @ w1)
        out = h @ w2
        return jax.nn.sigmoid(out[..., 1:]), out[..., :1]

    def tdec(f, d):
        h = torch.nn.functional.softplus(torch.mean(f, dim=1) @ _t(w1))
        out = h @ _t(w2)
        return torch.sigmoid(out[..., 1:]), out[..., :1]

    opts = dict(OPTS, depth_resolution=8, depth_resolution_importance=8)
    key = jax.random.PRNGKey(17)
    want = jr.render_rays(key, jnp.asarray(planes), jdec, ray_o, ray_d,
                          jr.RenderOptions(**opts))
    k_strat, k_imp = jax.random.split(key)
    draws = tr.RenderDraws(_t(jax.random.uniform(k_strat, (2, 64, 8, 1))),
                           _t(jax.random.uniform(k_imp, (128, 8))))
    got = tr.render_rays(_t(planes), tdec, _t(ray_o), _t(ray_d),
                         tr.RenderOptions(**opts), draws=draws)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-4)
    # opts.deterministic ignores the draws, as JAX ignores the key
    det = tr.RenderOptions(**opts, deterministic=True)
    got = tr.render_rays(_t(planes), tdec, _t(ray_o), _t(ray_d), det,
                         draws=draws)
    want = jr.render_rays(None, jnp.asarray(planes), jdec, ray_o, ray_d,
                          jr.RenderOptions(**opts))
    np.testing.assert_allclose(_np(got.feature_samples),
                               _np(want.feature_samples), atol=1e-5,
                               rtol=1e-4)


# -- the encoder --------------------------------------------------------------

ENC_CASES = {
    # the released arch: MVEncoder, joint-view MVAttn in the mid block
    'mv_encoder': (2, ()),
    # one view: the plain Encoder, AttnBlock at 16² and in the mid block
    'mono_encoder': (0, (16,)),
    # more than 4 views: mean over the views' features
    'dynamic_encoder': (5, ()),
}


@pytest.mark.parametrize('case', sorted(ENC_CASES))
def test_encoder_matches_jax(case):
    V, attn_res = ENC_CASES[case]
    kw = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
              z_channels=12, double_z=True, attn_resolutions=attn_res)
    jcfg = jsd.AutoencoderConfig(**kw)
    tcfg = tsd.AutoencoderConfig(in_channels=10, **kw)
    if V == 0:
        jm, tm, n = jsd.Encoder(jcfg), tsd.Encoder(tcfg), 1
    elif V > 4:
        jm = jsd.MVEncoderDynamic(jcfg, num_frames=V)
        tm, n = tsd.MVEncoderDynamic(tcfg, num_frames=V), V
    else:
        jm, tm, n = jsd.MVEncoder(jcfg, num_frames=V), tsd.MVEncoder(
            tcfg, num_frames=V), V
    x = np.random.default_rng(18).standard_normal((2 * n, 32, 32, 10)) \
        .astype(np.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _perturbed(v['params'], 19)
    tm.load_state_dict(bridge._convert(
        jax.tree_util.tree_map(np.asarray, params), {}))
    want = jm.apply({'params': params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    assert tuple(got.shape) == want.shape == (2, 16, 16, 24)
    close_to_scale(got, want, 1e-4)


def test_mvattn_details():
    """MVAttn's traps: LayerNorm eps 1e-6, bias-free q/k/v, a
    zero-initialised proj_out (the block starts as the identity)."""
    m = tsd.MVAttn(16, num_views=2, num_heads=2, dim_head=8)
    assert m.block_0_norm1.eps == 1e-6
    assert m.block_0_attn1_q.bias is None and m.block_0_attn2_v.bias is None
    x = torch.randn(4, 16, 4, 4)
    torch.testing.assert_close(m(x), x, rtol=0, atol=0)


def test_downsample_pads_bottom_right():
    d = tsd.Downsample(1)
    with torch.no_grad():
        d.conv.weight.zero_()
        d.conv.weight[0, 0, 2, 2] = 1.0
        d.conv.bias.zero_()
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    # output (i, j) reads input (2i + 2, 2j + 2): the padded zero at 4
    assert d(x).tolist() == [[[[10.0, 0.0], [0.0, 0.0]]]]


def test_diagonal_gaussian_matches_jax():
    rng = np.random.default_rng(20)
    mean = rng.standard_normal((2, 4, 4, 4, 3)).astype(np.float32)
    logvar = (rng.standard_normal((2, 4, 4, 4, 3)) * 30).astype(np.float32)
    key = jax.random.PRNGKey(21)
    for soft in (True, False):
        jg = jdist.make_gaussian(jnp.asarray(mean), jnp.asarray(logvar),
                                 soft_clamp=soft)
        tg = tdist.make_gaussian(_t(mean), _t(logvar), soft_clamp=soft)
        eps = jax.random.normal(key, mean.shape)
        close_to_scale(tg.sample(eps=_t(eps)), jg.sample(key), 1e-6)
        close_to_scale(tg.kl(), jg.kl(), 1e-6)


# -- losses -------------------------------------------------------------------

def _loss_inputs(seed=22, hw=16):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (2, hw, hw, 3)).astype(np.float32)
    pred = np.clip(img + 0.2 * rng.standard_normal(img.shape), -1, 1) \
        .astype(np.float32)
    mask = (rng.uniform(0, 1, (2, hw, hw, 1)) > 0.4).astype(np.float32)
    depth = rng.uniform(1.0, 2.0, (2, hw, hw, 1)).astype(np.float32)
    pdepth = (depth * 1.3 + 0.1 * rng.standard_normal(depth.shape)) \
        .astype(np.float32)
    return img, pred, mask, depth, pdepth


def test_loss_functions_match_jax():
    img, pred, mask, depth, pdepth = _loss_inputs()
    J = jnp.asarray
    pairs = [
        (tl.masked_mse(_t(pred), _t(img), _t(mask)),
         jl.masked_mse(J(pred), J(img), J(mask))),
        (tl.masked_mse(_t(pred), _t(img)), jl.masked_mse(J(pred), J(img))),
        (tl.masked_l1(_t(pred), _t(img), _t(mask)),
         jl.masked_l1(J(pred), J(img), J(mask))),
        (tl.silog_depth_loss(_t(pdepth), _t(depth), _t(mask)),
         jl.silog_depth_loss(J(pdepth), J(depth), J(mask))),
        (tl.scale_shift_invariant_depth_loss(_t(pdepth), _t(depth),
                                             _t(mask)),
         jl.scale_shift_invariant_depth_loss(J(pdepth), J(depth), J(mask))),
        (tl.ssim(_t(pred), _t(img)), jl.ssim(J(pred), J(img))),
        (tl.kl_coeff(7.0, 10, 5, 1e-8, 1e-6),
         jl.kl_coeff(7.0, 10, 5, 1e-8, 1e-6)),
        (tl.kl_coeff(2.0, 10, 5, 1e-8, 1e-6),
         jl.kl_coeff(2.0, 10, 5, 1e-8, 1e-6)),
    ]
    for i, (g, w) in enumerate(pairs):
        close_to_scale(g, w, 1e-5, msg=str(i))


def test_reconstruction_losses_match_jax():
    img, pred, mask, depth, pdepth = _loss_inputs(seed=23)
    alpha = np.clip(mask + 0.1, 0, 1)
    kl = np.array([120.0, 80.0], np.float32)
    cfg = dict(l1_lambda=0.3, ssim_lambda=0.2, depth_lambda=0.5,
               kl_anneal_steps=10, lpips_lambda=0.8)

    def lpips_j(a, b):
        return jnp.mean(jnp.abs(a - b))

    def lpips_t(a, b):
        return torch.mean(torch.abs(a - b))

    J = jnp.asarray
    want, wterms = jl.reconstruction_losses(
        dict(image_raw=J(pred), image_mask=J(alpha), image_depth=J(pdepth)),
        dict(img=J(img), depth_mask=J(mask[..., 0]), depth=J(depth[..., 0])),
        jl.LossConfig(**cfg), kl=J(kl), step=jnp.asarray(STEP),
        lpips_fn=lpips_j)
    got, gterms = tl.reconstruction_losses(
        dict(image_raw=_t(pred), image_mask=_t(alpha),
             image_depth=_t(pdepth)),
        dict(img=_t(img), depth_mask=_t(mask[..., 0]),
             depth=_t(depth[..., 0])),
        tl.LossConfig(**cfg), kl=_t(kl), step=STEP, lpips_fn=lpips_t)
    assert sorted(gterms) == sorted(wterms)
    close_to_scale(got, want, 1e-5)
    for k in wterms:
        close_to_scale(gterms[k], wterms[k], 1e-5, msg=k)


# -- the optimizer ------------------------------------------------------------

OPT_CASES = {
    'clip_triggered': dict(grad_clip=0.5, grad_scale=1.0),
    'clip_not_triggered': dict(grad_clip=0.5, grad_scale=1e-3),
    'lr_groups_warmup_cosine': dict(grad_clip=None, grad_scale=1.0,
                                    lr_groups={'dit2': 5e-4},
                                    warmup_steps=2, total_steps=8),
}


@pytest.mark.parametrize('case', sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    """Four AdamW steps with the clip, the lr groups and the schedule
    against optax on the same grads; the EMA against the JAX train
    state's."""
    kw = dict(OPT_CASES[case])
    scale = kw.pop('grad_scale')
    rng = np.random.default_rng(24)
    shapes = {'encoder': {'w': (5, 3)}, 'dit2': {'w': (4,), 'b': (2, 2)}}
    params = {m: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in d.items()} for m, d in shapes.items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = {f'{m}.{k}': _t(v) for m, d in params.items()
               for k, v in d.items()}
    tx = jts.make_optimizer(1e-2, 0.01, **kw)
    state = jts.create_train_state(jparams, tx, ema_rates=(('ema', 0.5),))
    ttx = tts.make_optimizer(1e-2, 0.01, **kw)
    module = torch.nn.Module()
    for name, p in tparams.items():
        m, k = name.split('.')
        if not hasattr(module, m):
            module.add_module(m, torch.nn.Module())
        getattr(module, m).register_parameter(k, torch.nn.Parameter(p))
    tstate = tts.TrainState.create(module, ttx, ema_rates=(('ema', 0.5),))
    for i in range(4):
        grads = {m: {k: (rng.standard_normal(s) * scale).astype(np.float32)
                     for k, s in d.items()} for m, d in shapes.items()}
        state = state.apply_gradients(
            jax.tree_util.tree_map(jnp.asarray, grads),
            ema_rates=(('ema', 0.5),))
        tstate.apply_gradients({f'{m}.{k}': _t(v) for m, d in grads.items()
                                for k, v in d.items()})
        for m, d in shapes.items():
            for k in d:
                close_to_scale(tstate.params[f'{m}.{k}'],
                               state.params[m][k], 1e-6, msg=f'{i} {m}.{k}')
                close_to_scale(tstate.ema_params['ema'][f'{m}.{k}'],
                               state.ema_params['ema'][m][k], 1e-6)
    assert tstate.step == 4
    gs = [_t(rng.standard_normal((3, 3))), _t(rng.standard_normal(5))]
    close_to_scale(tts.global_norm(gs),
                   optax.global_norm([jnp.asarray(g.numpy()) for g in gs]),
                   1e-6)


# -- the slice: one training step ---------------------------------------------

def _jcfg():
    return JVAEConfig(dit2=JDiT2Config(dtype=jnp.float32, **DIT2),
                      dtype=jnp.float32, **TINY)


def _tcfg():
    return TriplaneVAEConfig(dit2=DiT2Config(dtype=torch.float32, **DIT2),
                             dtype=torch.float32, **TINY)


CASES = {
    'plain': dict(use_fused_osg=False, patch=8, loss={}),
    'fused': dict(use_fused_osg=True, patch=8, loss={}),
    # full-view patches (SSIM's 11² window needs ≥ 11²), every loss term
    'fused_ssim_l1_kl_anneal': dict(
        use_fused_osg=True, patch=16,
        loss=dict(ssim_lambda=0.2, l1_lambda=0.3, depth_lambda=0.5,
                  kl_anneal_steps=10)),
}


@functools.lru_cache(maxsize=None)
def _jax_init():
    """JAX's trainer params for the tiny VAE, every leaf perturbed."""
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    trainer = JTrainer(_jcfg(), JTrainConfig(patch_resolution=8,
                                             render_resolution=16),
                       jl.LossConfig(lpips_lambda=0.0),
                       render_opts=jr.RenderOptions(**OPTS), mesh=mesh)
    raw = jsyn.make_multiview_batch(2, 32, 16, seed=0)
    state = trainer.init_state(raw)
    return mesh, _perturbed(state.params, 25), raw, state.params


@functools.lru_cache(maxsize=None)
def _jax_step(case):
    """JAX's loss, terms, grads and one optimizer step (with the EMA) for
    ``case``, and the draws its key makes."""
    mesh, params, raw, _ = _jax_init()
    c = CASES[case]
    trainer = JTrainer(
        _jcfg(), JTrainConfig(lr=LR, patch_resolution=c['patch'],
                              render_resolution=16,
                              use_fused_osg=c['use_fused_osg']),
        jl.LossConfig(lpips_lambda=0.0, **c['loss']),
        render_opts=jr.RenderOptions(**OPTS), mesh=mesh, seed=0)
    batch = trainer.prepare_batch(raw)
    batch['step'] = jnp.asarray(STEP, jnp.float32)
    key = jax.random.PRNGKey(7)
    (loss, terms), grads = jax.jit(jax.value_and_grad(
        trainer._loss_fn, has_aux=True))(params, None, batch, key)
    tx = jts.make_optimizer(LR, 0.01, grad_clip=0.5)
    rates = (('ema', EMA_RATE),)
    state = jts.create_train_state(params, tx, ema_rates=rates)
    new = jax.jit(lambda s, g: s.apply_gradients(g, ema_rates=rates))(
        state, grads)
    # the draws of _loss_fn's key: rng → (k_vae, k_render),
    # k_render → (k_strat, k_imp)
    k_vae, k_render = jax.random.split(key)
    k_strat, k_imp = jax.random.split(k_render)
    R, S = c['patch']**2, OPTS['depth_resolution']
    draws = TrainDraws(
        _t(jax.random.normal(k_vae, (1, 16, 16, 4, 3))),
        tr.RenderDraws(
            _t(jax.random.uniform(k_strat, (2, R, S, 1))),
            _t(jax.random.uniform(k_imp,
                                  (2 * R, OPTS['depth_resolution_importance'])
                                  ))))
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(
        params=np_tree(params), patch=(np.asarray(batch['patch_h']),
                                       np.asarray(batch['patch_w'])),
        loss=float(loss), terms={k: float(v) for k, v in terms.items()},
        grads=np_tree(grads), grad_norm=float(optax.global_norm(grads)),
        new_params=np_tree(new.params),
        new_ema=np_tree(new.ema_params['ema']), draws=draws)


def _port_trainer(case):
    want = _jax_step(case)
    c = CASES[case]
    trainer = VAETrainer(
        _tcfg(), VAETrainConfig(lr=LR, patch_resolution=c['patch'],
                                render_resolution=16, ema_rate=EMA_RATE,
                                use_fused_osg=c['use_fused_osg']),
        tl.LossConfig(lpips_lambda=0.0, **c['loss']),
        render_opts=tr.RenderOptions(**OPTS), seed=0, device='cpu')
    trainer.model.load_state_dict(bridge.vae_state_dict(want['params']))
    batch = trainer.prepare_batch(tsyn.make_multiview_batch(2, 32, 16,
                                                            seed=0))
    batch['step'] = STEP
    return want, trainer, batch


@pytest.mark.parametrize('case', sorted(CASES))
def test_train_step_matches_jax(case):
    """One step of the port's trainer against JAX's, from the same params,
    batch and draws: the patch origins, the loss and each term, every
    grad (JAX's grad tree carried by the bridge), the metrics, and the
    params and EMA after the AdamW step."""
    want, trainer, batch = _port_trainer(case)
    assert np.array_equal(batch['patch_h'].numpy(), want['patch'][0])
    assert np.array_equal(batch['patch_w'].numpy(), want['patch'][1])

    loss, terms = trainer.loss_fn(batch, draws=want['draws'])
    close_to_scale(loss, want['loss'], 1e-4, msg='loss')
    assert sorted(terms) == sorted(want['terms'])
    for k, v in terms.items():
        close_to_scale(v, want['terms'][k], 1e-4, msg=k)
    loss.backward()
    want_grads = bridge.vae_state_dict(want['grads'])
    params = dict(trainer.model.named_parameters())
    assert sorted(want_grads) == sorted(params)
    # a conv bias right before a GroupNorm has a zero grad: both sides hold
    # f32 rounding noise there, so each tensor's bound has a floor of 1e-6
    # of the largest grad of the model
    floor = 1e-6 * max(float(g.abs().max()) for g in want_grads.values())
    for k, p in params.items():
        assert p.grad is not None, k
        w = want_grads[k]
        np.testing.assert_allclose(
            _np(p.grad), _np(w), rtol=0, err_msg=k,
            atol=max(1e-4 * float(w.abs().max()), floor))
    trainer.model.zero_grad(set_to_none=True)

    metrics = trainer.train_step(batch, draws=want['draws'])
    close_to_scale(metrics['loss'], want['loss'], 1e-4)
    close_to_scale(metrics['grad_norm'], want['grad_norm'], 1e-4)
    new_params = bridge.vae_state_dict(want['new_params'])
    new_ema = bridge.vae_state_dict(want['new_ema'])
    state = trainer.state
    # A first AdamW step moves a weight by lr·ĝ/(|ĝ| + 1e-8) (ĝ: the
    # clipped grad).  Where the grad is resolved, |g| >= 10× its bound
    # above, that step moves by at most lr·(1e-8/|ĝ|)·0.1 between the two
    # sides (under 1e-2·lr here): it must match to 1e-5 of scale plus
    # that.  Elsewhere (grads at the noise floor, such as the key bias of
    # attention, whose grad is zero) the step may differ by up to 2·lr.
    for k in params:
        w = want_grads[k]
        resolved = _np(w.abs()) >= 10 * max(1e-4 * float(w.abs().max()),
                                            floor)
        for got, ref in ((state.params[k], new_params[k]),
                         (state.ema_params['ema'][k], new_ema[k])):
            err = np.abs(_np(got) - _np(ref))
            assert err.max() <= 2 * LR + 1e-6, k
            tol = 1e-5 * float(ref.abs().max()) + 1e-2 * LR
            assert (err[resolved] <= tol).all(), k
    # ... and the port's optimizer on JAX's own grads takes JAX's step to
    # f32 rounding
    twin = VAETrainer(_tcfg(), trainer.cfg, trainer.loss_cfg,
                      render_opts=trainer.render_opts, device='cpu')
    twin.model.load_state_dict(bridge.vae_state_dict(want['params']))
    twin.init_state()
    twin.state.apply_gradients(want_grads)
    for k in params:
        close_to_scale(twin.state.params[k], new_params[k], 1e-6, msg=k)
        close_to_scale(twin.state.ema_params['ema'][k], new_ema[k], 1e-6,
                       msg=k)


def test_autoencode_matches_jax():
    """``TriplaneVAE.forward`` (JAX ``__call__``): encode two views,
    sample the posterior with JAX's ε, decode, render an 8² view with
    JAX's uniforms; latent, KL, planes and images to 1e-4 of scale."""
    from ln3diff_tpu.models.vae import TriplaneVAE as JVAE
    _, params, raw, _ = _jax_init()
    key = jax.random.PRNGKey(9)
    opts = jr.RenderOptions(**OPTS)
    jm = JVAE(_jcfg())
    want = jm.apply({'params': params}, jnp.asarray(raw['img_to_encoder']),
                    jnp.asarray(raw['c'][:1]), opts, 8, key)
    k_vae, k_render = jax.random.split(key)
    k_strat, k_imp = jax.random.split(k_render)
    model = TriplaneVAE(_tcfg(), encoder=True)
    model.load_state_dict(bridge.vae_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = model(_t(raw['img_to_encoder']), _t(raw['c'][:1]),
                    tr.RenderOptions(**OPTS), 8,
                    eps=_t(jax.random.normal(k_vae, (1, 16, 16, 4, 3))),
                    draws=tr.RenderDraws(
                        _t(jax.random.uniform(k_strat, (1, 64, 8, 1))),
                        _t(jax.random.uniform(k_imp, (64, 8)))))
    for k in ('latent', 'posterior_kl', 'planes', 'image_raw',
              'image_depth', 'image_mask'):
        close_to_scale(got[k], want[k], 1e-4, msg=k)


def test_fused_osg_gives_osg_decoder_grads():
    """With ``use_fused_osg=True`` the OSG decoder's EqualDense weights get
    the same non-zero grads as with the plain decoder path."""
    grads = {}
    for case in ('plain', 'fused'):
        want, trainer, batch = _port_trainer(case)
        loss, _ = trainer.loss_fn(batch, draws=want['draws'])
        loss.backward()
        grads[case] = {k: p.grad for k, p in
                       trainer.model.osg_decoder.named_parameters()}
    for k, g in grads['fused'].items():
        assert float(g.abs().max()) > 0, k
        close_to_scale(g, grads['plain'][k], 1e-5, msg=k)


def test_microbatches_average_grads():
    """``microbatch_steps=2`` over two copies of one batch takes the step
    of the batch itself (deterministic draws: no generator)."""
    _, trainer, batch = _port_trainer('plain')
    twin = VAETrainer(_tcfg(), dataclasses.replace(trainer.cfg,
                                                   microbatch_steps=2),
                      trainer.loss_cfg, render_opts=trainer.render_opts,
                      device='cpu')
    twin.model.load_state_dict(trainer.model.state_dict())
    stacked = {k: (torch.stack([v, v]) if torch.is_tensor(v) and v.ndim >= 1
                   else v) for k, v in batch.items()}
    m1 = trainer.train_step(batch)
    m2 = twin.train_step(stacked)
    for k in m1:
        close_to_scale(m2[k], m1[k], 1e-6, msg=k)
    for k, p in trainer.state.params.items():
        close_to_scale(twin.state.params[k], p, 1e-6, msg=k)


def test_run_loop_trains_and_logs():
    """Three steps of ``run_loop`` from the synthetic data: finite metrics
    logged at every step, every parameter moved."""
    _, trainer, _ = _port_trainer('fused')
    trainer.cfg = dataclasses.replace(trainer.cfg, log_interval=1)
    before = {k: p.detach().clone()
              for k, p in trainer.model.named_parameters()}
    logs = []
    raw = tsyn.make_multiview_batch(2, 32, 16, seed=0)
    trainer.run_loop(iter([raw] * 3), num_steps=3,
                     generator=torch.Generator().manual_seed(0),
                     log=logs.append)
    assert [d['step'] for d in logs] == [1, 2, 3]
    assert all(np.isfinite(v) for d in logs for v in d.values())
    for k, p in trainer.model.named_parameters():
        assert not torch.equal(p, before[k]), k


def test_trainer_init_zeroes_what_jax_zeroes():
    """The trainer's random init is zero exactly where JAX's trainer init
    is: the biases, the adaLN modulations (adaLN-zero) and the multi-view
    attention's ``proj_out``."""
    init = bridge.vae_state_dict(jax.tree_util.tree_map(np.asarray,
                                                        _jax_init()[3]))
    want = sorted(k for k, v in init.items() if not v.any())
    trainer = VAETrainer(_tcfg(), device='cpu')
    got = sorted(k for k, p in trainer.model.named_parameters()
                 if not p.any())
    assert got == want
    assert 'encoder.encoder.mid_attn_1.proj_out.weight' in got
    assert 'dit2.blocks.0.within.adaLN_modulation.weight' in got


def test_bridge_carries_the_whole_vae():
    """``vae_state_dict`` of full trainer params names every parameter of
    the port's VAE with ``encoder=True`` and nothing else."""
    _, params, _, _ = _jax_init()
    sd = bridge.vae_state_dict(jax.tree_util.tree_map(np.asarray, params))
    model = TriplaneVAE(_tcfg(), encoder=True)
    assert sorted(sd) == sorted(model.state_dict())
    assert any(k.startswith('encoder.encoder.mid_attn_1.block_0_attn1_q')
               for k in sd)
    assert 'quant_conv.weight' in sd
