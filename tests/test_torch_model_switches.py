"""The model layer's remaining switches in the port against the JAX
package, f32 on the CPU at toy sizes: the LRM point decoder
(``TriplaneVAEConfig.lrm_decoder``), DiT2 without roll-out
(``DiT2Config.roll_out=False``), the ControlNet branch under the config of
an int8 U-Net, the SR preset map and the DiT2 registry; and the ``dtype``
fields of the CLIP and SD-autoencoder configs.

The toy VAE is ``tests/test_torch_models.py``'s ``vae_cfgs`` (8 plane
channels, DiT2 of width 32 and depth 2 over 4² tokens per plane); the
trainer's is ``tests/test_torch_training.py``'s ``TINY``; the U-Net is
``tests/test_torch_controlnet.py``'s.  JAX's parameters are drawn with
seeded numpy in the shapes of ``jax.eval_shape(init)`` (no XLA compile of
an init; no leaf zero, where flax zeroes the adaLN and zero convs) and
carried across by ``ln3diff_tpu_torch.bridge``.  Renders use JAX's
deterministic sampling (``key=None``); the training step is fed the draws
of JAX's key.

Tolerances: 1e-5 of scale for one module (f32 sums in another order),
1e-4 of scale for a network, a render and a point query; the training
step's loss 1e-5 relative and each grad 1e-4 of its tensor's scale (with
a floor of 1e-6 of the largest grad, as ``test_torch_training.py``); the
int8 U-Net fed the branch's residuals as ``test_torch_int8_unet.py`` holds
that U-Net (1e-2 of scale, the median within 1e-5: an activation within an
f32 ulp of a rounding midpoint quantizes one int8 step apart).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu import config as jconfig
from ln3diff_tpu.data import synthetic as jsyn
from ln3diff_tpu.models import controlnet as jcn
from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.models import osg_decoder as josg
from ln3diff_tpu.models import unet as junet
from ln3diff_tpu.models.vae import TriplaneVAE as JVAE
from ln3diff_tpu.models.vae import TriplaneVAEConfig as JVAEConfig
from ln3diff_tpu.ops import int8 as jint8
from ln3diff_tpu.parallel.mesh import MeshConfig, make_mesh
from ln3diff_tpu.render import renderer as jr
from ln3diff_tpu.render.camera import orbit_cameras
from ln3diff_tpu.training import losses as jl
from ln3diff_tpu.training.vae_trainer import VAETrainConfig as JTrainConfig
from ln3diff_tpu.training.vae_trainer import VAETrainer as JTrainer
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch import config as tconfig
from ln3diff_tpu_torch.data import synthetic as tsyn
from ln3diff_tpu_torch.models import controlnet as tcn
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models import osg_decoder as tosg
from ln3diff_tpu_torch.models import unet as tunet
from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
from ln3diff_tpu_torch.render import renderer as tr
from ln3diff_tpu_torch.training import losses as tl
from ln3diff_tpu_torch.training.vae_trainer import (TrainDraws,
                                                    VAETrainConfig,
                                                    VAETrainer)

torch.set_num_threads(1)

FUSED_MSG = 'fused OSG kernel supports the OSGDecoder arch only'
VAE_KW = dict(ldm_z_channels=4, latent_size=8, patch_size=2, conv_sr_ch=8,
              conv_sr_ch_mult=(1, 2), conv_sr_res_blocks=1, plane_channels=8,
              decoder_output_dim=8)
DIT2_KW = dict(tokens_per_plane=16, hidden_size=32, depth=2, num_heads=2)
OPTS = dict(depth_resolution=6, depth_resolution_importance=6,
            box_warp=0.9, filter_out_of_bbox=True)
RES = 8


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float64)


def close_to_scale(got, want, rel, msg=''):
    """|Δ| <= rel · max|want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=msg)


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _drawn(init, *args, seed, **kw):
    """Params in the shapes that ``init(key, *args, **kw)`` creates, drawn
    with numpy: kernels ~ N(0, 1/fan_in), norm scales 1 + 0.1·N(0, 1),
    EqualDense weights ~ N(0, 1), the rest 0.1·N(0, 1)."""
    shapes = jax.eval_shape(lambda k: init(k, *args, **kw),
                            jax.random.PRNGKey(0))['params']
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape)
        if name == 'kernel':
            x = x / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == 'scale':
            x = 1.0 + 0.1 * x
        elif name != 'weight':
            x = 0.1 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


# -- the LRM point decoder ---------------------------------------------------

def test_lrm_decoder_alone():
    """``LRMOSGDecoder`` at JAX's defaults over (2, 3, 40, 8) features:
    the ``Dense_i`` names and shapes JAX creates, and rgb and σ; with bf16
    features both sides compute (and return) f32."""
    feats = _randn((2, 3, 40, 8), 1)
    jm = josg.LRMOSGDecoder()
    params = _drawn(jm.init, jnp.asarray(feats), seed=2)
    assert {k: v['kernel'].shape for k, v in params.items()} == {
        'Dense_0': (24, 64), 'Dense_1': (64, 64), 'Dense_2': (64, 64),
        'Dense_3': (64, 4)}
    tm = tosg.LRMOSGDecoder(in_features=8)
    tm.load_state_dict(bridge._convert(params, {}))
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        x = torch.from_numpy(feats).to(dtype)
        jrgb, jsig = jm.apply({'params': params},
                              jnp.asarray(feats).astype(jdtype))
        with torch.no_grad():
            rgb, sigma = tm(x)
        assert rgb.dtype == sigma.dtype == torch.float32
        assert jrgb.dtype == jsig.dtype == jnp.float32
        assert rgb.shape == (2, 40, 3) and sigma.shape == (2, 40, 1)
        close_to_scale(rgb, jrgb, 1e-5, f'rgb {dtype}')
        close_to_scale(sigma, jsig, 1e-5, f'sigma {dtype}')


@functools.lru_cache(maxsize=None)
def _vae(lrm_decoder, use_background, roll_out=True):
    """(JAX module, its params, the port's module on those params) of the
    toy decode side."""
    kw = dict(VAE_KW, lrm_decoder=lrm_decoder, use_background=use_background)
    if lrm_decoder and use_background:
        # JAX's fg/bg composite adds the two decoders' colours: the
        # background decoder must give the LRM decoder's 3 channels
        kw['decoder_output_dim'] = 3
    jm = JVAE(JVAEConfig(dit2=jdit.DiT2Config(
        dtype=jnp.float32, roll_out=roll_out, **DIT2_KW),
        dtype=jnp.float32, **kw))
    params = _drawn(jm.init, jnp.zeros((1, 8, 8, 12)), jnp.zeros((1, 25)),
                    jr.RenderOptions(depth_resolution=4,
                                     depth_resolution_importance=4), 4,
                    seed=3 + 2 * lrm_decoder + use_background,
                    method=jm.init_decoder_paths)
    tm = TriplaneVAE(TriplaneVAEConfig(dit2=tdit.DiT2Config(
        dtype=torch.float32, roll_out=roll_out, **DIT2_KW),
        dtype=torch.float32, **kw)).eval()
    tm.load_state_dict(bridge.vae_state_dict(params))
    return jm, {'params': params}, tm


@pytest.mark.parametrize('use_background', [False, True])
def test_lrm_vae_decode_render_and_query(use_background):
    """``TriplaneVAE(lrm_decoder=True)``: ``decode_latent``, a 2-frame
    render of 8² rays (6 + 6 samples, fg/bg with ``use_background``) whose
    ``feature_image`` has JAX's 3 channels, and ``query_points``."""
    jm, v, tm = _vae(True, use_background)
    assert isinstance(tm.osg_decoder, tosg.LRMOSGDecoder)
    lat = _randn((2, 8, 8, 12), 7)
    want = jm.apply(v, jnp.asarray(lat), method=jm.decode_latent)
    with torch.no_grad():
        got = tm.decode_latent(torch.from_numpy(lat))
    close_to_scale(got, want, 1e-4, 'planes')

    planes = _randn((2, 3, 8, 8, 8), 8, 0.5)
    cams = orbit_cameras(2)
    want = jm.apply(v, jnp.asarray(planes), jnp.asarray(cams),
                    jr.RenderOptions(**OPTS), RES, None, method=jm.render)
    with torch.no_grad():
        got = tm.render(torch.from_numpy(planes), torch.from_numpy(cams),
                        tr.RenderOptions(**OPTS), RES)
    assert got['feature_image'].shape == (2, RES, RES, 3)
    for k in ('feature_image', 'image_raw', 'image_depth', 'image_mask'):
        close_to_scale(got[k], want[k], 1e-4, k)

    coords = np.random.default_rng(9).uniform(
        -0.45, 0.45, (2, 40, 3)).astype(np.float32)
    jrgb, jsig = jm.apply(v, jnp.asarray(planes), jnp.asarray(coords), 0.9,
                          method=jm.query_points)
    with torch.no_grad():
        rgb, sigma = tm.query_points(torch.from_numpy(planes),
                                     torch.from_numpy(coords), 0.9)
    close_to_scale(rgb, jrgb, 1e-4, 'query rgb')
    close_to_scale(sigma, jsig, 1e-4, 'query sigma')


def test_lrm_vae_with_background_needs_three_colour_channels():
    """With ``use_background`` and a ``decoder_output_dim`` other than the
    LRM decoder's 3, JAX's render fails on a broadcast in the fg/bg
    composite; the port's raises ``ValueError`` saying why."""
    kw = dict(VAE_KW, lrm_decoder=True, use_background=True)
    jm = JVAE(JVAEConfig(dit2=jdit.DiT2Config(dtype=jnp.float32, **DIT2_KW),
                         dtype=jnp.float32, **kw))
    with pytest.raises(TypeError, match='incompatible shapes'):
        jax.eval_shape(lambda k: jm.init(
            k, jnp.zeros((1, 8, 8, 12)), jnp.zeros((1, 25)),
            jr.RenderOptions(depth_resolution=4,
                             depth_resolution_importance=4), 4,
            method=jm.init_decoder_paths), jax.random.PRNGKey(0))
    tm = TriplaneVAE(TriplaneVAEConfig(
        dit2=tdit.DiT2Config(dtype=torch.float32, **DIT2_KW),
        dtype=torch.float32, **kw))
    planes = torch.zeros((1, 3, 8, 8, 8))
    with pytest.raises(ValueError, match='decoder_output_dim = 8'):
        tm.render(planes, torch.from_numpy(orbit_cameras(1)),
                  tr.RenderOptions(**OPTS), RES)
    rgb, sigma = tm.query_points(planes, torch.zeros((1, 8, 3)), 0.9)
    assert rgb.shape == (1, 8, 3) and sigma.shape == (1, 8, 1)


@pytest.mark.parametrize('route', ['render', 'query_points',
                                   'render_rays_flat', 'fused_osg'])
def test_lrm_vae_refuses_the_fused_route(route):
    """Every ``use_fused_osg=True`` route raises with JAX's message (JAX's
    ``_fused_osg`` asserts), and no kernel is built."""
    jm, v, tm = _vae(True, False)
    planes = _randn((1, 3, 8, 8, 8), 8, 0.5)
    coords = np.zeros((1, 8, 3), np.float32)
    opts = tr.RenderOptions(**OPTS)
    cams = orbit_cameras(1)
    jcalls = {
        'render': lambda: jm.apply(
            v, jnp.asarray(planes), jnp.asarray(cams),
            jr.RenderOptions(**OPTS), RES, None, use_fused_osg=True,
            method=jm.render),
        'query_points': lambda: jm.apply(
            v, jnp.asarray(planes), jnp.asarray(coords), 0.9,
            use_fused_osg=True, method=jm.query_points),
        'render_rays_flat': lambda: jm.apply(
            v, jnp.asarray(planes), jnp.asarray(coords),
            jnp.asarray(coords + 1.0), jr.RenderOptions(**OPTS),
            use_fused_osg=True, method=jm.render_rays_flat),
        'fused_osg': lambda: jm.apply(v, method=jm._fused_osg)}
    tcalls = {
        'render': lambda: tm.render(torch.from_numpy(planes),
                                    torch.from_numpy(cams), opts, RES,
                                    use_fused_osg=True),
        'query_points': lambda: tm.query_points(
            torch.from_numpy(planes), torch.from_numpy(coords), 0.9,
            use_fused_osg=True),
        'render_rays_flat': lambda: tm.render_rays_flat(
            torch.from_numpy(planes), torch.from_numpy(coords),
            torch.from_numpy(coords + 1.0), opts, use_fused_osg=True),
        'fused_osg': tm.fused_osg}
    with pytest.raises(AssertionError, match=FUSED_MSG):
        jcalls[route]()
    with pytest.raises(ValueError, match=FUSED_MSG):
        tcalls[route]()


TINY = dict(encoder_in_channels=10, encoder_ch=8, encoder_ch_mult=(1, 2),
            encoder_res_blocks=1, img_resolution=32, num_views=2,
            ldm_z_channels=4, latent_size=16, patch_size=2, conv_sr_ch=8,
            conv_sr_ch_mult=(1, 2), conv_sr_res_blocks=1, plane_channels=8,
            decoder_output_dim=8, lrm_decoder=True)
TRAIN_DIT2 = dict(tokens_per_plane=64, hidden_size=32, depth=2, num_heads=2)
TRAIN_OPTS = dict(depth_resolution=8, depth_resolution_importance=8,
                  ray_start='auto', ray_end='auto', box_warp=1.0,
                  filter_out_of_bbox=True)
PATCH = 8


def _jax_trainer(use_fused_osg):
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    return JTrainer(
        JVAEConfig(dit2=jdit.DiT2Config(dtype=jnp.float32, **TRAIN_DIT2),
                   dtype=jnp.float32, **TINY),
        JTrainConfig(patch_resolution=PATCH, render_resolution=16,
                     use_fused_osg=use_fused_osg),
        jl.LossConfig(lpips_lambda=0.0),
        render_opts=jr.RenderOptions(**TRAIN_OPTS), mesh=mesh, seed=0)


def _port_trainer(use_fused_osg):
    return VAETrainer(
        TriplaneVAEConfig(dit2=tdit.DiT2Config(dtype=torch.float32,
                                               **TRAIN_DIT2),
                          dtype=torch.float32, **TINY),
        VAETrainConfig(patch_resolution=PATCH, render_resolution=16,
                       use_fused_osg=use_fused_osg),
        tl.LossConfig(lpips_lambda=0.0),
        render_opts=tr.RenderOptions(**TRAIN_OPTS), seed=0, device='cpu')


@functools.lru_cache(maxsize=None)
def _jax_lrm_step():
    """JAX's loss and grads of one step of the LRM VAE (the plain point
    pipeline), and the draws of its key."""
    trainer = _jax_trainer(False)
    raw = jsyn.make_multiview_batch(2, 32, 16, seed=0)
    init_opts = dataclasses.replace(trainer.render_opts, depth_resolution=8,
                                    depth_resolution_importance=8)
    params = _drawn(trainer.model.init,
                    jnp.asarray(raw['img_to_encoder']), jnp.asarray(raw['c']),
                    init_opts, 8, jax.random.PRNGKey(0), seed=11)
    batch = trainer.prepare_batch(raw)
    batch['step'] = jnp.asarray(7.0, jnp.float32)
    key = jax.random.PRNGKey(7)
    step = jax.jit(jax.value_and_grad(trainer._loss_fn, has_aux=True))
    (loss, _), grads = step(params, None, batch, key)
    # JAX's own grads with every param scaled by 1 + 1e-7
    _, twin = step(jax.tree_util.tree_map(lambda p: p * (1 + 1e-7), params),
                   None, batch, key)
    k_vae, k_render = jax.random.split(key)
    k_strat, k_imp = jax.random.split(k_render)
    R, S = PATCH**2, TRAIN_OPTS['depth_resolution']
    draws = TrainDraws(
        _t(jax.random.normal(k_vae, (1, 16, 16, 4, 3))),
        tr.RenderDraws(
            _t(jax.random.uniform(k_strat, (2, R, S, 1))),
            _t(jax.random.uniform(
                k_imp, (2 * R, TRAIN_OPTS['depth_resolution_importance'])))))
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(params=np_tree(params), loss=float(loss),
                grads=np_tree(grads), twin=np_tree(twin), draws=draws,
                patch=(np.asarray(batch['patch_h']),
                       np.asarray(batch['patch_w'])))


def test_lrm_vae_training_step_matches_jax():
    """One ``VAETrainer`` step of the LRM VAE with ``use_fused_osg=False``
    from JAX's params and draws: the loss, and every grad (the LRM
    decoder's ``Dense_i`` among them, each non-zero).

    ReLU's grad steps at 0, and some of the decoder's pre-activations lie
    within the planes' f32 roundoff of 0 (2e-7 to 4e-6 against values of
    order 1): a sum in another order flips one, and every grad upstream of
    the planes moves by up to about 1e-3 of its scale.  JAX's own grads
    move as much when its params are scaled by 1 + 1e-7 (its twin).  So
    each grad is held to 1e-4 of its scale or twice the twin's move,
    whichever is larger, and the twin's move must stay under 5e-3 of
    scale."""
    want = _jax_lrm_step()
    trainer = _port_trainer(False)
    trainer.model.load_state_dict(bridge.vae_state_dict(want['params']))
    batch = trainer.prepare_batch(tsyn.make_multiview_batch(2, 32, 16,
                                                            seed=0))
    batch['step'] = 7.0
    assert np.array_equal(batch['patch_h'].numpy(), want['patch'][0])
    assert np.array_equal(batch['patch_w'].numpy(), want['patch'][1])
    loss, _ = trainer.loss_fn(batch, draws=want['draws'])
    assert abs(loss.item() - want['loss']) <= 1e-5 * abs(want['loss'])
    loss.backward()
    want_grads = bridge.vae_state_dict(want['grads'])
    twin = bridge.vae_state_dict(want['twin'])
    params = dict(trainer.model.named_parameters())
    assert sorted(want_grads) == sorted(params)
    floor = 1e-6 * max(float(g.abs().max()) for g in want_grads.values())
    for k, p in params.items():
        w = want_grads[k]
        scale = float(w.abs().max())
        move = float((twin[k] - w).abs().max())
        assert move <= max(5e-3 * scale, floor), k
        np.testing.assert_allclose(
            _np(p.grad), _np(w), rtol=0, err_msg=k,
            atol=max(1e-4 * scale, floor, 2 * move))
    for i in range(4):
        assert params[f'osg_decoder.Dense_{i}.weight'].grad.abs().max() > 0


def test_lrm_vae_training_refuses_the_fused_route():
    """With ``use_fused_osg=True`` the step raises in both trainers."""
    trainer = _jax_trainer(True)
    raw = jsyn.make_multiview_batch(2, 32, 16, seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_lrm_step()['params'])
    batch = trainer.prepare_batch(raw)
    batch['step'] = jnp.asarray(7.0, jnp.float32)
    with pytest.raises(AssertionError, match=FUSED_MSG):
        jax.eval_shape(trainer._loss_fn, params, None, batch,
                       jax.random.PRNGKey(7))
    port = _port_trainer(True)
    batch = port.prepare_batch(tsyn.make_multiview_batch(2, 32, 16, seed=0))
    with pytest.raises(ValueError, match=FUSED_MSG):
        port.train_step(batch, generator=torch.Generator().manual_seed(0))


# -- DiT2 without roll-out ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_dit2(roll_out):
    """JAX's DiT2 params, output and grads (of Σ out·w for a fixed w,
    w.r.t. the params and c) at ``roll_out``."""
    jm = jdit.DiT2(jdit.DiT2Config(dtype=jnp.float32, roll_out=roll_out,
                                   **DIT2_KW))
    c = _randn((2, 48, 32), 3)
    w = _randn((2, 48, 32), 4)
    params = _drawn(jm.init, jnp.asarray(c), seed=5)

    def f(p, c):
        return jnp.sum(jm.apply({'params': p}, c) * w)

    out = jm.apply({'params': params}, jnp.asarray(c))
    gp, gc = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(c))
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(params=np_tree(params), c=c, w=w, out=np.asarray(out),
                grads=bridge._convert(np_tree(gp), {('blocks',): 'blocks'}),
                grad_c=np.asarray(gc))


def _port_dit2(roll_out, remat_policy=None):
    want = _jax_dit2(roll_out)
    tm = tdit.DiT2(tdit.DiT2Config(
        dtype=torch.float32, roll_out=roll_out, remat=bool(remat_policy),
        remat_policy=remat_policy or 'full', **DIT2_KW))
    tm.load_state_dict(bridge._convert(want['params'],
                                       {('blocks',): 'blocks'}))
    c = torch.from_numpy(want['c']).requires_grad_(True)
    out = tm(c)
    (out * torch.from_numpy(want['w'])).sum().backward()
    return want, out, c.grad, {k: p.grad for k, p in tm.named_parameters()}


def test_dit2_without_roll_out_matches_jax():
    """``DiT2(roll_out=False)``: every block attends over the 3·16 tokens
    of all planes; the output differs from the roll-out one."""
    want, out, _, _ = _port_dit2(False)
    close_to_scale(out, want['out'], 1e-5)
    rolled = _port_dit2(True)[1]
    assert (out - rolled).abs().max() > 1e-2 * out.abs().max()


@pytest.mark.parametrize('remat_policy', [None, 'full', 'dots'])
@pytest.mark.parametrize('roll_out', [True, False])
def test_dit2_grads_with_and_without_remat(roll_out, remat_policy):
    """The grads w.r.t. the params and c match JAX's within 1e-4 of
    scale, and with remat (either policy) equal those without, bit for
    bit: the recomputation runs the same ops in the same order."""
    want, _, grad_c, grads = _port_dit2(roll_out, remat_policy)
    close_to_scale(grad_c, want['grad_c'], 1e-4, 'c')
    assert sorted(grads) == sorted(want['grads'])
    for k, g in grads.items():
        close_to_scale(g, want['grads'][k], 1e-4, k)
    if remat_policy is not None:
        _, _, base_c, base = _port_dit2(roll_out)
        assert torch.equal(grad_c, base_c)
        for k, g in grads.items():
            assert torch.equal(g, base[k]), k


def test_decode_latent_without_roll_out():
    """``TriplaneVAE.decode_latent`` with DiT2 ``roll_out=False``."""
    jm, v, tm = _vae(False, False, roll_out=False)
    lat = _randn((2, 8, 8, 12), 12)
    want = jm.apply(v, jnp.asarray(lat), method=jm.decode_latent)
    with torch.no_grad():
        got = tm.decode_latent(torch.from_numpy(lat))
    close_to_scale(got, want, 1e-4)


@pytest.mark.parametrize('name', ['DiT2-S/2', 'DiT2-B/2', 'DiT2-B/16',
                                  'DiT2-L/2', 'DiT2-XL/2'])
def test_dit2_registry_matches_jax(name):
    want = dataclasses.asdict(jdit.dit2_registry(name))
    got = dataclasses.asdict(tdit.dit2_registry(name))
    assert got.pop('dtype') == torch.bfloat16
    assert want.pop('dtype') == jnp.bfloat16
    assert got == want


# -- the ControlNet of an int8 U-Net ----------------------------------------

UNET = dict(in_channels=4, model_channels=8, out_channels=4,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=2, use_spatial_transformer=True, context_dim=16,
            roll_out=True)


def test_controlnet_of_an_int8_unet_matches_jax():
    """``ControlNet(cfg)`` with ``cfg.quantized``: the float branch JAX
    builds (equal to the branch of the float config on the same weights),
    its residuals within 1e-5 of JAX's scale, and the int8 U-Net fed them
    against JAX's eager apply."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    hint = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    t = np.array([3.0, 600.0], np.float32)
    ctx = rng.standard_normal((2, 7, 16)).astype(np.float32)
    J = jnp.asarray
    jcfg = junet.UNetConfig(dtype=jnp.float32, quantized=True, **UNET)
    fparams = _drawn(junet.UNetModel(dataclasses.replace(
        jcfg, quantized=False)).init, J(x), J(t), J(ctx), seed=14)
    qmodel = junet.UNetModel(jcfg)
    qshapes = jax.eval_shape(lambda k: qmodel.init(k, J(x), J(t), J(ctx)),
                             jax.random.PRNGKey(0))['params']
    qparams = jax.tree_util.tree_map(
        np.asarray, jint8.quantize_params_like(qshapes, fparams))
    cparams = _drawn(jcn.ControlNet(jcfg).init, J(x), J(hint), J(t), J(ctx),
                     seed=15)
    want = jcn.ControlNet(jcfg).apply({'params': cparams}, J(x), J(hint),
                                      J(t), J(ctx))
    want_out = qmodel.apply({'params': qparams}, J(x), J(t), J(ctx),
                            control=want)

    tcfg = tunet.UNetConfig(dtype=torch.float32, quantized=True, **UNET)
    cn = tcn.ControlNet(tcfg)
    cn.load_state_dict(bridge.controlnet_state_dict(cparams))
    twin = tcn.ControlNet(dataclasses.replace(tcfg, quantized=False))
    twin.load_state_dict(cn.state_dict())
    unet = tunet.UNetModel(tcfg).eval()
    unet.load_state_dict(bridge.unet_state_dict({'params': qparams}))
    args = (_t(x), _t(hint), _t(t), _t(ctx))
    with torch.no_grad():
        got = cn(*args)
        again = twin(*args)
        got_out = unet(_t(x), _t(t), _t(ctx), control=got)
    assert len(got) == len(want) == len(again)
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a), i
        close_to_scale(g.permute(0, 2, 3, 1), w, 1e-5, f'control {i}')
    got_out, want_out = _np(got_out), _np(want_out)
    scale = max(1.0, float(np.abs(want_out).max()))
    np.testing.assert_allclose(got_out, want_out, atol=1e-2 * scale, rtol=0)
    assert np.median(np.abs(got_out - want_out)) <= 1e-5 * scale


# -- configuration tables and dtype fields ------------------------------------

def test_render_preset_sr_matches_jax():
    assert tconfig.RENDER_PRESET_SR == jconfig.RENDER_PRESET_SR
    assert set(tconfig.RENDER_PRESET_SR) <= set(tconfig.RENDER_PRESETS)


def _small_t23d_kw(text_dtype):
    from ln3diff_tpu_torch.conditioning.clip import CLIPTextConfig
    return dict(
        den_cfg=tdit.DiTConfig(input_size=8, hidden_size=32, depth=2,
                               num_heads=2, context_dim=32,
                               dtype=torch.float32),
        vae_cfg=TriplaneVAEConfig(
            latent_size=8, dit2=tdit.DiT2Config(dtype=torch.float32,
                                                **DIT2_KW),
            conv_sr_ch=8, conv_sr_ch_mult=(1, 2), dtype=torch.float32),
        text_cfg=CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2,
                                intermediate_size=64, dtype=text_dtype))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_clip_text_dtype_is_the_towers(dtype):
    """``CLIPTextConfig.dtype`` (JAX's compute dtype; f32 by default in
    both): the builder stores the text tower in it, and it encodes."""
    from ln3diff_tpu_torch.conditioning import clip as tclip
    from ln3diff_tpu.conditioning import clip as jclip
    from ln3diff_tpu_torch.pipeline import build_t23d_pipeline
    assert tclip.CLIPTextConfig().dtype == torch.float32
    assert jclip.CLIPTextConfig().dtype == jnp.float32
    assert tclip.CLIPVisionConfig().dtype == torch.float32
    _, encode, modules = build_t23d_pipeline('cpu', **_small_t23d_kw(dtype))
    assert {p.dtype for p in modules['text_model'].parameters()} == {dtype}
    cond, uncond = encode('a chair')
    assert cond['crossattn'].dtype == dtype
    assert torch.isfinite(cond['crossattn'].float()).all()


def test_clip_vision_dtype_is_the_towers():
    """``CLIPVisionConfig.dtype``: the image→3D builder stores the CLIP
    vision tower in it."""
    from ln3diff_tpu_torch.conditioning.clip import CLIPVisionConfig
    from ln3diff_tpu_torch.models.vit import vit_registry
    from ln3diff_tpu_torch.pipeline import build_i23d_pipeline
    kw = _small_t23d_kw(torch.float32)
    kw.pop('text_cfg')
    kw['den_cfg'] = dataclasses.replace(
        kw['den_cfg'], variant='image-pixelart', context_dim=32,
        pooled_vector_dim=32, dino_dim=32, t2i_final=True)
    _, _, modules = build_i23d_pipeline(
        'cpu', vision_cfg=CLIPVisionConfig(
            image_size=28, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, dtype=torch.bfloat16),
        dino_cfg=vit_registry('dinov2-s/14', img_size=28, embed_dim=32,
                              depth=2, num_heads=2, dtype=torch.float32),
        **kw)
    assert {p.dtype for p in modules['vision_model'].parameters()} == {
        torch.bfloat16}


def test_autoencoder_dtype_is_the_vaes():
    """``AutoencoderConfig.dtype``: the VAE sets it to its own dtype, as
    JAX's ``setup`` does, and ``cast_decoder`` stores ``conv_sr`` in it;
    the parameters are built in f32."""
    from ln3diff_tpu.models import sd_vae as jsd
    from ln3diff_tpu_torch.models import sd_vae as tsd
    assert tsd.AutoencoderConfig().dtype == torch.float32
    assert jsd.AutoencoderConfig().dtype == jnp.float32
    vae = TriplaneVAE(TriplaneVAEConfig(
        latent_size=8, dit2=tdit.DiT2Config(**DIT2_KW), conv_sr_ch=8,
        conv_sr_ch_mult=(1, 2), dtype=torch.bfloat16), encoder=True)
    assert vae.encoder.encoder.cfg.dtype == torch.bfloat16
    assert vae.conv_sr.cfg.dtype == torch.bfloat16
    assert vae.conv_sr.conv_in.weight.dtype == torch.float32
    vae.cast_decoder()
    assert {p.dtype for p in vae.conv_sr.parameters()} == {torch.bfloat16}
    assert vae.osg_decoder.EqualDense_0.weight.dtype == torch.float32
