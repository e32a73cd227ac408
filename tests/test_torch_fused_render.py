"""The port's fused triplane point pipeline against the JAX package.

``osg_pointwise_reference`` (the plain PyTorch version of the CUDA kernel)
is held against ``ln3diff_tpu.ops.fused_render``: against its jnp
reference for f32 rows, and against the Pallas kernel in interpret mode
for bf16 rows, whose lerp both run in bf16.  The wrapper's input checks
are exercised on meta tensors, which are neither CPU nor CUDA.  Kernel
launches themselves need the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import os
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.ops import fused_render as jfr
from ln3diff_tpu_torch.ops import fused_render as tfr

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _inputs(M=300, C=32, seed=0, with_inbox=True):
    rng = np.random.default_rng(seed)
    return dict(
        rows=rng.standard_normal((3, M, 4 * C)).astype(np.float32),
        tx=rng.uniform(0, 1, (3, M)).astype(np.float32),
        ty=rng.uniform(0, 1, (3, M)).astype(np.float32),
        live=(rng.uniform(0, 1, (3, M)) > 0.1).astype(np.float32),
        w1=(rng.standard_normal((C, 64)) * 0.2).astype(np.float32),
        b1=(rng.standard_normal(64) * 0.1).astype(np.float32),
        w2=(rng.standard_normal((64, 33)) * 0.2).astype(np.float32),
        b2=(rng.standard_normal(33) * 0.1).astype(np.float32),
        inbox=((rng.uniform(0, 1, M) > 0.3).astype(np.float32)
               if with_inbox else None))


def _run_torch(d, activation, rows_dtype=torch.float32):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in d.items()}
    rows = t.pop('rows').to(rows_dtype)
    inbox = t.pop('inbox')
    rgb, sigma = tfr.osg_pointwise_reference(
        rows, t['tx'], t['ty'], t['live'], t['w1'], t['b1'], t['w2'],
        t['b2'], activation=activation, inbox=inbox)
    return rgb.numpy(), sigma.numpy()


@pytest.mark.parametrize('activation', ['sigmoid', 'lrelu'])
@pytest.mark.parametrize('with_inbox', [False, True])
def test_reference_matches_jax_f32(activation, with_inbox):
    """f32 rows: same math, tolerance 1e-5 abs (f32 sum order only)."""
    d = _inputs(with_inbox=with_inbox)
    j = {k: None if v is None else jnp.asarray(v) for k, v in d.items()}
    want_rgb, want_sigma = jfr.osg_pointwise_reference(
        j['rows'], j['tx'], j['ty'], j['live'], j['w1'], j['b1'], j['w2'],
        j['b2'], activation=activation, inbox=j['inbox'])
    rgb, sigma = _run_torch(d, activation)
    np.testing.assert_allclose(rgb, np.asarray(want_rgb), atol=1e-5)
    np.testing.assert_allclose(sigma, np.asarray(want_sigma), atol=1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize('with_inbox', [False, True])
def test_reference_matches_pallas_kernel_bf16(with_inbox):
    """bf16 rows: the plain version repeats the TPU kernel's bf16 lerp.
    Held against the Pallas kernel run in interpret mode (M=700, not a
    multiple of its 1024 tile).  Tolerance 5e-3 abs: XLA on the CPU keeps
    the bf16 lerp's intermediates in f32 where torch rounds each op, so
    single features differ by a bf16 ulp (2^-8 relative) before the MLP
    (measured 8e-4 on rgb, 1.6e-3 on σ)."""
    d = _inputs(M=700, with_inbox=with_inbox, seed=1)
    j = {k: None if v is None else jnp.asarray(v) for k, v in d.items()}
    want_rgb, want_sigma = jfr.osg_pointwise_fused(
        j['rows'].astype(jnp.bfloat16), j['tx'], j['ty'], j['live'],
        j['w1'], j['b1'], j['w2'], j['b2'], interpret=True, inbox=j['inbox'])
    rgb, sigma = _run_torch(d, 'sigmoid', torch.bfloat16)
    np.testing.assert_allclose(rgb, np.asarray(want_rgb), atol=5e-3)
    np.testing.assert_allclose(sigma, np.asarray(want_sigma), atol=5e-3,
                               rtol=1e-6)


def test_bf16_reference_close_to_f32_jax_reference():
    """bf16 rows against the JAX f32-lerp reference (what ``FusedOSG``
    runs off-TPU): the gap is the bf16 rounding of the lerp, bounded at
    2e-2 abs for unit-scale features (measured 1.6e-3 rgb, 5e-3 σ)."""
    d = _inputs(seed=2)
    j = {k: None if v is None else jnp.asarray(v) for k, v in d.items()}
    rows_bf16 = np.asarray(j['rows'].astype(jnp.bfloat16)).astype(np.float32)
    want_rgb, want_sigma = jfr.osg_pointwise_reference(
        jnp.asarray(rows_bf16), j['tx'], j['ty'], j['live'], j['w1'],
        j['b1'], j['w2'], j['b2'], inbox=j['inbox'])
    rgb, sigma = _run_torch(d, 'sigmoid', torch.bfloat16)
    np.testing.assert_allclose(rgb, np.asarray(want_rgb), atol=2e-2)
    np.testing.assert_allclose(sigma, np.asarray(want_sigma), atol=2e-2,
                               rtol=1e-6)


def test_fused_osg_from_params_matches_jax():
    """EqualDense folding: the port's OSGDecoder state → the same
    matrices as JAX's ``fused_osg_from_params``, and FusedOSG on CPU
    tensors equals the plain version over a batch."""
    from ln3diff_tpu.models.osg_decoder import OSGDecoder as JOSG
    from ln3diff_tpu_torch.bridge import vae_state_dict
    from ln3diff_tpu_torch.models.osg_decoder import OSGDecoder

    jdec = JOSG(decoder_output_dim=32, decoder_lr_mul=0.5)
    params = jdec.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, 3, 4, 32)))['params']
    want = jfr.fused_osg_from_params(params, lr_multiplier=0.5)
    dec = OSGDecoder(32, 32, decoder_lr_mul=0.5)
    sd = vae_state_dict({'osg_decoder': jax.tree_util.tree_map(
        np.asarray, params)})
    dec.load_state_dict({k.split('.', 1)[1]: v for k, v in sd.items()})
    got = tfr.fused_osg_from_params(dec.state_dict(), lr_multiplier=0.5)
    for name in ('w1', 'b1', 'w2', 'b2'):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-7)

    d = _inputs(M=50, seed=3)
    rows = torch.from_numpy(np.stack([d['rows'], d['rows'][::-1].copy()]))
    tx = torch.from_numpy(np.stack([d['tx'], d['ty']]))
    inbox = torch.from_numpy(np.stack([d['inbox'], 1 - d['inbox']]))
    live = torch.ones_like(tx)
    rgb, sigma = got(rows, tx, tx, live, inbox=inbox)
    assert rgb.shape == (2, 50, 32) and sigma.shape == (2, 50, 1)
    for b in range(2):
        r, s = tfr.osg_pointwise_reference(
            rows[b], tx[b], tx[b], live[b], got.w1, got.b1, got.w2, got.b2,
            inbox=inbox[b])
        torch.testing.assert_close(rgb[b], r, rtol=0, atol=0)
        torch.testing.assert_close(sigma[b], s, rtol=0, atol=0)


def _meta_args(M=64, rows_dtype=torch.bfloat16, C=32):
    m = dict(device='meta')
    return [torch.empty((3, M, 4 * C), dtype=rows_dtype, **m),
            torch.empty((3, M), **m), torch.empty((3, M), **m),
            torch.empty((3, M), **m), torch.empty((C, 64), **m),
            torch.empty((64,), **m), torch.empty((64, 33), **m),
            torch.empty((33,), **m)]


@pytest.mark.parametrize('bad', [
    'rows_shape', 'rows_dtype', 'tx_dtype', 'w1_shape', 'b2_shape',
    'inbox_shape', 'noncontiguous', 'activation', 'mixed_device'])
def test_wrapper_rejects_bad_input(bad):
    """Non-CPU tensors go through the checks and never to the plain
    version; each bad input raises ValueError before any build or launch."""
    args = _meta_args()
    kw = {}
    if bad == 'rows_shape':
        args[0] = torch.empty((3, 64, 96), dtype=torch.bfloat16,
                              device='meta')
    elif bad == 'rows_dtype':
        args[0] = args[0].to(torch.float16)
    elif bad == 'tx_dtype':
        args[1] = args[1].to(torch.bfloat16)
    elif bad == 'w1_shape':
        args[4] = torch.empty((16, 64), device='meta')
    elif bad == 'b2_shape':
        args[7] = torch.empty((32,), device='meta')
    elif bad == 'inbox_shape':
        kw['inbox'] = torch.empty((63,), device='meta')
    elif bad == 'noncontiguous':
        args[1] = torch.empty((64, 3), device='meta').t()
    elif bad == 'activation':
        kw['activation'] = 'relu'
    elif bad == 'mixed_device':
        args[4] = torch.zeros((32, 64))
    with pytest.raises(ValueError):
        tfr.osg_pointwise_fused(*args, **kw)


def test_wrapper_never_falls_back_off_cpu():
    """Well-formed tensors that are not on the CPU must reach the kernel
    or raise — here, on a device that is not CUDA, they raise."""
    before = tfr.FusedOSG.launches
    with pytest.raises(ValueError, match='CPU or CUDA'):
        tfr.osg_pointwise_fused(*_meta_args())
    assert tfr.FusedOSG.launches == before


def test_cpu_tensors_use_plain_version_without_counting():
    d = _inputs(M=20, seed=4)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    before = tfr.FusedOSG.launches
    got = tfr.osg_pointwise_fused(t['rows'], t['tx'], t['ty'], t['live'],
                                  t['w1'], t['b1'], t['w2'], t['b2'],
                                  inbox=t['inbox'])
    want = tfr.osg_pointwise_reference(t['rows'], t['tx'], t['ty'],
                                       t['live'], t['w1'], t['b1'], t['w2'],
                                       t['b2'], inbox=t['inbox'])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tfr.FusedOSG.launches == before


# -- the backward kernel's plain version --------------------------------------

BWD_NAMES = ('grows', 'gtx', 'gty', 'glive', 'ginbox', 'gw1', 'gb1', 'gw2',
             'gb2')


def _cotangents(M, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, 32)).astype(np.float32),
            rng.standard_normal((M, 1)).astype(np.float32))


def _torch_backward(d, g_rgb, g_sigma, activation, rows_dtype):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in d.items()}
    return tfr.osg_pointwise_backward_reference(
        t['rows'].to(rows_dtype), t['tx'], t['ty'], t['live'], t['w1'],
        t['b1'], t['w2'], t['b2'], torch.from_numpy(g_rgb),
        torch.from_numpy(g_sigma), activation=activation, inbox=t['inbox'])


def _pallas_backward(d, g_rgb, g_sigma, activation, rows_dtype):
    """JAX's backward kernel, the Pallas kernel in interpret mode, with a
    128-point tile (M = 300 leaves a padded tail)."""
    j = {k: None if v is None else jnp.asarray(v) for k, v in d.items()}
    return jfr._osg_backward(
        j['rows'].astype(rows_dtype), j['tx'], j['ty'], j['live'], j['w1'],
        j['b1'], j['w2'], j['b2'], j['inbox'], jnp.asarray(g_rgb),
        jnp.asarray(g_sigma), activation, True, 128)


def _close_to_scale(name, got, want, rel):
    """|Δ| <= rel · max|want| (the tolerance of the JAX package's own
    backward test, ``tests/test_fused_render.py``)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize('activation', ['sigmoid', 'lrelu'])
@pytest.mark.parametrize('with_inbox', [False, True])
def test_backward_reference_matches_pallas_kernel_f32(activation,
                                                      with_inbox):
    """f32 rows: all nine outputs of the plain backward against the Pallas
    backward kernel in interpret mode, to 1e-5 of each output's scale
    (f32 sum order only)."""
    d = _inputs(M=300, with_inbox=with_inbox, seed=6)
    g_rgb, g_sigma = _cotangents(300)
    got = _torch_backward(d, g_rgb, g_sigma, activation, torch.float32)
    want = _pallas_backward(d, g_rgb, g_sigma, activation, jnp.float32)
    for name, a, b in zip(BWD_NAMES, got, want):
        if name == 'ginbox' and not with_inbox:
            assert a is None and b is None
            continue
        assert a.dtype == torch.float32, name
        _close_to_scale(name, a, b, 1e-5)


@pytest.mark.parametrize('activation', ['sigmoid', 'lrelu'])
@pytest.mark.parametrize('with_inbox', [False, True])
def test_backward_reference_matches_jax_grad_f32(activation, with_inbox):
    """f32 rows: the plain backward equals ``jax.grad`` of JAX's plain
    forward for every input, the inbox mask included, to 1e-5 of scale."""
    d = _inputs(M=300, with_inbox=with_inbox, seed=7)
    g_rgb, g_sigma = _cotangents(300, seed=8)
    j = {k: None if v is None else jnp.asarray(v) for k, v in d.items()}
    names = ['rows', 'tx', 'ty', 'live', 'w1', 'b1', 'w2', 'b2']
    if with_inbox:
        names.append('inbox')

    def loss(*args):
        kw = dict(zip(names, args))
        rgb, sig = jfr.osg_pointwise_reference(
            kw['rows'], kw['tx'], kw['ty'], kw['live'], kw['w1'],
            kw['b1'], kw['w2'], kw['b2'], activation=activation,
            inbox=kw.get('inbox'))
        return jnp.sum(rgb * g_rgb) + jnp.sum(sig * g_sigma)

    want = jax.grad(loss, argnums=tuple(range(len(names))))(
        *(j[n] for n in names))
    got = dict(zip(BWD_NAMES, _torch_backward(d, g_rgb, g_sigma, activation,
                                              torch.float32)))
    got.update(rows=got.pop('grows'), tx=got.pop('gtx'), ty=got.pop('gty'),
               live=got.pop('glive'), inbox=got.pop('ginbox'),
               w1=got.pop('gw1'), b1=got.pop('gb1'), w2=got.pop('gw2'),
               b2=got.pop('gb2'))
    for name, w in zip(names, want):
        _close_to_scale(name, got[name], w, 1e-5)


@pytest.mark.parametrize('with_inbox', [False, True])
def test_backward_reference_matches_pallas_kernel_bf16(with_inbox):
    """bf16 rows: the row grads come out in bf16, as ``w_k · round(g_f)``.
    Held against the Pallas backward in interpret mode to 1e-2 of scale
    (measured 4.3e-3 on the row grads, 2.2e-3 on gw1): XLA on the CPU
    keeps the recomputed bf16 lerp in f32 where torch rounds each op (the
    forward's gap), and a g_f that moves by that much may round to the
    neighbouring bf16 value (2^-8 relative).  The f32 outputs are held to
    the same bound.  Sigmoid only: lrelu's derivative jumps at 0, so the
    lerp gap flips it for points near the kink (1.1e-1 measured on the
    row grads), which is the precision split itself, not an error."""
    d = _inputs(M=300, with_inbox=with_inbox, seed=9)
    g_rgb, g_sigma = _cotangents(300, seed=10)
    got = _torch_backward(d, g_rgb, g_sigma, 'sigmoid', torch.bfloat16)
    want = _pallas_backward(d, g_rgb, g_sigma, 'sigmoid', jnp.bfloat16)
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    for name, a, b in zip(BWD_NAMES, got, want):
        if name == 'ginbox' and not with_inbox:
            continue
        _close_to_scale(name, a, b, 1e-2)


def test_backward_wrapper_uses_plain_version_on_cpu():
    """``osg_pointwise_backward`` on CPU tensors is the plain version and
    counts no launch; off the CPU it checks its inputs first."""
    d = _inputs(M=40, seed=11)
    g_rgb, g_sigma = _cotangents(40)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    args = (t['rows'], t['tx'], t['ty'], t['live'], t['w1'], t['b1'],
            t['w2'], t['b2'], torch.from_numpy(g_rgb),
            torch.from_numpy(g_sigma))
    before = tfr.FusedOSG.backward_launches
    got = tfr.osg_pointwise_backward(*args, inbox=t['inbox'])
    want = tfr.osg_pointwise_backward_reference(*args, inbox=t['inbox'])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tfr.FusedOSG.backward_launches == before
    meta = _meta_args()
    with pytest.raises(ValueError, match='g_rgb'):
        tfr.osg_pointwise_backward(
            *meta, torch.empty((63, 32), device='meta'),
            torch.empty((64, 1), device='meta'))


def test_fused_osg_grads_reach_the_osg_decoder():
    """The detach fix: ``TriplaneVAE.fused_osg()`` folds the EqualDense
    parameters themselves, so a render with ``use_fused_osg=True`` under
    autograd gives the OSG decoder's weights the same non-zero grads as
    the plain decoder path (CPU: both run plain PyTorch)."""
    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
    from ln3diff_tpu_torch.render.camera import orbit_cameras
    from ln3diff_tpu_torch.render.renderer import RenderOptions

    cfg = TriplaneVAEConfig(latent_size=8, dit2=DiT2Config(
        tokens_per_plane=16, hidden_size=32, depth=2, num_heads=2,
        dtype=torch.float32), conv_sr_ch=8, conv_sr_ch_mult=(1, 2),
        plane_channels=8, decoder_output_dim=8)
    vae = TriplaneVAE(cfg)
    random_init_(vae, torch.Generator().manual_seed(0))
    planes = torch.randn((1, 3, 8, 8, 8),
                         generator=torch.Generator().manual_seed(1))
    cams = torch.as_tensor(orbit_cameras(1))
    opts = RenderOptions(depth_resolution=6, depth_resolution_importance=6,
                         filter_out_of_bbox=True)
    grads = {}
    for fused in (False, True):
        vae.zero_grad()
        out = vae.render(planes, cams, opts, 6, use_fused_osg=fused)
        out['image_raw'].square().mean().backward()
        grads[fused] = {k: p.grad.clone() for k, p in
                        vae.osg_decoder.named_parameters()}
    for k, g in grads[True].items():
        assert float(g.abs().max()) > 0, k
        torch.testing.assert_close(g, grads[False][k], rtol=1e-4,
                                   atol=1e-6 * float(g.abs().max()))
