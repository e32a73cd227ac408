"""The port's fused triplane point pipeline against the JAX package.

``osg_pointwise_reference`` (the plain PyTorch version of the CUDA kernel)
is held against ``ln3diff_tpu.ops.fused_render``: against its jnp
reference for f32 rows, and against the Pallas kernel in interpret mode
for bf16 rows, whose lerp both run in bf16.  The wrapper's input checks
are exercised on meta tensors, which are neither CPU nor CUDA.  Kernel
launches themselves need the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.ops import fused_render as jfr
from ln3diff_tpu_torch.ops import fused_render as tfr


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
