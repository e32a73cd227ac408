"""The port's W8A8 int8 U-Net (``ops/int8.py`` ``Int8Conv`` and
``quantize_unet``, ``UNetConfig.quantized``) against
``ln3diff_tpu/ops/int8.py`` and the quantized JAX U-Net.

* ``Int8Conv``: the weight's ``kernel_q`` and ``scale``, the per-sample
  int8 activations and the int32 sums equal JAX's bit for bit (3x3
  'SAME', the Downsample's 3x3 stride 2 with (1, 1) padding, 1x1, fewer
  than 17 rows; batch 2 with different amax per sample); the output
  within 1e-6 of scale (the f32 rescale only).
* The quantized toy U-Net of ``tests/test_int8.py``: ``quantize_unet``
  equals the bridge's copy of JAX's quantized tree bit for bit, float and
  int8 leaves split as JAX splits them; the output all within 1e-2 of
  JAX's scale and half within 1e-5 (an activation within an f32 ulp of a
  rounding midpoint quantizes one int8 step apart on the two sides, as
  for the int8 DiT); within 0.15 relative of the port's bf16 U-Net, the
  bound of ``tests/test_int8.py``.
* A 4-step DDIM call of the ShapeNet and FFHQ families with the int8
  U-Net at toy size against JAX's (``tests/test_torch_unet_families.py``
  with ``quantize_unet`` on both sides): latents, planes and frames
  within 5e-2 of scale.  JAX's call runs its U-Net inside the sampler's
  jitted scan, where XLA fuses it otherwise than alone; a float sum an
  ulp apart puts an activation at a rounding midpoint one int8 step away,
  and the toy U-Net (4² latents) and the four steps spread the flip over
  every element (1.9e-2 of scale on the ShapeNet toy's latents).  So the
  latents are also held within 1e-4 of the port's sampler run over JAX's
  jitted int8 U-Net one call per step (7e-7 of scale on the CPU).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models import unet as junet
from ln3diff_tpu.ops import int8 as jint8
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import unet as tunet
from ln3diff_tpu_torch.models.layers import random_init_
from ln3diff_tpu_torch.ops import int8 as tint8

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _close(got, want, rel, median_rel=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)
    if median_rel is not None:
        assert np.median(np.abs(got - want)) <= median_rel * scale


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- Int8Conv ---------------------------------------------------------------

CONVS = {
    # (kernel, stride, JAX padding, port padding, B, H, W)
    'same_3x3': (3, 1, 'SAME', 1, 2, 8, 12),
    'downsample_3x3_s2': (3, 2, ((1, 1), (1, 1)), 1, 2, 8, 8),
    'skip_1x1': (1, 1, 'SAME', 0, 2, 4, 6),
    'few_rows_3x3': (3, 1, 'SAME', 1, 1, 3, 4),
}


@pytest.mark.parametrize('case', sorted(CONVS))
def test_int8_conv_matches_jax_bit_for_bit(case):
    k, s, jpad, tpad, B, H, W = CONVS[case]
    cin, cout = 24, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    x[1:] *= 7.0                         # another amax per sample
    w = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)

    # the weight: JAX's conv layout (kh, kw, in, out), all_but_last
    jq, js = jint8.quantize_weight(jnp.asarray(w), all_but_last=True)
    conv = tint8.Int8Conv(cin, cout, k, stride=s, padding=tpad)
    conv.load_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    conv.bias.copy_(torch.from_numpy(b))
    np.testing.assert_array_equal(conv.kernel_q.numpy(),
                                  np.asarray(jq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(conv.scale.numpy(), np.asarray(js))
    assert conv.kernel_q.dtype == torch.int8

    # the activations, as Int8Conv.__call__ quantizes them, and the sums
    xf = jnp.asarray(x)
    amax = jnp.max(jnp.abs(xf), axis=(1, 2, 3), keepdims=True)
    jx_scale = jnp.maximum(amax, 1e-12) / 127.0
    jx_q = jnp.clip(jnp.round(xf / jx_scale), -127, 127).astype(jnp.int8)
    jacc = jax.lax.conv_general_dilated(
        jx_q, jq, window_strides=(s, s), padding=jpad,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32)
    tx_q, tx_scale = tint8.quantize_per_sample(torch.from_numpy(x))
    np.testing.assert_array_equal(tx_q.numpy(), np.asarray(jx_q))
    np.testing.assert_array_equal(tx_scale.numpy(), np.asarray(jx_scale))
    tacc = tint8.int8_conv_acc(tx_q, conv.kernel_q, s, tpad)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))

    # the layer: NCHW-shaped channels-last in and out
    jconv = jint8.Int8Conv(cout, (k, k), strides=(s, s), padding=jpad,
                           dtype=jnp.float32)
    want = jconv.apply({'params': {'kernel_q': jq, 'scale': js,
                                   'bias': jnp.asarray(b)}}, xf)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = conv(xt.contiguous(memory_format=torch.channels_last))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.dtype == torch.float32
    _close(got.permute(0, 2, 3, 1), want, 1e-6)
    # the same layer on NCHW memory
    _close(conv(xt.contiguous()).permute(0, 2, 3, 1), want, 1e-6)


def test_int8_conv_zero_padding_and_bf16():
    """Zero padding quantizes to exact 0 (the borders are unaffected by
    the per-sample scale), and a bf16 input gives a bf16 output with the
    scale and bias kept f32."""
    conv = tint8.Int8Conv(8, 8, 3, padding=1).load_weight(
        torch.randn(8, 8, 3, 3, generator=torch.Generator().manual_seed(0)))
    conv.to(torch.bfloat16)
    assert conv.scale.dtype == conv.bias.dtype == torch.float32
    x = torch.zeros(1, 8, 5, 5, dtype=torch.bfloat16)
    x[0, :, 2, 2] = 3.0
    y = conv(x)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 8, 5, 5)
    # only the 3x3 neighbourhood of the one lit pixel is reached
    assert torch.count_nonzero(y[0, :, [0, 4]]) == 0
    assert torch.count_nonzero(y[0, :, :, [0, 4]]) == 0


# -- the quantized toy U-Net of tests/test_int8.py -------------------------

UNET_KW = dict(in_channels=4, model_channels=16, out_channels=4,
               num_res_blocks=1, attention_resolutions=(2,),
               channel_mult=(1, 2), num_heads=2, context_dim=16,
               roll_out=True)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    t = np.array([3, 70], np.int32)
    ctx = rng.standard_normal((2, 7, 16)).astype(np.float32)
    return x, t, ctx


@functools.lru_cache(maxsize=None)
def _jax_unets():
    """JAX's f32 toy U-Net with every leaf drawn with numpy in the shapes
    of its init (zero-init output convs would make the output exactly 0)
    and its quantized twin, as numpy trees."""
    from test_torch_unet_families import _params
    x, t, ctx = (jnp.asarray(a) for a in _inputs())
    cfg = junet.UNetConfig(dtype=jnp.float32, **UNET_KW)
    model = junet.UNetModel(cfg)
    params = _params(model.init, x, t, ctx, seed=3)['params']
    # quantize_params_like eagerly: JAX's quantize_unet jits it, and XLA
    # folds the amax / 127 into a product with 1/127, one f32 ulp off
    # the eager scale now and then
    qmodel = junet.UNetModel(dataclasses.replace(cfg, quantized=True))
    q_struct = jax.eval_shape(lambda k: qmodel.init(k, x, t, ctx),
                              jax.random.PRNGKey(2))
    q_params = jint8.quantize_params_like(q_struct['params'], params)
    return model, {'params': params}, qmodel, \
        {'params': jax.tree_util.tree_map(np.asarray, q_params)}


def _port(quantized, dtype=torch.float32):
    return tunet.UNetModel(tunet.UNetConfig(
        dtype=dtype, quantized=quantized, **UNET_KW)).eval()


def test_quantize_unet_equals_jax_tree():
    """``quantize_unet`` of the port's float U-Net holds the bridge's copy
    of JAX's quantized tree bit for bit, and the leaves split as JAX's:
    ResBlock, resampling and attention convs and the transformer's layers
    int8; conv_in, conv_out, the time MLP, the ResBlocks' emb_proj and
    the mixing logit float."""
    _, fv, _, qv = _jax_unets()
    sd = bridge.unet_state_dict(qv)
    plain = _port(False)
    plain.load_state_dict(bridge.unet_state_dict(fv))
    q = tint8.quantize_unet(plain)
    assert q.cfg.quantized and not plain.cfg.quantized
    qsd = q.state_dict()
    assert set(qsd) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(qsd[k].numpy(), v.numpy(), err_msg=k)
    jconv = qv['params']['down_0_res_0']['in_conv']
    assert sd['down_0_res_0.in_conv.kernel_q'].dtype == torch.int8
    assert sd['down_0_res_0.in_conv.scale'].shape == (16,)
    np.testing.assert_array_equal(
        sd['down_0_res_0.in_conv.kernel_q'].numpy(),
        jconv['kernel_q'].transpose(3, 2, 0, 1))
    convs = {n for n, m in q.named_modules()
             if isinstance(m, tint8.Int8Conv)}
    linears = {n for n, m in q.named_modules()
               if isinstance(m, tint8.Int8Linear)}
    assert 'down_0_downsample.op' in convs and 'up_1_upsample.conv' in convs
    assert 'down_0_res_0.out_conv' in convs and 'up_0_res_0.skip' in convs
    assert {'down_1_attn_0.proj_in', 'down_1_attn_0.proj_out'} <= convs
    assert {'mid_attn.block_0.attn2_k', 'mid_attn.block_0.ff_proj',
            'mid_attn.block_0.ff_out'} <= linears
    floats = {n for n, m in q.named_modules()
              if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
    assert floats == {'conv_in', 'conv_out', 'time_fc1', 'time_fc2'} | {
        n for n in floats if n.endswith('.emb_proj')}
    assert len(floats) == 4 + sum(n.endswith('.emb_proj') for n in floats)
    np.testing.assert_array_equal(q.mixing_logit.detach().numpy(),
                                  fv['params']['mixing_logit'])


def test_quantized_unet_matches_jax():
    _, _, qmodel, qv = _jax_unets()
    q = _port(True)
    q.load_state_dict(bridge.unet_state_dict(qv))
    x, t, ctx = _inputs(seed=5)
    # eager, as test_torch_int8.py holds the int8 DiT: XLA's fusions move
    # float sums by an ulp here and there, and an activation at a rounding
    # midpoint then quantizes one int8 step apart (3e-2 of scale through
    # this U-Net under jit, with or without the algebraic simplifier)
    want = qmodel.apply(qv, jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(ctx))
    with torch.no_grad():
        got = q(torch.from_numpy(x), torch.from_numpy(t).long(),
                torch.from_numpy(ctx))
    assert got.shape == (2, 8, 8, 12) and got.dtype == torch.float32
    _close(got, want, 1e-2, median_rel=1e-5)


def test_quantized_unet_within_bound_of_bf16():
    """``tests/test_int8.py``'s bound on the port's side: the int8 U-Net's
    output within 0.15 relative of the bf16 U-Net's."""
    _, fv, _, _ = _jax_unets()
    plain = _port(False)
    plain.load_state_dict(bridge.unet_state_dict(fv))
    plain = plain.to(torch.bfloat16)
    q = tint8.quantize_unet(plain)
    assert q.down_0_res_0.in_conv.kernel_q.dtype == torch.int8
    assert q.conv_in.weight.dtype == torch.bfloat16
    x, t, ctx = _inputs()
    with torch.no_grad():
        args = (torch.from_numpy(x), torch.from_numpy(t).long(),
                torch.from_numpy(ctx))
        y_ref, y_q = plain(*args), q(*args)
    assert torch.isfinite(y_q).all()
    assert _rel(y_q, y_ref) < 0.15


def test_random_init_quantizes_the_float_draw():
    """``random_init_`` of the int8 U-Net holds the int8 form of its float
    twin's draw from the same seed, convs included."""
    plain, q = _port(False), _port(True)
    random_init_(plain, torch.Generator().manual_seed(0))
    random_init_(q, torch.Generator().manual_seed(0))
    want = tint8.quantize_unet(plain).state_dict()
    for k, v in q.state_dict().items():
        assert torch.equal(v, want[k]), k


# -- the ShapeNet and FFHQ calls with the int8 U-Net -----------------------

@pytest.mark.parametrize('family', ['shapenet', 'ffhq'])
def test_int8_family_call_matches_jax(family):
    from test_torch_pipeline import _jax_noise
    from test_torch_unet_families import FAMILIES, UNET_KW as FAM_KW
    from test_torch_unet_families import _family
    from ln3diff_tpu_torch.config import CAMERA_PRESETS
    from ln3diff_tpu_torch.render.camera import orbit_cameras
    jpipe, tpipe, jctx, tctx, hw = _family(family, quantized=True)
    sr = FAMILIES[family]['sr']
    q = tpipe.denoiser_fn
    assert isinstance(q.down_0_res_0.in_conv, tint8.Int8Conv)
    cams = orbit_cameras(2, **CAMERA_PRESETS[family])
    key = jax.random.PRNGKey(11)
    want = jpipe(key, *jctx, batch=1, cameras=jnp.asarray(cams))
    noise = torch.from_numpy(np.array(_jax_noise(key, (1, hw, hw, 12))))
    got = tpipe(*tctx, batch=1, cameras=cams, render_resolution=8,
                x_init=noise)
    assert got['latents'].shape == (1, hw, hw, 12)
    assert got['video'].shape == (1, 2, sr, sr, 3)
    for key_ in ('latents', 'planes', 'video'):
        _close(got[key_], want[key_], 5e-2)
    # step by step: the port's sampler over JAX's jitted int8 U-Net (one
    # call per step, outside the sampler's scan) gives the port's latents
    apply = jax.jit(junet.UNetModel(junet.UNetConfig(
        dtype=jnp.float32, quantized=True, **FAM_KW)).apply)

    def jax_unet(x, t, ctx):
        return torch.from_numpy(np.array(apply(
            jpipe.denoiser_params, jnp.asarray(x.numpy()),
            jnp.asarray(t.numpy()), jnp.asarray(ctx['crossattn'].numpy()))))
    jax_unet.cfg = q.cfg
    try:
        tpipe.denoiser_fn = jax_unet
        stepped = tpipe.sample_latents(1, *tctx, x_init=noise)
    finally:
        tpipe.denoiser_fn = q
    _close(got['latents'], stepped, 1e-4)
