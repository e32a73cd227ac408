"""The port's W8A8 int8 serving (``ln3diff_tpu_torch/ops/int8.py``,
``DiTConfig.quantized``) against ``ln3diff_tpu/ops/int8.py``.

* ``quantize_weight`` in its three layouts, ``_quantize_rows`` and the
  int8 operands of ``int8_dense`` / ``Int8Linear`` equal JAX's bit for
  bit; the dense output within f32 rounding of the rescale (1e-6 of
  scale).
* ``quantize_dit`` of every DiT variant equals the bridge's copy of
  JAX's quantized tree (``quantize_params_like``) bit for bit.  The
  quantized DiT's output, f32 on both sides, has half its elements within
  1e-5 of JAX's scale and all within 1e-2: an activation within an f32
  ulp of a rounding midpoint quantizes one int8 step apart on the two
  sides, which moves that row's product by 1/127 of its amax times a
  weight and spreads through the attention (over 15 draws of the five
  variants, 7 had such a flip, the largest 5.8e-3 of scale).
* The bounds that ``tests/test_int8.py`` pins against bf16, on the port's
  side: 0.02 per dense, 0.10 for the 2-block DiT, 0.25 on the latents of
  a 250-step CFG DDIM call and a 25 dB render PSNR.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.ops import int8 as jint8
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models.layers import random_init_
from ln3diff_tpu_torch.ops import int8 as tint8

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

B = 2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0)


@pytest.mark.parametrize('shape,conv', [((64, 32), False),
                                        ((3, 16, 8), False),
                                        ((3, 3, 16, 12), True)],
                         ids=['dense', 'stacked', 'conv'])
def test_quantize_weight_bit_for_bit(shape, conv):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.3) \
        .astype(np.float32)
    jq, js = jint8.quantize_weight(jnp.asarray(w), all_but_last=conv)
    tq, ts = tint8.quantize_weight(torch.from_numpy(w), all_but_last=conv)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_rows_bit_for_bit():
    x = np.random.default_rng(1).standard_normal((4, 9, 40)) \
        .astype(np.float32)
    x[0, 0] *= 1000.0
    x[1, 2] = 0.0                       # the 1e-12 floor
    jq, js = jint8._quantize_rows(jnp.asarray(x))
    tq, ts = tint8._quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_round_half_to_even():
    """Both sides round .5 to even, as ``jnp.round`` does."""
    w = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32).T
    tq, _ = tint8.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq[:, 0].numpy(), [0, 2, 2, 0, -2, 127])


@pytest.mark.parametrize('bias', [True, False])
def test_int8_dense_and_linear_match_jax(bias):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 24, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 64)) * 0.1).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32) if bias else None
    jq, js = jint8.quantize_weight(jnp.asarray(w))
    want = jint8.int8_dense(jnp.asarray(x), jq, js,
                            None if b is None else jnp.asarray(b),
                            dtype=jnp.float32)
    kq = torch.from_numpy(np.asarray(jq).T.copy())
    got = tint8.int8_dense(torch.from_numpy(x), kq,
                           torch.from_numpy(np.array(js)),
                           None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)
    # the drop-in, through Linen's Int8Dense with the same leaves
    jd = jint8.Int8Dense(64, use_bias=bias, dtype=jnp.float32)
    params = {'kernel_q': jq, 'scale': js}
    if bias:
        params['bias'] = jnp.asarray(b)
    want = jd.apply({'params': params}, jnp.asarray(x))
    q = tint8.Int8Linear(128, 64, bias=bias).load_weight(
        torch.from_numpy(w.T))
    if bias:
        q.bias.copy_(torch.from_numpy(b))
    np.testing.assert_array_equal(q.kernel_q.numpy(), np.asarray(jq).T)
    _close(q(torch.from_numpy(x)), want, 1e-6)


def test_int8_linear_keeps_f32_scales_under_a_cast():
    """``Module.to(bf16)`` casts the model; the int8 layer's scale and
    bias stay f32 and its output follows the input's dtype."""
    q = tint8.Int8Linear(16, 8).load_weight(torch.randn(8, 16))
    q.to(torch.bfloat16)
    assert q.kernel_q.dtype == torch.int8
    assert q.scale.dtype == q.bias.dtype == torch.float32
    y = q(torch.randn(3, 16, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (3, 8)


def test_int8_matmul_is_exact_on_the_cpu():
    """On the CPU ``_int_mm`` takes any shape and sums exactly in int32
    (the card's shape rules are held by ``tests/test_torch_gpu.py``)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 36), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (36, 20), dtype=np.int8))
    np.testing.assert_array_equal(tint8.int8_matmul(a, b).numpy(),
                                  a.numpy().astype(np.int64)
                                  @ b.numpy().astype(np.int64))


# -- the quantized DiT ----------------------------------------------------

CTX, VEC, DINO = 24, 16, 20
VARIANTS = {
    'text': (dict(context_dim=CTX), dict(crossattn=(B, 7, CTX))),
    'pixelart-text': (dict(context_dim=CTX, pooled_vector_dim=VEC,
                           t2i_final=True),
                      dict(crossattn=(B, 7, CTX), vector=(B, VEC))),
    'image-pixelart': (dict(context_dim=CTX, pooled_vector_dim=VEC,
                            dino_dim=DINO, t2i_final=True),
                       dict(crossattn=(B, 5, CTX), vector=(B, VEC),
                            dino=(B, 9, DINO))),
    'image-pixelart-noclip': (dict(dino_dim=DINO), dict(dino=(B, 9, DINO))),
    'mv-pixelart': (dict(context_dim=CTX), dict(concat=(B, 3, 5, CTX))),
}


def _kw(variant, **over):
    kw = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
              depth=2, num_heads=4, exact_gelu=False, variant=variant,
              **VARIANTS[variant][0])
    kw.update(over)
    return kw


def _inputs(variant, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 8, 8, 12)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in VARIANTS[variant][1].items()}
    return x, t, ctx


def _j(ctx):
    return {k: jnp.asarray(v) for k, v in ctx.items()}


def _tt(ctx):
    return {k: torch.from_numpy(v) for k, v in ctx.items()}


@functools.lru_cache(maxsize=None)
def _jax_models(variant):
    """JAX's f32 DiT with every leaf moved off its (partly zero) init and
    its quantized twin (``quantize_params_like``), as numpy trees."""
    x, t, ctx = _inputs(variant)
    cfg = jdit.DiTConfig(dtype=jnp.float32, **_kw(variant))
    m = jdit.DiT_TriLatent(cfg)
    v = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(t), _j(ctx))
    rng = np.random.default_rng(10)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(p.shape))
        .astype(np.float32), v['params'])
    qm = jdit.DiT_TriLatent(dataclasses.replace(cfg, quantized=True))
    q_struct = jax.eval_shape(
        lambda k: qm.init(k, jnp.asarray(x), jnp.asarray(t), _j(ctx)),
        jax.random.PRNGKey(2))
    q_params = jax.tree_util.tree_map(np.asarray, jint8.quantize_params_like(
        q_struct['params'], params))
    consts = jax.tree_util.tree_map(np.asarray, v['constants'])
    return (m, {'params': params, 'constants': consts},
            qm, {'params': q_params, 'constants': consts})


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_quantized_dit_matches_jax(variant):
    _, fv, qm, qv = _jax_models(variant)
    sd = bridge.dit_state_dict(qv)
    # the bridge's int8 leaves: int8 (out, in) and a per-out f32 scale,
    # split out of the scan-stacked (depth, in, out) / (depth, out)
    jqkv = qv['params']['blocks']['block']['attn']['qkv']
    assert sd['blocks.1.attn.qkv.kernel_q'].dtype == torch.int8
    np.testing.assert_array_equal(sd['blocks.1.attn.qkv.kernel_q'].numpy(),
                                  jqkv['kernel_q'][1].T)
    assert sd['blocks.1.attn.qkv.scale'].dtype == torch.float32
    np.testing.assert_array_equal(sd['blocks.1.attn.qkv.scale'].numpy(),
                                  jqkv['scale'][1])
    # quantize_dit of the float twin gives the same state
    plain = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32,
                                              **_kw(variant))).eval()
    plain.load_state_dict(bridge.dit_state_dict(fv))
    q = tint8.quantize_dit(plain)
    assert q.cfg.quantized and not plain.cfg.quantized
    qsd = q.state_dict()
    assert set(qsd) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(qsd[k].numpy(), v.numpy(), err_msg=k)
    names = {n for n, mod in q.named_modules()
             if isinstance(mod, tint8.Int8Linear)}
    per_block = {n.split('.', 2)[2] for n in names}
    want = {'attn.qkv', 'attn.proj', 'mlp.fc1', 'mlp.fc2'}
    if variant != 'image-pixelart-noclip':
        want |= {'cross_attn.to_q', 'cross_attn.to_k', 'cross_attn.to_v',
                 'cross_attn.to_out'}
    assert per_block == want and all(n.startswith('blocks.') for n in names)
    # strict load of JAX's quantized tree, then the outputs
    tq = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32,
                                           quantized=True,
                                           **_kw(variant))).eval()
    tq.load_state_dict(sd)
    x, t, ctx = _inputs(variant, seed=3)
    want_y = qm.apply(qv, jnp.asarray(x), jnp.asarray(t), _j(ctx))
    with torch.no_grad():
        got = tq(torch.from_numpy(x), torch.from_numpy(t).long(), _tt(ctx))
    _close(got, want_y, 1e-2)
    want_y = np.asarray(want_y, np.float64)
    scale = max(1.0, float(np.abs(want_y).max()))
    assert np.median(np.abs(got.numpy() - want_y)) <= 1e-5 * scale


def test_quantized_fused_attention_feeds_kernel_3():
    """``quantized`` with ``fused_attention``: the int8 qkv projection
    feeds the fused attention (its plain version on the CPU), equal to
    the plain attention of the same int8 model."""
    _, _, qm, qv = _jax_models('image-pixelart')
    sd = bridge.dit_state_dict(qv)
    outs = []
    for fused in (False, True):
        m = tdit.DiT_TriLatent(tdit.DiTConfig(
            dtype=torch.float32, quantized=True,
            **_kw('image-pixelart', fused_attention=fused))).eval()
        m.load_state_dict(sd)
        x, t, ctx = _inputs('image-pixelart', seed=4)
        with torch.no_grad():
            outs.append(m(torch.from_numpy(x), torch.from_numpy(t).long(),
                          _tt(ctx)))
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=1e-5)


def test_random_init_quantizes_the_float_draw():
    """A quantized model drawn by ``random_init_`` holds the int8 form of
    its float twin's draw from the same seed."""
    plain = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32,
                                              **_kw('text')))
    q = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32,
                                          quantized=True, **_kw('text')))
    random_init_(plain, torch.Generator().manual_seed(0))
    random_init_(q, torch.Generator().manual_seed(0))
    want = tint8.quantize_dit(plain).state_dict()
    for k, v in q.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_quantize_params_like_rejects_a_mismatched_state():
    q = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32,
                                          quantized=True, **_kw('text')))
    with pytest.raises(ValueError, match='mismatch'):
        tint8.quantize_params_like(q.state_dict(), {})


# -- tests/test_int8.py's bounds against bf16, on the port's side ----------

def test_int8_dense_within_two_percent_of_exact():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 96, 128))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 64)) * 0.1)
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    wq, s = tint8.quantize_weight(w)
    y = tint8.int8_dense(x, wq.t().contiguous(), s, b)
    assert _rel(y, x @ w + b) < 0.02
    # per-token scales keep an outlier row from poisoning the others
    x = torch.ones((8, 32))
    x[0] *= 1000.0
    w = torch.from_numpy((np.random.default_rng(3).standard_normal((32, 16))
                          * 0.2).astype(np.float32))
    wq, s = tint8.quantize_weight(w)
    y = tint8.int8_dense(x, wq.t().contiguous(), s).numpy()
    ref = (x @ w).numpy()
    rel = np.linalg.norm(y - ref, axis=1) / np.linalg.norm(ref, axis=1)
    assert rel.max() < 0.02, rel


@functools.lru_cache(maxsize=None)
def _bf16_pair(input_size=8):
    """The 2-block text DiT of ``tests/test_int8.py`` in bf16 with JAX's
    perturbed weights, and its ``quantize_dit`` twin."""
    kw = _kw('text', input_size=input_size)
    m = jdit.DiT_TriLatent(jdit.DiTConfig(dtype=jnp.float32, **kw))
    x = jnp.zeros((B, input_size, input_size, 12))
    v = jax.jit(m.init)(jax.random.PRNGKey(2), x, jnp.zeros((B,)),
                        {'crossattn': jnp.zeros((B, 7, CTX))})
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(p.shape))
        .astype(np.float32), v['params'])
    plain = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32,
                                              **kw)).eval()
    plain.load_state_dict(bridge.dit_state_dict({'params': params}))
    plain = plain.to(torch.bfloat16)
    return plain, tint8.quantize_dit(plain)


def test_quantized_dit_within_ten_percent_of_bf16():
    plain, q = _bf16_pair()
    x, t, ctx = _inputs('text')
    with torch.no_grad():
        args = (torch.from_numpy(x), torch.from_numpy(t).long(), _tt(ctx))
        y_ref, y_q = plain(*args), q(*args)
    assert q.blocks[0].attn.qkv.kernel_q.dtype == torch.int8
    assert q.t_embedder.fc1.weight.dtype == torch.bfloat16
    assert torch.isfinite(y_q).all()
    assert _rel(y_q, y_ref) < 0.10


def test_sampled_call_within_bounds_of_bf16():
    """250 compounded W8A8 CFG-DDIM steps (cfg 6.5, 16² latents): the
    latents within 0.25 of bf16's, and their renders through one small
    f32 VAE within 25 dB PSNR."""
    from ln3diff_tpu_torch.diffusion.gaussian import make_diffusion
    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
    from ln3diff_tpu_torch.pipeline import SamplerSpec, TextTo3DPipeline
    from ln3diff_tpu_torch.render.camera import orbit_cameras
    from ln3diff_tpu_torch.render.renderer import RenderOptions

    plain, q = _bf16_pair(16)
    ctx = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 7, CTX)).astype(np.float32))
    noise = torch.randn((1, 16, 16, 12),
                        generator=torch.Generator().manual_seed(9))

    def latents(model):
        pipe = TextTo3DPipeline(
            model, None, None, None, device='cpu',
            sampler=SamplerSpec(kind='ddim', num_steps=250, cfg_scale=6.5,
                                latent_shape=(16, 16, 12)),
            diffusion=make_diffusion(timestep_respacing='ddim250'))
        return pipe.sample_latents(1, {'crossattn': ctx},
                                   {'crossattn': torch.zeros_like(ctx)},
                                   x_init=noise)

    a, b = latents(plain), latents(q)
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    assert _rel(b, a) < 0.25
    vae = TriplaneVAE(TriplaneVAEConfig(
        latent_size=16, dit2=DiT2Config(tokens_per_plane=64, hidden_size=32,
                                        depth=2, num_heads=2,
                                        dtype=torch.float32),
        conv_sr_ch=8, conv_sr_ch_mult=(1, 2), plane_channels=8,
        decoder_output_dim=8, dtype=torch.float32))
    random_init_(vae, torch.Generator().manual_seed(4))
    opts = RenderOptions(depth_resolution=6, depth_resolution_importance=6,
                         box_warp=0.9, filter_out_of_bbox=True,
                         deterministic=True)
    cam = torch.from_numpy(orbit_cameras(1, 1.8, 30.0, 20.0)).float()
    with torch.no_grad():
        img_a, img_b = (vae.render(vae.decode_latent(lat), cam, opts,
                                   16)['image_raw'] for lat in (a, b))
    mse = float(((img_a - img_b) ** 2).mean())
    assert 10.0 * np.log10(4.0 / max(mse, 1e-12)) > 25.0
