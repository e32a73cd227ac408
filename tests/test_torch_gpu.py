"""CUDA kernels of the port against their plain PyTorch versions, on the
card.  Marked ``gpu``; each test skips inside itself when no CUDA device is
present.  This file imports neither JAX nor the JAX package, so it runs on
the card's machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)
"""

import os
import pytest
import torch

from ln3diff_tpu_torch.ops.fused_attention import (
    FusedAttention, FusedQKVAttention, attention_reference, fused_attention,
    fused_qkv_attention, qkv_attention_reference, split_qkv_weights)
from ln3diff_tpu_torch.ops.fused_render import (
    FusedOSG, osg_pointwise_backward, osg_pointwise_backward_reference,
    osg_pointwise_fused, osg_pointwise_reference)

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

# |Δ| <= atol + rtol·|plain|: f32 rows differ only in the order of the f32
# MLP sums; bf16 rows lerp in bf16 on both sides in the same rounding order
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    # the plain versions' f32 matmuls in full f32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _inputs(M, rows_dtype, with_inbox, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    rows = torch.randn((3, M, 128), generator=g, device=device)
    args = [rows.to(rows_dtype),
            torch.rand((3, M), generator=g, device=device),
            torch.rand((3, M), generator=g, device=device),
            (torch.rand((3, M), generator=g, device=device) > 0.05).float(),
            torch.randn((32, 64), generator=g, device=device) / 32**0.5,
            torch.randn((64,), generator=g, device=device) * 0.1,
            torch.randn((64, 33), generator=g, device=device) / 8,
            torch.randn((33,), generator=g, device=device) * 0.1]
    inbox = ((torch.rand((M,), generator=g, device=device) > 0.2).float()
             if with_inbox else None)
    return args, inbox


@pytest.mark.parametrize('rows_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('with_inbox', [False, True])
@pytest.mark.parametrize('activation', ['sigmoid', 'lrelu'])
@pytest.mark.parametrize('M', [1, 64, 2**16 + 3])
def test_fused_osg_matches_plain(cuda, rows_dtype, with_inbox, activation,
                                 M):
    args, inbox = _inputs(M, rows_dtype, with_inbox, cuda)
    before = FusedOSG.launches
    rgb, sigma = osg_pointwise_fused(*args, activation=activation,
                                     inbox=inbox)
    torch.cuda.synchronize()
    assert FusedOSG.launches == before + 1
    want_rgb, want_sigma = osg_pointwise_reference(
        *args, activation=activation, inbox=inbox)
    atol, rtol = TOL[rows_dtype]
    torch.testing.assert_close(rgb, want_rgb, atol=atol, rtol=rtol)
    torch.testing.assert_close(sigma, want_sigma, atol=atol, rtol=rtol)


def test_fused_osg_batched_wrapper(cuda):
    """FusedOSG over a batch of two: one launch per batch element."""
    args, _ = _inputs(1000, torch.bfloat16, False, cuda)
    rows, tx, ty, live = (torch.stack([a, a.flip(1)]) for a in args[:4])
    fused = FusedOSG(*args[4:])
    before = FusedOSG.launches
    rgb, sigma = fused(rows, tx, ty, live)
    torch.cuda.synchronize()
    assert FusedOSG.launches == before + 2
    for b in range(2):
        want_rgb, want_sigma = osg_pointwise_reference(
            rows[b], tx[b], ty[b], live[b], *args[4:])
        torch.testing.assert_close(rgb[b], want_rgb, atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(sigma[b], want_sigma, atol=1e-2,
                                   rtol=1e-2)


# -- the backward kernel (kernel 2) ------------------------------------------

BWD_NAMES = ('grows', 'gtx', 'gty', 'glive', 'ginbox', 'gw1', 'gb1', 'gw2',
             'gb2')


def _bwd_close(name, got, want, rows_dtype):
    """|Δ| <= atol·max|plain| + rtol·|plain|.  Per-point f32 outputs: the
    f32 MLP sums run in another order (1e-5 of scale, 1e-4 relative).
    grows in bf16: w_k·round(g_f) rounds to bf16 on both sides, and a g_f
    a few f32 ulps away may round to the neighbouring bf16 value (one ulp
    is at most 2^-7 relative), which moves the rounded product by up to
    two of its ulps (2^-6 relative).  Weight grads: sums over all M points
    in another order (1e-4 of scale)."""
    if name.startswith(('gw', 'gb')):
        atol, rtol = 1e-4, 1e-4
    elif name == 'grows' and rows_dtype == torch.bfloat16:
        atol, rtol = 1e-5, 2e-2
    else:
        atol, rtol = 1e-5, 1e-4
    assert got.dtype == want.dtype and got.shape == want.shape, name
    scale = float(want.float().abs().max()) or 1.0
    torch.testing.assert_close(got.float(), want.float(),
                               atol=atol * scale, rtol=rtol, msg=name)


def _cotangents(M, device, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((M, 32), generator=g, device=device),
            torch.randn((M, 1), generator=g, device=device))


@pytest.mark.parametrize('rows_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('with_inbox', [False, True])
@pytest.mark.parametrize('activation', ['sigmoid', 'lrelu'])
@pytest.mark.parametrize('M', [1, 1001, 2**16])
def test_fused_osg_backward_matches_plain(cuda, rows_dtype, with_inbox,
                                          activation, M):
    """Kernel 2's nine outputs against its plain version (a ragged M, one
    point, the training shape M = 64·32²)."""
    args, inbox = _inputs(M, rows_dtype, with_inbox, cuda)
    g_rgb, g_sigma = _cotangents(M, cuda)
    before = FusedOSG.backward_launches
    got = osg_pointwise_backward(*args, g_rgb, g_sigma,
                                 activation=activation, inbox=inbox)
    torch.cuda.synchronize()
    assert FusedOSG.backward_launches == before + 1
    want = osg_pointwise_backward_reference(*args, g_rgb, g_sigma,
                                            activation=activation,
                                            inbox=inbox)
    for name, a, b in zip(BWD_NAMES, got, want):
        if name == 'ginbox' and not with_inbox:
            assert a is None and b is None
            continue
        _bwd_close(name, a, b, rows_dtype)


def test_fused_osg_backward_is_deterministic(cuda):
    """The weight grads are reduced in a fixed order: two launches agree
    bit for bit."""
    args, inbox = _inputs(50_000, torch.bfloat16, True, cuda)
    g_rgb, g_sigma = _cotangents(50_000, cuda)
    a = osg_pointwise_backward(*args, g_rgb, g_sigma, inbox=inbox)
    b = osg_pointwise_backward(*args, g_rgb, g_sigma, inbox=inbox)
    for name, x, y in zip(BWD_NAMES, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize('with_inbox', [False, True])
def test_fused_osg_autograd_matches_reference_autograd(cuda, with_inbox):
    """In f32, autograd through the kernel pair (forward kernel 1,
    backward kernel 2) gives autograd's grads of the plain forward, for
    every input; one launch of each kernel."""
    M = 5000
    args, inbox = _inputs(M, torch.float32, with_inbox, cuda)
    g_rgb, g_sigma = _cotangents(M, cuda)
    leaves = [a.clone().requires_grad_() for a in args]
    box = None if inbox is None else inbox.clone().requires_grad_()
    fwd, bwd = FusedOSG.launches, FusedOSG.backward_launches
    rgb, sigma = osg_pointwise_fused(*leaves, inbox=box)
    ((rgb * g_rgb).sum() + (sigma * g_sigma).sum()).backward()
    torch.cuda.synchronize()
    assert (FusedOSG.launches, FusedOSG.backward_launches) == (fwd + 1,
                                                               bwd + 1)
    ref_leaves = [a.clone().requires_grad_() for a in args]
    ref_box = None if inbox is None else inbox.clone().requires_grad_()
    rgb_r, sigma_r = osg_pointwise_reference(*ref_leaves, inbox=ref_box)
    ((rgb_r * g_rgb).sum() + (sigma_r * g_sigma).sum()).backward()
    names = ['rows', 'tx', 'ty', 'live', 'w1', 'b1', 'w2', 'b2']
    pairs = list(zip(names, leaves, ref_leaves))
    if with_inbox:
        pairs.append(('inbox', box, ref_box))
    for name, a, b in pairs:
        kind = 'gw' if name[0] in 'wb' else name
        _bwd_close(kind, a.grad, b.grad, torch.float32)


# -- kernels 1 and 2 around their tiles and rings ----------------------------

# point counts around the 64-point tiles, the forward's bf16 ring of three
# tiles, one pass of a 132-block grid and the training launch; M % 4 takes
# every value (the planes of tx, ty, live start k·M·4 bytes in)
OSG_EDGES = [1, 15, 63, 64, 65, 66, 127, 128, 129, 191, 193, 8447, 8449,
             65536, 65553]
# both row types, the fold on and off and both activations, each pair of
# values in one case (scripts/osg_card_check.py runs all eight at each M)
OSG_VARIANTS = [(torch.bfloat16, True, 'sigmoid'),
                (torch.bfloat16, False, 'lrelu'),
                (torch.float32, True, 'lrelu'),
                (torch.float32, False, 'sigmoid')]


def _near_lrelu_kink(args):
    """Colour pre-activations within 1e-5 of 0 in the plain forward, where
    lrelu' jumps: the kernel sums its f32 products in another order, so
    there it may take either side, and either derivative is right."""
    ref = osg_pointwise_reference(*args, activation='lrelu')[0]
    return ref.abs() <= 1e-5


@pytest.mark.parametrize('rows_dtype,with_inbox,activation', OSG_VARIANTS)
@pytest.mark.parametrize('M', OSG_EDGES)
def test_fused_osg_tile_edges(cuda, rows_dtype, with_inbox, activation, M):
    """Kernel 1 against its plain version around its tiles and ring (the
    ragged last tile is copied and stored only up to M); two launches
    equal bit for bit."""
    args, inbox = _inputs(M, rows_dtype, with_inbox, cuda, seed=M)
    got = osg_pointwise_fused(*args, activation=activation, inbox=inbox)
    again = osg_pointwise_fused(*args, activation=activation, inbox=inbox)
    torch.cuda.synchronize()
    want = osg_pointwise_reference(*args, activation=activation,
                                   inbox=inbox)
    atol, rtol = TOL[rows_dtype]
    for a, b, c in zip(got, want, again):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)
        assert torch.equal(a, c)


@pytest.mark.parametrize('rows_dtype,with_inbox,activation', OSG_VARIANTS)
@pytest.mark.parametrize('M', OSG_EDGES)
def test_fused_osg_backward_tile_edges(cuda, rows_dtype, with_inbox,
                                       activation, M):
    """Kernel 2's nine outputs against its plain version around its tiles
    and ring, and on persistent blocks that take one or several tiles;
    two launches equal bit for bit.  With lrelu, a colour whose
    pre-activation lies within 1e-5 of 0 gets a zero cotangent in both
    runs (``_near_lrelu_kink``)."""
    args, inbox = _inputs(M, rows_dtype, with_inbox, cuda, seed=M)
    g_rgb, g_sigma = _cotangents(M, cuda, seed=M + 1)
    if activation == 'lrelu':
        g_rgb = g_rgb.masked_fill(_near_lrelu_kink(args), 0.0)
    got = osg_pointwise_backward(*args, g_rgb, g_sigma,
                                 activation=activation, inbox=inbox)
    again = osg_pointwise_backward(*args, g_rgb, g_sigma,
                                   activation=activation, inbox=inbox)
    torch.cuda.synchronize()
    want = osg_pointwise_backward_reference(*args, g_rgb, g_sigma,
                                            activation=activation,
                                            inbox=inbox)
    for name, a, b, c in zip(BWD_NAMES, got, want, again):
        if name == 'ginbox' and not with_inbox:
            assert a is None and b is None and c is None
            continue
        _bwd_close(name, a, b, rows_dtype)
        assert torch.equal(a, c), name


def test_fused_osg_backward_takes_a_misaligned_cotangent(cuda):
    """Kernel 2 bulk-copies g_rgb: through autograd, a cotangent view that
    starts mid-row is copied first; the public entry raises on it."""
    M = 1000
    args, inbox = _inputs(M, torch.float32, True, cuda)
    g = torch.randn((M * 32 + 1,), device=cuda)
    g_rgb = g[1:].view(M, 32)
    g_sigma = torch.randn((M, 1), device=cuda)
    with pytest.raises(ValueError, match='g_rgb must be 16-byte aligned'):
        osg_pointwise_backward(*args, g_rgb, g_sigma, inbox=inbox)
    leaves = [a.clone().requires_grad_() for a in args]
    rgb, sigma = osg_pointwise_fused(*leaves, inbox=inbox)
    torch.autograd.backward((rgb, sigma), (g_rgb, g_sigma))
    want = osg_pointwise_backward_reference(*args, g_rgb.contiguous(),
                                            g_sigma, inbox=inbox)
    _bwd_close('grows', leaves[0].grad, want[0], torch.float32)
    _bwd_close('gw2', leaves[6].grad, want[7], torch.float32)


# -- fused attention ----------------------------------------------------------

# |Δ| <= atol + rtol·|plain|.  f32: the kernel and the plain version sum in
# another order (measured in ulps of f32).  bf16: both round p and o to
# bf16 from f32 values that differ in summation order, so an element may
# land one bf16 ulp away (2^-7 relative at most) and a p one ulp away moves
# o by about 2^-8·p·|v|.
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (4e-3, 1e-2)}


def _qkv(B, L, H, d, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((B, L, H, d), generator=g, device=device).to(dtype)
            for _ in range(3)]


def _attn_close(got, want, dtype):
    atol, rtol = ATTN_TOL[dtype]
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('d', [32, 64])
@pytest.mark.parametrize('L', [1, 64, 77, 768])
@pytest.mark.parametrize('B,H', [(1, 1), (2, 16)])
def test_fused_attention_matches_plain(cuda, dtype, d, L, B, H):
    q, k, v = _qkv(B, L, H, d, dtype, cuda)
    before = FusedAttention.launches
    got = fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert FusedAttention.launches == before + 1
    _attn_close(got, attention_reference(q, k, v), dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_fused_attention_strided_views(cuda, dtype):
    """The thirds of one qkv projection (row stride 3·H·d) and a
    heads-first tensor seen as (B, L, H, d) are read in place."""
    B, L, H, d = 2, 100, 4, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((B, L, 3 * H * d), generator=g, device=cuda).to(dtype)
    q, k, v = (t.reshape(B, L, H, d) for t in qkv.chunk(3, dim=-1))
    assert q.stride(1) == 3 * H * d
    want = attention_reference(q.contiguous(), k.contiguous(),
                               v.contiguous())
    _attn_close(fused_attention(q, k, v), want, dtype)
    heads_first = [t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
                   for t in (q, k, v)]
    assert heads_first[0].stride(2) == L * d
    _attn_close(fused_attention(*heads_first), want, dtype)


@pytest.mark.parametrize('d', [32, 64])
@pytest.mark.parametrize('L', [1, 63, 64, 65, 77, 128, 129, 768, 1024, 1025,
                               2048])
def test_fused_attention_bf16_tile_edges(cuda, d, L):
    """The bf16 wgmma kernel around its 64-row query and key tiles (one
    key, a tile less one, one, one more, ragged, the DiT's 768, 1024 and
    the image→3D DiT's 1025 = 768 + 257, whose last query tile holds one
    row, and a long 2048 that streams far past shared memory), against
    the plain version; two launches agree bit for bit."""
    B, H = (2, 16) if L >= 768 else (2, 4)
    q, k, v = _qkv(B, L, H, d, torch.bfloat16, cuda, seed=L + d)
    got = fused_attention(q, k, v)
    again = fused_attention(q, k, v)
    torch.cuda.synchronize()
    _attn_close(got, attention_reference(q, k, v), torch.bfloat16)
    assert torch.equal(got, again)


def test_fused_attention_is_deterministic(cuda):
    """No atomics and no split over keys: two launches on the DiT's qkv
    thirds agree bit for bit."""
    B, L, H, d = 2, 768, 16, 64
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn((B, L, 3 * H * d), generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = (t.reshape(B, L, H, d) for t in qkv.chunk(3, dim=-1))
    assert torch.equal(fused_attention(q, k, v), fused_attention(q, k, v))


def test_dit_attention_module_fused_bf16(cuda):
    """A port ``Attention(1024, 16)`` in bf16 with ``fused=True`` runs
    kernel 3 on the thirds of its own qkv projection; its output before
    the out projection equals ``attention_reference`` on those q, k, v."""
    from ln3diff_tpu_torch.models.dit import Attention
    torch.manual_seed(0)
    attn = Attention(1024, 16, fused=True).to(cuda, torch.bfloat16)
    x = torch.randn((2, 768, 1024), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda).to(torch.bfloat16)
    seen = {}
    attn.proj.register_forward_pre_hook(
        lambda module, args: seen.setdefault('heads', args[0]))
    before = FusedAttention.launches
    with torch.no_grad():
        attn(x)
        q, k, v = (t.reshape(2, 768, 16, 64)
                   for t in attn.qkv(x).chunk(3, dim=-1))
        want = attention_reference(q, k, v).reshape(2, 768, 1024)
    assert FusedAttention.launches == before + 1
    _attn_close(seen['heads'], want, torch.bfloat16)


def test_dit_attention_qk_norm_dino_concat_fused_bf16(cuda):
    """The image→3D DiT's self-attention in bf16: ``Attention(1024, 16,
    qk_norm=True)`` over 768 latent tokens and 257 DINO tokens (L = 1025),
    with ``fused=True`` against the same weights with ``fused=False``;
    kernel 3 runs once, on the RMS-normalised q and k and on v read in
    place from the qkv projection, and equals the plain version on those
    q, k, v."""
    from ln3diff_tpu_torch.models.dit import Attention
    torch.manual_seed(0)
    fused = Attention(1024, 16, qk_norm=True, fused=True).to(
        cuda, torch.bfloat16)
    plain = Attention(1024, 16, qk_norm=True).to(cuda, torch.bfloat16)
    plain.load_state_dict(fused.state_dict())
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 768, 1024), generator=g, device=cuda)
    dino = torch.randn((2, 257, 1024), generator=g, device=cuda)
    h = torch.cat([x, dino], dim=1).to(torch.bfloat16)
    seen = {}
    fused.proj.register_forward_pre_hook(
        lambda module, args: seen.setdefault('heads', args[0]))
    before = FusedAttention.launches
    with torch.no_grad():
        got = fused(h)[:, :768]
        want = plain(h)[:, :768]
        q, k, v = (t.reshape(2, 1025, 16, 64)
                   for t in fused.qkv(h).chunk(3, dim=-1))
        heads = attention_reference(fused.q_norm(q), fused.k_norm(k), v)
    assert FusedAttention.launches == before + 1
    _attn_close(seen['heads'], heads.reshape(2, 1025, 1024), torch.bfloat16)
    # the plain module's dot_product_attention rounds p as the kernel does;
    # the out projection adds bf16 rounding of sums of 1024 products
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_fused_attention_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 16, 2, 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match='head dim'):
        fused_attention(q, k, v)
    q, k, v = _qkv(1, 16, 2, 64, torch.float16, cuda)
    with pytest.raises(ValueError, match='dtype'):
        fused_attention(q, k, v)
    q, k, v = _qkv(1, 16, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match='dtype'):
        fused_attention(q, k, v.float())


def test_fused_attention_has_no_backward(cuda):
    """Like the JAX kernel, kernel 3 has no backward: with grad mode on, an
    input that requires grad raises instead of cutting the graph; under
    no_grad (serving) it launches."""
    q, k, v = _qkv(1, 16, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(RuntimeError, match='no backward'):
        fused_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        got = fused_attention(q, k, v)
    _attn_close(got, attention_reference(q.detach(), k, v), torch.bfloat16)


# -- fused qkv projection + attention (kernel 4) -------------------------------

# |Δ| <= atol + rtol·|plain|, kernel 3's tolerance: the projection adds f32
# sums of D products in another order (f32: a few ulps of q, k, v; bf16:
# now and then a q, k or v element one bf16 ulp away, which moves o by
# about 2^-8·p·|v|), and the attention is kernel 3's.
QKV_TOL = ATTN_TOL


def _qkv_attention_inputs(B, L, D, H, dtype, device, bias=True, seed=0):
    """x (B, L, D) of unit scale, one qkv projection's (D, 3D) weights of
    scale 1/√D (so q, k, v are of unit scale) and a (3D,) bias of scale
    0.1 or none, split head-major."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, L, D), generator=g, device=device).to(dtype)
    w = (torch.randn((D, 3 * D), generator=g, device=device)
         / D**0.5).to(dtype)
    b = ((0.1 * torch.randn((3 * D,), generator=g, device=device)).to(dtype)
         if bias else None)
    ws, bs = split_qkv_weights(w, b, H)
    return (x, *ws, *bs)


@pytest.mark.parametrize('bias', [True, False])
@pytest.mark.parametrize('B,L,D,H,dtype', [
    (2, 768, 1024, 16, torch.bfloat16),
    (2, 768, 1024, 16, torch.float32),
    (2, 77, 1024, 16, torch.bfloat16),
    (2, 96, 128, 4, torch.bfloat16),
    (1, 200, 512, 8, torch.bfloat16),
], ids=['dit_l2_bf16', 'dit_l2_f32', 'ragged_L77', 'head_dim_32',
        'batch_1'])
def test_fused_qkv_attention_matches_plain(cuda, B, L, D, H, dtype, bias):
    """Kernel 4 against its plain version; one launch of kernel 4 and none
    of kernel 3."""
    args = _qkv_attention_inputs(B, L, D, H, dtype, cuda, bias=bias)
    before = (FusedAttention.launches, FusedQKVAttention.launches)
    got = fused_qkv_attention(*args, num_heads=H)
    torch.cuda.synchronize()
    assert FusedAttention.launches == before[0]
    assert FusedQKVAttention.launches == before[1] + 1
    want = qkv_attention_reference(*args, H)
    atol, rtol = QKV_TOL[dtype]
    assert got.dtype == dtype and got.shape == (B, L, D)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_fused_qkv_attention_is_deterministic(cuda):
    """No atomics: two launches agree bit for bit."""
    args = _qkv_attention_inputs(2, 768, 1024, 16, torch.bfloat16, cuda)
    a = fused_qkv_attention(*args, num_heads=16)
    b = fused_qkv_attention(*args, num_heads=16)
    assert torch.equal(a, b)


def test_fused_qkv_attention_ties_to_the_dit_attention(cuda):
    """A port ``Attention(1024, 16)`` in f32: kernel 4 on its split ``qkv``
    weights equals ``attention_reference`` on the module's own q, k, v."""
    from ln3diff_tpu_torch.models.dit import Attention
    torch.manual_seed(0)
    attn = Attention(1024, 16).to(cuda)
    x = torch.randn((2, 768, 1024), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    with torch.no_grad():
        ws, bs = split_qkv_weights(attn.qkv.weight.T, attn.qkv.bias, 16)
        got = fused_qkv_attention(x, *ws, *bs, num_heads=16)
        q, k, v = (t.reshape(2, 768, 16, 64)
                   for t in attn.qkv(x).chunk(3, dim=-1))
        want = attention_reference(q, k, v).reshape(2, 768, 1024)
    atol, rtol = QKV_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_fused_qkv_attention_rejects_what_it_does_not_take(cuda):
    args = _qkv_attention_inputs(1, 16, 128, 8, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match='head dim'):
        fused_qkv_attention(*args, num_heads=8)
    args = _qkv_attention_inputs(1, 16, 128, 2, torch.float16, cuda)
    with pytest.raises(ValueError, match='dtype'):
        fused_qkv_attention(*args, num_heads=2)
    args = list(_qkv_attention_inputs(1, 16, 128, 2, torch.bfloat16, cuda))
    args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match='contiguous'):
        fused_qkv_attention(*args, num_heads=2)
    args = list(_qkv_attention_inputs(1, 16, 128, 2, torch.bfloat16, cuda))
    args[6] = args[6].float()
    with pytest.raises(ValueError, match='dtype'):
        fused_qkv_attention(*args, num_heads=2)


def test_fused_qkv_attention_has_no_backward(cuda):
    """Like the JAX kernel, kernel 4 has no backward: with grad mode on, an
    input that requires grad raises; under no_grad it launches."""
    args = _qkv_attention_inputs(1, 16, 128, 2, torch.bfloat16, cuda)
    args[1].requires_grad_()
    with pytest.raises(RuntimeError, match='no backward'):
        fused_qkv_attention(*args, num_heads=2)
    with torch.no_grad():
        got = fused_qkv_attention(*args, num_heads=2)
    want = qkv_attention_reference(*(t.detach() for t in args), 2)
    atol, rtol = QKV_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# -- the training slice -------------------------------------------------------

def test_fused_render_grads_match_cpu(cuda):
    """A patch render through the fused kernel pair on the card, under
    autograd: the loss and the grads of the planes and of the OSG
    decoder's EqualDense parameters equal the CPU run's (plain versions),
    in f32; the decoder's weights get non-zero grads."""
    import copy

    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
    from ln3diff_tpu_torch.render.camera import orbit_cameras
    from ln3diff_tpu_torch.render.ray_sampler import (sample_patch_rays,
                                                      unpack_25d_camera)
    from ln3diff_tpu_torch.render.renderer import (RenderDraws,
                                                   RenderOptions,
                                                   draw_uniforms)

    cfg = TriplaneVAEConfig(latent_size=8, dit2=DiT2Config(
        tokens_per_plane=16, hidden_size=32, depth=2, num_heads=2,
        dtype=torch.float32), conv_sr_ch=8, conv_sr_ch_mult=(1, 2))
    vae = TriplaneVAE(cfg)
    random_init_(vae, torch.Generator().manual_seed(0))
    planes = torch.randn((2, 3, 16, 16, 32),
                         generator=torch.Generator().manual_seed(1))
    cams = torch.as_tensor(orbit_cameras(2))
    opts = RenderOptions(depth_resolution=16, depth_resolution_importance=16,
                         filter_out_of_bbox=True)
    draws = draw_uniforms(2, 64, opts, torch.Generator().manual_seed(2),
                          'cpu')
    out = {}
    for dev in ('cpu', cuda):
        m = copy.deepcopy(vae).to(dev)
        p = planes.detach().to(dev).requires_grad_()
        c2w, intr = unpack_25d_camera(cams.to(dev))
        h0 = torch.tensor([3, 9], device=dev)
        ray_o, ray_d = sample_patch_rays(c2w, intr, h0, h0.flip(0), 8, 32)
        d = RenderDraws(*(t.to(dev) for t in draws))
        bwd = FusedOSG.backward_launches
        img = m.render(p, None, opts, 8, use_fused_osg=True,
                       ray_origins=ray_o, ray_directions=ray_d, draws=d)
        loss = sum(v.float().square().mean() for v in img.values())
        loss.backward()
        if dev != 'cpu':
            torch.cuda.synchronize()
            assert FusedOSG.backward_launches == bwd + 4   # 2 views × 2
        out[str(dev)] = dict(loss=loss.detach().cpu(), planes=p.grad.cpu(),
                        **{k: v.grad.cpu() for k, v in
                           m.osg_decoder.named_parameters()})
    for k, want in out['cpu'].items():
        got = out['cuda'][k]
        scale = float(want.abs().max())
        assert scale > 0, k
        torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=1e-3,
                                   msg=k)


# -- mesh stage ---------------------------------------------------------------

def test_native_march_and_obj_write(cuda, tmp_path):
    """The native marcher and OBJ writer build and run on the card's
    machine: a sphere σ field made on the card, its device crossing
    census equal to the host scan, every vertex within one voxel of the
    sphere, colours queried on the card, the OBJ read back."""
    import numpy as np

    from ln3diff_tpu_torch.render import mesh
    g, radius = 64, 0.3
    pts = mesh.grid_points(g, 0.45, device=cuda)
    sigma = (10.0 + (radius - pts.norm(dim=-1)) * 200.0).half()
    grid = sigma.cpu().numpy().reshape(g, g, g).astype(np.float32)
    n_cross = int(mesh.count_crossing_cells(sigma, g))
    assert n_cross == mesh._crossing_cells(grid, 10.0).size > 0
    verts, faces = mesh.march_grid(grid, g)
    assert len(faces) > 0
    assert np.abs(np.linalg.norm(verts, axis=-1) - radius).max() < 0.9 / (
        g - 1)

    def decoder(p):
        return torch.clamp(p * 0.5 + 0.5, 0, 1), p[..., :1]

    rgb = mesh.dispatch_vertex_colors(decoder, verts, chunk=4096,
                                      device=cuda)
    assert rgb.device.type == 'cuda'
    colors = rgb.cpu().numpy()
    np.testing.assert_allclose(colors, np.clip(verts * 0.5 + 0.5, 0, 1),
                               atol=1e-6)
    path = tmp_path / 'sphere.obj'
    mesh.export_obj(str(path), mesh.rotate_x(verts), colors, faces)
    data = np.loadtxt(path, comments='f', usecols=(1, 2, 3, 4, 5, 6))
    assert len(data) == len(verts)
    np.testing.assert_allclose(data[:, :3], mesh.rotate_x(verts), atol=1e-6)
    n_faces = sum(ln.startswith('f ') for ln in path.read_text().splitlines())
    assert n_faces == len(faces)


# -- int8 W8A8 serving (torch._int_mm, no kernel of the port) ----------------

@pytest.mark.parametrize('K', [768, 1024])
@pytest.mark.parametrize('M', [1, 16, 17, 154])
def test_int8_dense_card_matches_cpu(cuda, M, K):
    """``int8_dense`` on the card against the CPU at the row counts around
    ``_int_mm``'s rule (more than 16 rows: 1 and 16 are zero-padded) and
    the DiT's inner dims: the same int8 operands, the same exact int32
    sums, the same f32 rescale."""
    from ln3diff_tpu_torch.ops.int8 import (_quantize_rows, int8_dense,
                                            quantize_weight)
    g = torch.Generator().manual_seed(M * K)
    x = torch.randn((M, K), generator=g) * 2
    w = torch.randn((1024, K), generator=g) / K**0.5
    b = torch.randn((1024,), generator=g)
    wq, s = quantize_weight(w.t())
    kq = wq.t().contiguous()
    want = int8_dense(x, kq, s, b)
    assert torch.equal(_quantize_rows(x.to(cuda))[0].cpu(),
                       _quantize_rows(x)[0])
    got = int8_dense(x.to(cuda), kq.to(cuda), s.to(cuda), b.to(cuda))
    assert got.shape == (M, 1024) and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-6)


def test_int8_dense_refuses_what_int_mm_refuses(cuda):
    """No float fallback: an inner dim that is not a multiple of 8
    raises on the card."""
    from ln3diff_tpu_torch.ops.int8 import int8_dense, quantize_weight
    wq, s = quantize_weight(torch.randn(36, 64))
    with pytest.raises(ValueError, match='multiples of 8'):
        int8_dense(torch.randn(20, 36, device=cuda),
                   wq.t().contiguous().to(cuda), s.to(cuda))


def test_int8_attention_feeds_kernel_3(cuda):
    """A quantized ``Attention(1024, 16, fused=True)`` in bf16: kernel 3
    runs once, on the thirds of the int8 qkv projection, and equals the
    plain version on those q, k, v."""
    from ln3diff_tpu_torch.models.dit import Attention
    torch.manual_seed(0)
    src = Attention(1024, 16)
    attn = Attention(1024, 16, fused=True, quantized=True)
    attn.qkv.load_weight(src.qkv.weight)
    attn.proj.load_weight(src.proj.weight)
    attn.to(cuda, torch.bfloat16)
    assert attn.qkv.kernel_q.dtype == torch.int8
    assert attn.qkv.scale.dtype == torch.float32
    x = torch.randn((2, 768, 1024), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda).to(torch.bfloat16)
    seen = {}
    attn.proj.register_forward_pre_hook(
        lambda module, args: seen.setdefault('heads', args[0]))
    before = FusedAttention.launches
    with torch.no_grad():
        attn(x)
        q, k, v = (t.reshape(2, 768, 16, 64)
                   for t in attn.qkv(x).chunk(3, dim=-1))
        want = attention_reference(q, k, v).reshape(2, 768, 1024)
    assert FusedAttention.launches == before + 1
    _attn_close(seen['heads'], want, torch.bfloat16)


INT8_CONVS = {
    # (kernel, stride, padding, B, H, W, in, out)
    'unet320_level0_3x3': (3, 1, 1, 2, 8, 24, 320, 320),
    'downsample_3x3_s2': (3, 2, 1, 1, 8, 8, 64, 64),
    'skip_1x1': (1, 1, 0, 2, 4, 12, 640, 1280),
    'few_rows_3x3': (3, 1, 1, 1, 2, 3, 16, 8),
}


@pytest.mark.parametrize('case', sorted(INT8_CONVS))
def test_int8_conv_card_matches_cpu(cuda, case):
    """``Int8Conv`` (im2col over ``_int_mm``) on the card against the CPU:
    the same int8 weights and scales quantized on either, the same
    per-sample int8 activations, the same exact int32 sums (fewer than 17
    rows zero-padded on the card), the same f32 rescale; channels-last
    bf16 in and out, as the U-Net runs it."""
    from ln3diff_tpu_torch.ops.int8 import (Int8Conv, int8_conv_acc,
                                            quantize_per_sample)
    k, s, p, B, H, W, cin, cout = INT8_CONVS[case]
    g = torch.Generator().manual_seed(cin + k)
    w = torch.randn((cout, cin, k, k), generator=g) / (cin * k * k)**0.5
    conv = Int8Conv(cin, cout, k, stride=s, padding=p).load_weight(w)
    on_card = Int8Conv(cin, cout, k, stride=s, padding=p).to(cuda)
    on_card.load_weight(w.to(cuda))
    assert torch.equal(on_card.kernel_q.cpu(), conv.kernel_q)
    assert torch.equal(on_card.scale.cpu(), conv.scale)
    conv.bias.copy_(torch.randn((cout,), generator=g))
    x = torch.randn((B, cin, H, W), generator=g)
    x[-1] *= 5.0
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    xq, xs = quantize_per_sample(x.permute(0, 2, 3, 1))
    want_acc = int8_conv_acc(xq, conv.kernel_q, s, p)
    want = conv(x)
    conv.to(cuda)
    xq_c, xs_c = quantize_per_sample(x.to(cuda).permute(0, 2, 3, 1))
    assert torch.equal(xq_c.cpu(), xq) and torch.equal(xs_c.cpu(), xs)
    assert torch.equal(int8_conv_acc(xq_c, conv.kernel_q, s, p).cpu(),
                       want_acc)
    got = conv(x.to(cuda))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got.cpu(), want, atol=0, rtol=0)


def test_int8_conv_refuses_what_int_mm_refuses(cuda):
    """No float fallback: a contraction (in·kh·kw) that is not a multiple
    of 8 raises on the card."""
    from ln3diff_tpu_torch.ops.int8 import Int8Conv
    conv = Int8Conv(3, 8, 1).load_weight(torch.randn(8, 3, 1, 1)).to(cuda)
    with pytest.raises(ValueError, match='multiples of 8'):
        conv(torch.randn(1, 3, 8, 8, device=cuda))


def test_fgbg_render_kernel_1_matches_plain(cuda):
    """The fg/bg render (``use_background``, 32 fg + 32 bg plane
    channels, the FFHQ render options) with the fg pass through kernel 1
    against the plain point decoder, on the card, f32 planes; kernel 1
    launches once per batch element in each of the coarse and fine
    passes, the bg pass never."""
    from ln3diff_tpu_torch.config import RENDER_PRESETS
    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
    from ln3diff_tpu_torch.render.camera import orbit_cameras
    cfg = TriplaneVAEConfig(
        latent_size=8, dit2=DiT2Config(tokens_per_plane=16, hidden_size=32,
                                       depth=2, num_heads=2),
        conv_sr_ch=8, conv_sr_ch_mult=(1, 2), plane_channels=64,
        use_sr=True, sr_ratio=2, sr_module='stylegan', use_background=True)
    with torch.device(cuda):
        vae = TriplaneVAE(cfg)
    random_init_(vae, torch.Generator(device=cuda).manual_seed(0))
    planes = torch.randn((1, 3, 32, 32, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    cam = torch.from_numpy(orbit_cameras(2, radius=2.7, fov=12.6,
                                         pitch_deg=0.0)).float().to(cuda)
    opts = RENDER_PRESETS['ffhq']
    outs = []
    for fused in (False, True):
        before = FusedOSG.launches
        with torch.no_grad():
            outs.append(vae.render(planes.expand(2, -1, -1, -1, -1), cam,
                                   opts, 16, use_fused_osg=fused))
        assert FusedOSG.launches == before + (4 if fused else 0)
    atol, rtol = TOL[torch.float32]
    for key in ('feature_image', 'image_depth', 'image_mask', 'image_sr'):
        torch.testing.assert_close(outs[1][key], outs[0][key], atol=atol,
                                   rtol=rtol)


# -- the ShapeNet / FFHQ paths ------------------------------------------------

@pytest.mark.parametrize('M', [64 * 64 * 64, 128 * 128 * 48],
                         ids=['shapenet_frame', 'ffhq_frame'])
def test_fused_osg_at_unet_family_frames(cuda, M):
    """Kernel 1 at one frame's pass of the ShapeNet (64² rays × 64
    samples) and FFHQ (128² rays × 48) orbits: bf16 rows of 256² planes,
    no in-box fold."""
    args, _ = _inputs(M, torch.bfloat16, False, cuda, seed=M % 997)
    before = FusedOSG.launches
    rgb, sigma = osg_pointwise_fused(*args)
    torch.cuda.synchronize()
    assert FusedOSG.launches == before + 1
    want_rgb, want_sigma = osg_pointwise_reference(*args)
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(rgb, want_rgb, atol=atol, rtol=rtol)
    torch.testing.assert_close(sigma, want_sigma, atol=atol, rtol=rtol)


@pytest.mark.parametrize('up,demodulate,k', [(1, True, 3), (2, True, 3),
                                             (1, False, 1)])
def test_modulated_conv2d_card_matches_cpu(cuda, up, demodulate, k):
    """``modulated_conv2d`` (the batch folded into the conv's groups; the
    up path a stride-2 transposed conv and the FIR) on the card against
    the CPU, f32 without TF32, at the 8XDC head's second block's widths."""
    from ln3diff_tpu_torch.models.stylegan import modulated_conv2d
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(up * 10 + k)
    x = torch.randn((2, 256, 32, 32), generator=g)
    w = torch.randn((128, 256, k, k), generator=g)
    styles = torch.rand((2, 256), generator=g) + 0.5
    want = modulated_conv2d(x, w, styles, demodulate=demodulate, up=up)
    got = modulated_conv2d(x.to(cuda), w.to(cuda), styles.to(cuda),
                           demodulate=demodulate, up=up)
    assert got.shape == (2, 128, 32 * up, 32 * up)
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, atol=1e-5 * scale,
                               rtol=1e-4)


# -- the stage-2 trainer (training/ldm_trainer.py, diffusion/edm.py) ----------

def _small_ldm(objective, device, **cfg_kw):
    """A small text DiT's trainer on ``device``, f32, every weight drawn
    non-zero from seed 3 (the same on every device)."""
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.training.ldm_trainer import (LDMTrainConfig,
                                                        LDMTrainer)
    ddpm = objective == 'ddpm'
    cfg = DiTConfig(input_size=8, patch_size=2, in_channels=4,
                    hidden_size=64, depth=2, num_heads=4, variant='text',
                    context_dim=32, learn_sigma=ddpm, dtype=torch.float32,
                    **cfg_kw)
    kw = dict(var_type='learned_range', loss_type='rescaled_mse') \
        if ddpm else {}
    tr = LDMTrainer(DiT_TriLatent(cfg), LDMTrainConfig(
        objective=objective, lr=2e-3, ema_rate=0.5, **kw), seed=3,
        device=device)
    ref = DiT_TriLatent(cfg)
    random_init_(ref, torch.Generator().manual_seed(3))
    tr.model.load_state_dict(ref.state_dict())
    return tr


def _ldm_inputs(objective, device, B=4, seed=4):
    from ln3diff_tpu_torch.training.ldm_trainer import LDMDraws
    g = torch.Generator().manual_seed(seed)
    batch = {'latent': torch.randn((B, 8, 8, 12), generator=g),
             'context': {'crossattn': torch.randn((B, 7, 32), generator=g)}}
    t = (torch.rand((B,), generator=g) if objective == 'flow_matching'
         else torch.randint(0, 1000, (B,), generator=g))
    draws = LDMDraws(t, torch.randn((B, 8, 8, 12), generator=g))
    return ({'latent': batch['latent'].to(device),
             'context': {'crossattn': batch['context']['crossattn']
                         .to(device)}},
            LDMDraws(*(x.to(device) for x in draws)))


def _ldm_loss_and_grads(tr, batch, draws):
    loss, _ = tr._loss_fn(None, None, batch, draws)
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
             for k, p in tr.model.named_parameters()}
    tr.model.zero_grad(set_to_none=True)
    return loss.item(), grads


@pytest.mark.parametrize('objective', ['flow_matching', 'ddpm', 'edm'])
def test_ldm_step_card_matches_cpu(cuda, objective):
    """One LDM training step of a small DiT on the card against the CPU,
    f32 without TF32: the loss and every grad within 2e-3 of scale (a
    floor of 1e-5 of the largest grad), the AdamW step within 2·lr."""
    out = {}
    for dev in ('cpu', cuda):
        tr = _small_ldm(objective, dev)
        batch, draws = _ldm_inputs(objective, dev)
        loss, grads = _ldm_loss_and_grads(tr, batch, draws)
        tr.train_step(batch, draws=draws)
        out[str(dev)] = loss, grads, {k: p.detach().cpu() for k, p in
                                      tr.state.params.items()}
    (lc, gc, pc), (lg, gg, pg) = out['cpu'], out['cuda']
    assert abs(lg - lc) <= 2e-3 * abs(lc)
    gmax = max(float(g.abs().max()) for g in gc.values())
    for k, want in gc.items():
        tol = max(2e-3 * float(want.abs().max()), 1e-5 * gmax)
        torch.testing.assert_close(gg[k], want, atol=tol, rtol=0)
        assert float((pg[k] - pc[k]).abs().max()) <= 2 * 2e-3 + 1e-6, k


@pytest.mark.parametrize('policy', ['full', 'dots'])
def test_remat_grads_on_card(cuda, policy):
    """Remat on the card recomputes the same kernels: the loss and every
    grad equal those without remat to 1e-5 of scale (f32)."""
    plain = _small_ldm('ddpm', cuda)
    remat = _small_ldm('ddpm', cuda, remat=True, remat_policy=policy)
    batch, draws = _ldm_inputs('ddpm', cuda)
    l0, g0 = _ldm_loss_and_grads(plain, batch, draws)
    l1, g1 = _ldm_loss_and_grads(remat, batch, draws)
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    for k, want in g0.items():
        torch.testing.assert_close(g1[k], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_euler_edm_sample_card_matches_cpu(cuda):
    """``euler_edm_sample`` through a small DiT, 10 CFG steps from the same
    start noise, card against CPU, f32: within 2e-3 of the sample's
    scale."""
    from ln3diff_tpu_torch.diffusion.edm import (DiscreteDenoiser,
                                                 euler_edm_sample)
    g = torch.Generator().manual_seed(6)
    x_init = torch.randn((2, 8, 8, 12), generator=g)
    cond = {'crossattn': torch.randn((2, 7, 32), generator=g)}
    out = {}
    for dev in ('cpu', cuda):
        model = _small_ldm('edm', dev).model

        def network(x, c_noise, c):
            return model(x, c_noise.float(), c)

        out[str(dev)] = euler_edm_sample(
            DiscreteDenoiser(), network, x_init.shape,
            {k: v.to(dev) for k, v in cond.items()},
            {k: torch.zeros_like(v).to(dev) for k, v in cond.items()},
            num_steps=10, cfg_scale=4.0, device=dev, x_init=x_init).cpu()
    want = out['cpu']
    assert torch.isfinite(out['cuda']).all()
    torch.testing.assert_close(out['cuda'], want, rtol=0,
                               atol=2e-3 * float(want.abs().max()))


@pytest.fixture
def cuda_f32(cuda):
    """``cuda`` with cuDNN's TF32 convolutions off as well: the training
    checks hold the f32 arithmetic of both sides, as ``chip_smoke.py``
    does."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = before


def _small_vae_cfgs(fused):
    """The small VAE of ``chip_smoke.py``'s training checks (the kernels'
    32 plane and colour channels, the rest tiny), f32, patch 16 of 32²."""
    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.vae import TriplaneVAEConfig
    from ln3diff_tpu_torch.render.renderer import RenderOptions
    from ln3diff_tpu_torch.training.vae_trainer import VAETrainConfig
    model = TriplaneVAEConfig(
        encoder_ch=8, encoder_ch_mult=(1, 2), img_resolution=32,
        num_views=2, latent_size=16,
        dit2=DiT2Config(tokens_per_plane=64, hidden_size=32, depth=2,
                        num_heads=2, dtype=torch.float32),
        conv_sr_ch=8, conv_sr_ch_mult=(1, 2), dtype=torch.float32)
    train = VAETrainConfig(lr=2e-3, patch_resolution=16, render_resolution=32,
                           ema_rate=0.5, use_fused_osg=fused)
    opts = RenderOptions(depth_resolution=16, depth_resolution_importance=16,
                         filter_out_of_bbox=True)
    return model, train, opts


def _grads_of(module):
    out = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
           .detach().cpu() for k, p in module.named_parameters()
           if p.requires_grad}
    module.zero_grad(set_to_none=True)
    return out


def _assert_grads_close(got, want, rel=2e-3):
    gmax = max(float(g.abs().max()) for g in want.values())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=0, atol=max(
            rel * float(w.abs().max()), 1e-5 * gmax), msg=k)


@pytest.mark.parametrize('p_rendering', [False, True])
def test_lsgm_step_card_matches_cpu(cuda_f32, p_rendering):
    """One LSGM joint step (a small VAE and a 32-channel U-Net with the
    spatial transformer), card against CPU, f32, the same weights and
    draws: the loss and every grad within 2e-3 of scale (floor 1e-5 of
    the largest grad), the AdamW step within 2·lr."""
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.models.unet import UNetConfig, UNetModel
    from ln3diff_tpu_torch.render.renderer import draw_uniforms
    from ln3diff_tpu_torch.training.losses import LossConfig
    from ln3diff_tpu_torch.training.lsgm_trainer import (
        LSGMConfig, LSGMDraws, LSGMTrainConfig, LSGMTrainer)
    model_cfg, _, opts = _small_vae_cfgs(False)
    raw = make_multiview_batch(2, 32, 32, seed=5)
    raw['context'] = torch.randn(
        (1, 7, 32), generator=torch.Generator().manual_seed(6)).numpy()
    g = torch.Generator().manual_seed(4)
    lat = (1, 16, 16, 12)
    draws = LSGMDraws(torch.randn((1, 16, 16, 4, 3), generator=g),
                      draw_uniforms(2, 256, opts, g, 'cpu'),
                      torch.rand((1,), generator=g),
                      torch.randn(lat, generator=g),
                      torch.rand((1,), generator=g),
                      torch.randn(lat, generator=g))
    out, state = {}, None
    for dev in ('cpu', cuda_f32):
        unet = UNetModel(UNetConfig(
            in_channels=4, model_channels=32, out_channels=4,
            num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), num_heads=2, context_dim=32,
            dtype=torch.float32))
        tr = LSGMTrainer(model_cfg, unet, LSGMTrainConfig(
            lr=2e-3, ema_rate=0.5, patch_resolution=16,
            render_resolution=32), LossConfig(lpips_lambda=0.0),
            LSGMConfig(p_rendering_loss=p_rendering), render_opts=opts,
            seed=3, device=dev)
        if state is None:
            from ln3diff_tpu_torch.models.layers import random_init_
            random_init_(tr.denoiser, torch.Generator().manual_seed(7))
            with torch.no_grad():
                tr.denoiser.mixing_logit.zero_()
            state = {k: v.clone() for k, v in tr.joint.state_dict().items()}
        tr.joint.load_state_dict(state)
        d = LSGMDraws(*(x.to(dev) if torch.is_tensor(x)
                        else type(x)(*(y.to(dev) for y in x))
                        for x in draws))
        batch = tr.prepare_batch(raw)
        tr.build()
        loss, _ = tr.loss_fn(None, None, batch, d)
        loss.backward()
        grads = _grads_of(tr.joint)
        tr.train_step(batch, draws=d)
        out[str(dev)] = loss.item(), grads, {
            k: p.detach().cpu() for k, p in tr.state.params.items()}
    (lc, gc, pc), (lg, gg, pg) = out['cpu'], out['cuda']
    assert abs(lg - lc) <= 2e-3 * abs(lc)
    _assert_grads_close(gg, gc)
    for k in pc:
        assert float((pg[k] - pc[k]).abs().max()) <= 2 * 2e-3 + 1e-6, k


def _adv_draws(g):
    from ln3diff_tpu_torch.training.augment import (
        AugmentDraws, augment_draw_plan, bgc_config)
    return AugmentDraws({
        i: (torch.rand if kind == 'uniform' else torch.randn)(
            shp, generator=g)
        for i, kind, shp in augment_draw_plan((2, 16, 16, 3), bgc_config())})


@pytest.mark.parametrize('head_kind', ['stylegan', 'vision_aided'])
def test_adversarial_step_card_matches_cpu(cuda_f32, head_kind):
    """The adversarial VAE step with LPIPS (the card through kernels 1 and
    2, the CPU plain) and the discriminator's loss on the re-render
    (kernel 1 on the card): the losses and the VAE's and the
    discriminator's grads within 2e-3 of scale, f32.  The StyleGAN head
    runs ADA (``bgc_config()`` at p = 0.6, the same draws) and R1."""
    from ln3diff_tpu_torch.conditioning.clip import CLIPVisionConfig
    from ln3diff_tpu_torch.conditioning.lpips import make_lpips_fn
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.models.stylegan import DiscriminatorConfig
    from ln3diff_tpu_torch.render.renderer import draw_uniforms
    from ln3diff_tpu_torch.training.augment import bgc_config
    from ln3diff_tpu_torch.training.gan import AdversarialHead, GANConfig
    from ln3diff_tpu_torch.training.losses import LossConfig
    from ln3diff_tpu_torch.training.vae_trainer import TrainDraws, VAETrainer
    from ln3diff_tpu_torch.training.vision_aided import (VisionAidedConfig,
                                                         VisionAidedHead)
    raw = make_multiview_batch(2, 32, 32, seed=5)
    g = torch.Generator().manual_seed(4)
    _, _, opts = _small_vae_cfgs(False)
    eps = torch.randn((1, 16, 16, 4, 3), generator=g)
    render = draw_uniforms(2, 256, opts, g, 'cpu')
    stylegan = head_kind == 'stylegan'
    adv, d_draws = (_adv_draws(g), (_adv_draws(g), _adv_draws(g))) \
        if stylegan else (None, None)
    out, ref = {}, None
    for dev in ('cpu', cuda_f32):
        model_cfg, train_cfg, opts = _small_vae_cfgs(dev != 'cpu')
        if stylegan:
            head = AdversarialHead(GANConfig(
                disc=DiscriminatorConfig(img_resolution=16, base_channels=16,
                                         max_channels=64),
                ada=bgc_config()), seed=3, device=dev)
            head.ada_p = 0.6
        else:
            head = VisionAidedHead(VisionAidedConfig(
                clip=CLIPVisionConfig(hidden_size=64, num_layers=2,
                                      num_heads=2, intermediate_size=128,
                                      patch_size=8, image_size=32),
                taps=(1, 2), head_width=16), seed=3, device=dev)
        lpips = make_lpips_fn(device=dev, seed=3)
        tr = VAETrainer(model_cfg, train_cfg, LossConfig(lpips_lambda=0.5),
                        render_opts=opts, seed=3, lpips_fn=lpips,
                        adversarial=head, device=dev)
        nets = (tr.model, head.model, lpips.model)
        if ref is None:
            ref = [{k: v.clone() for k, v in n.state_dict().items()}
                   for n in nets]
        for n, sd in zip(nets, ref):
            n.load_state_dict(sd)
        mv = (lambda x: None if x is None else type(x)(
            {k: v.to(dev) for k, v in x.values.items()}))
        draws = TrainDraws(eps.to(dev), type(render)(
            *(t.to(dev) for t in render)), mv(adv))
        batch = tr.prepare_batch(raw)
        launches = (FusedOSG.launches, FusedOSG.backward_launches)
        loss, _ = tr.loss_fn(batch, draws=draws)
        loss.backward()
        grads = _grads_of(tr.model)
        real, fake = tr._disc_inputs(batch)
        d_loss, _ = (head.d_loss(real, fake, tuple(mv(x) for x in d_draws))
                     if stylegan else head.d_loss(real, fake))
        d_loss.backward()
        out[str(dev)] = (loss.item(), grads, d_loss.item(),
                         _grads_of(head.model), fake.cpu(),
                         (FusedOSG.launches - launches[0],
                          FusedOSG.backward_launches - launches[1]))
    (lc, gc, dc, dgc, fc, nc), (lg, gg, dg, dgg, fg, ng) = (out['cpu'],
                                                            out['cuda'])
    assert nc == (0, 0) and ng[0] > 0 and ng[1] > 0
    assert abs(lg - lc) <= 2e-3 * abs(lc)
    assert abs(dg - dc) <= 2e-3 * abs(dc)
    torch.testing.assert_close(fg, fc, rtol=0, atol=2e-3)
    _assert_grads_close(gg, gc)
    _assert_grads_close(dgg, dgc)


def test_augment_and_grid_sample_card_match_cpu(cuda):
    """The ADA pipeline (every group on, the same draws) and the grid
    samplers, card against CPU, f32: within 1e-4 of scale."""
    from ln3diff_tpu_torch.ops.grid_sample import (grid_sample_2d_batched,
                                                   grid_sample_3d)
    from ln3diff_tpu_torch.training.augment import (
        AugmentConfig, AugmentDraws, augment_draw_plan, augment_pipe)
    cfg = AugmentConfig(xflip=1, rotate90=1, xint=1, scale=1, rotate=1,
                        aniso=1, xfrac=1, brightness=1, contrast=1,
                        lumaflip=1, hue=1, saturation=1, imgfilter=1,
                        noise=1, cutout=1)
    g = torch.Generator().manual_seed(8)
    x = torch.rand((3, 32, 32, 3), generator=g) * 2 - 1
    values = {i: (torch.rand if kind == 'uniform' else torch.randn)(
        shp, generator=g)
        for i, kind, shp in augment_draw_plan(x.shape, cfg)}
    feats = torch.randn((2, 9, 7, 4), generator=g)
    coords = torch.rand((2, 50, 2), generator=g) * 2.4 - 1.2
    grid = torch.randn((5, 6, 7, 3), generator=g)
    c3 = torch.rand((40, 3), generator=g) * 2.4 - 1.2
    out = {}
    for dev in ('cpu', cuda):
        out[str(dev)] = [
            augment_pipe(x.to(dev), cfg, 0.7, draws=AugmentDraws(
                {k: v.to(dev) for k, v in values.items()})),
            grid_sample_2d_batched(feats.to(dev), coords.to(dev)),
            grid_sample_3d(grid.to(dev), c3.to(dev))]
    for got, want in zip(out['cuda'], out['cpu']):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def _small_warmup(dev):
    """A small EG3D warm-up trainer: a toy ``FFHQVAE`` (a 2-block ViT at
    56², 32² planes of 8 channels, the 8XDC head's ``sr_ws``) under a
    teacher with w 512 and 32² planes, f32, 16² renders."""
    from ln3diff_tpu_torch.models.eg3d import TriPlaneGeneratorConfig
    from ln3diff_tpu_torch.models.vae_shapenet import FFHQVAE, FFHQVAEConfig
    from ln3diff_tpu_torch.models.vit import vit_registry
    from ln3diff_tpu_torch.render.renderer import RenderOptions
    from ln3diff_tpu_torch.training.eg3d_warmup import (EG3DWarmupTrainer,
                                                        WarmupConfig)
    cfg = FFHQVAEConfig(
        encoder_vit=vit_registry('dinov2-s/14', img_size=56, embed_dim=32,
                                 depth=2, num_heads=2),
        token_size=4, decoder_embed_dim=32, decoder_fusion_depth=2,
        decoder_num_heads=2, channel_multiplier=2, plane_channels=8,
        triplane_resolution=32, decoder_output_dim=8, dtype=torch.float32)
    with torch.device(dev):
        model = FFHQVAE(cfg, encoder=True)
    return EG3DWarmupTrainer(
        cfg, TriPlaneGeneratorConfig(z_dim=16, w_dim=512,
                                     plane_resolution=32, plane_channels=8,
                                     decoder_output_dim=8),
        WarmupConfig(lr=2e-3, ema_rate=0.5, batch_size=2,
                     render_resolution=16, num_shape_points=256),
        render_opts=RenderOptions(depth_resolution=8,
                                  depth_resolution_importance=8,
                                  ray_start=2.25, ray_end=3.3, box_warp=1.0,
                                  white_back=False),
        seed=3, model=model, device=dev)


def test_eg3d_warmup_step_card_matches_cpu(cuda_f32):
    """One warm-up step, card against CPU, f32, the same weights, cameras
    and draws: the loss and each term within 2e-3 relative, every grad
    within 2e-3 of scale (floor 1e-5 of the largest grad), the AdamW step
    within 2·lr; no kernel launches (the JAX step runs none)."""
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.render.renderer import draw_uniforms
    from ln3diff_tpu_torch.training.eg3d_warmup import WarmupDraws
    g = torch.Generator().manual_seed(4)
    draws = WarmupDraws(torch.randn((2, 16), generator=g),
                        torch.rand((2, 256, 3), generator=g) - 0.5,
                        torch.randn((2, 4, 4, 4, 3), generator=g), None)
    out, state = {}, None
    before = FusedOSG.launches
    for dev in ('cpu', cuda_f32):
        tr = _small_warmup(dev)
        if state is None:
            with torch.no_grad():
                tr.model.sr_ws.normal_(0, 0.3, generator=g)
            state = tuple({k: v.clone() for k, v in m.state_dict().items()}
                          for m in (tr.model, tr.teacher))
            cam = torch.from_numpy(tr._sample_cameras(2))
            draws = draws._replace(render=draw_uniforms(2, 256, tr.opts, g,
                                                        'cpu'))
        tr.model.load_state_dict(state[0])
        tr.teacher.load_state_dict(state[1])
        d = WarmupDraws(*(x.to(dev) if torch.is_tensor(x)
                          else type(x)(*(y.to(dev) for y in x))
                          for x in draws))
        loss, terms = tr.loss_fn(None, None, {'c': cam.to(dev)}, d)
        loss.backward()
        grads = _grads_of(tr.model)
        tr.train_step(cam.to(dev), draws=d)
        out[str(dev)] = loss.item(), terms, grads, {
            k: p.detach().cpu() for k, p in tr.state.params.items()}
    (lc, tc, gc, pc), (lg, tg, gg, pg) = out['cpu'], out['cuda']
    assert FusedOSG.launches == before
    assert abs(lg - lc) <= 2e-3 * abs(lc)
    assert sorted(tc) == ['depth', 'img', 'plane', 'shape', 'ws']
    for k in tc:
        assert abs(float(tg[k]) - float(tc[k])) <= 2e-3 * abs(float(tc[k]))
    _assert_grads_close(gg, gc)
    for k in pc:
        assert float((pg[k] - pc[k]).abs().max()) <= 2 * 2e-3 + 1e-6, k


def test_lgm_encode_card_matches_cpu(cuda_f32):
    """``TriplaneVAE(encoder_type='lgm').encode`` of two views of 32² ×
    10 (the joint-view attention at the second level, in query chunks on
    the card), card against CPU, f32, within 2e-4 of scale."""
    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
    cfg = TriplaneVAEConfig(
        encoder_ch=8, encoder_ch_mult=(1, 2), img_resolution=32,
        num_views=2, latent_size=16, encoder_type='lgm',
        lgm_down_channels=(32, 64), lgm_down_attention=(False, True),
        dit2=DiT2Config(tokens_per_plane=64, hidden_size=32, depth=2,
                        num_heads=2, dtype=torch.float32),
        conv_sr_ch=8, conv_sr_ch_mult=(1, 2), dtype=torch.float32)
    cpu = TriplaneVAE(cfg, encoder=True)
    random_init_(cpu, torch.Generator().manual_seed(2))
    with torch.device(cuda_f32):
        card = TriplaneVAE(cfg, encoder=True)
    card.load_state_dict(cpu.state_dict())
    for m in card.modules():
        if hasattr(m, 'query_chunk'):
            m.query_chunk = 100
    x = torch.randn((4, 32, 32, 10), generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        want = cpu.encode(x)
        got = card.encode(x.to(cuda_f32)).cpu()
    assert tuple(got.shape) == (2, 16, 16, 8, 3)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2e-4 * float(want.abs().max()))


def test_stylegan3_card_matches_cpu(cuda_f32):
    """A small ``GeneratorSG3`` (32², 6 layers), card against CPU, f32,
    ψ = 0.7 and with ``update_emas`` (the magnitude EMAs too), within
    2e-4 of scale."""
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.stylegan3 import GeneratorSG3
    kw = dict(z_dim=32, w_dim=32, img_resolution=32, num_layers=6,
              channel_base=1024, channel_max=32)
    cpu = GeneratorSG3(**kw)
    random_init_(cpu, torch.Generator().manual_seed(2))
    with torch.device(cuda_f32):
        card = GeneratorSG3(**kw)
    card.load_state_dict(cpu.state_dict())
    z = torch.randn((2, 32), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for kwargs in (dict(truncation_psi=0.7), dict(update_emas=True)):
            want = cpu(z, **kwargs)
            got = card(z.to(cuda_f32), **kwargs).cpu()
            assert tuple(got.shape) == (2, 32, 32, 3)
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=2e-4 * float(want.abs().max()))
    for k, v in cpu.state_dict().items():
        torch.testing.assert_close(card.state_dict()[k].cpu(), v, rtol=1e-4,
                                   atol=1e-6, msg=k)


# -- the parallel layer at a world size of 1 under NCCL -------------------------

@pytest.fixture
def nccl(cuda_f32, tmp_path):
    """A one-rank NCCL process group over a file store, torn down after
    the test (the other tests build their trainers without one)."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group('nccl', store=dist.FileStore(
        str(tmp_path / 'store'), 1), rank=0, world_size=1)
    try:
        yield cuda_f32
    finally:
        dist.destroy_process_group()


def test_parallel_vae_step_world1_equals_no_mesh(nccl):
    """Two data-parallel VAE steps under a one-rank NCCL mesh (kernels 1
    and 2, the grads all-reduced over the one rank) equal the steps
    without a mesh bit for bit, under deterministic algorithms (the
    default backward sums with atomics)."""
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.parallel.mesh import LocalMesh, make_mesh
    from ln3diff_tpu_torch.training.vae_trainer import VAETrainer
    model_cfg, train_cfg, opts = _small_vae_cfgs(True)
    raw = make_multiview_batch(2, 32, 32, seed=5)
    mesh = make_mesh()
    assert not isinstance(mesh, LocalMesh) and mesh.size() == 1
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, m in (('mesh', mesh), ('none', LocalMesh('cuda'))):
            tr = VAETrainer(model_cfg, train_cfg, render_opts=opts, seed=3,
                            device='cuda', mesh=m)
            gen = torch.Generator(device='cuda').manual_seed(7)
            FusedOSG.launches = FusedOSG.backward_launches = 0
            losses = []
            for i in range(2):
                batch = tr.prepare_batch(raw)
                batch['step'] = float(i)
                losses.append(float(tr.train_step(batch,
                                                  generator=gen)['loss']))
            assert FusedOSG.launches > 0 and FusedOSG.backward_launches > 0
            out[name] = (losses, {k: p.detach().clone()
                                  for k, p in tr.state.params.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    assert out['mesh'][0] == out['none'][0]
    for k, p in out['none'][1].items():
        assert torch.equal(out['mesh'][1][k], p), k


class _FsdpSizes:
    """A stand-in mesh for the placement rules (they read axis sizes)."""

    def __init__(self, fsdp):
        self.shape = (1, 1, fsdp, 1)


def test_in_module_shards_world1_equal_no_mesh(nccl):
    """The small VAE's parameters held in the module as one-way shards
    (``parallel/fsdp.py``: the gathers, the reduce-scatter and the
    saved-tensor recipes under NCCL, at the placements ``param_sharding_
    rules`` gives an fsdp axis of 2) train two steps equal to the steps
    without a mesh bit for bit, kernels 1 and 2 on both, under
    deterministic algorithms."""
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.parallel.mesh import (LocalMesh, make_mesh,
                                                 param_sharding_rules)
    from ln3diff_tpu_torch.training.train_state import TrainState
    from ln3diff_tpu_torch.training.vae_trainer import VAETrainer
    model_cfg, train_cfg, opts = _small_vae_cfgs(True)
    raw = make_multiview_batch(2, 32, 32, seed=5)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, m in (('sharded', make_mesh()), ('none', LocalMesh('cuda'))):
            tr = VAETrainer(model_cfg, train_cfg, render_opts=opts, seed=3,
                            device='cuda', mesh=m)
            tr.init_state()
            if name == 'sharded':
                tr.state = TrainState.create(
                    tr.model, tr.state.tx, ema_rates=tr.state.ema_rates,
                    mesh=m, placements=param_sharding_rules(
                        tr.model, _FsdpSizes(2), 1024))
                assert tr.state.sharded is not None
            gen = torch.Generator(device='cuda').manual_seed(7)
            FusedOSG.launches = FusedOSG.backward_launches = 0
            losses = []
            for i in range(2):
                batch = tr.prepare_batch(raw)
                batch['step'] = float(i)
                losses.append(float(tr.train_step(batch,
                                                  generator=gen)['loss']))
            assert FusedOSG.launches > 0 and FusedOSG.backward_launches > 0
            out[name] = (losses, {
                k: (p.to_local() if hasattr(p, 'to_local') else p)
                .detach().clone() for k, p in tr.state.params.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    assert out['sharded'][0] == out['none'][0]
    for k, p in out['none'][1].items():
        assert torch.equal(out['sharded'][1][k], p), k


def test_shard_fed_vae_step(cuda_f32, tmp_path):
    """Tar shards of synthetic instances streamed through ``PostProcess``
    (the native reader's samples equal to ``tarfile``'s) into two steps of
    the small VAE with kernels 1 and 2: finite losses, launches of both
    kernels, the parameters moved."""
    import numpy as np
    from ln3diff_tpu_torch.data.objaverse import PostProcess
    from ln3diff_tpu_torch.data.wds import (iter_shard, iter_shards_native,
                                            load_wds_data)
    from ln3diff_tpu_torch.scripts import wds_create
    from ln3diff_tpu_torch.training.vae_trainer import VAETrainer
    paths = wds_create.main(['--out', str(tmp_path / 'objv-%06d.tar'),
                             '--num_instances', '3', '--num_views', '4',
                             '--resolution', '32', '--maxcount', '2'])
    a = [s for p in paths for s in iter_shard(p)]
    b = list(iter_shards_native(paths))
    assert [s['__key__'] for s in a] == [s['__key__'] for s in b]
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x
                   if k.endswith('.npy'))
    model_cfg, train_cfg, opts = _small_vae_cfgs(True)
    stream = load_wds_data(paths, 1, transform=PostProcess(
        reso_encoder=32, reso_render=32, num_views_input=2), seed=0)
    tr = VAETrainer(model_cfg, train_cfg, render_opts=opts, seed=3,
                    device='cuda')
    tr.init_state()
    before = {k: p.detach().clone() for k, p in tr.state.params.items()}
    FusedOSG.launches = FusedOSG.backward_launches = 0
    for i in range(2):
        raw = next(stream)
        flat = {k: raw[k].reshape((-1,) + raw[k].shape[2:])
                for k in ('img_to_encoder', 'img', 'depth', 'depth_mask',
                          'c', 'bbox')}
        batch = tr.prepare_batch(flat)
        batch['step'] = float(i)
        m = tr.train_step(batch, generator=torch.Generator(
            device='cuda').manual_seed(i))
        assert np.isfinite(float(m['loss'])) and float(m['grad_norm']) > 0
    assert FusedOSG.launches > 0 and FusedOSG.backward_launches > 0
    assert any(not torch.equal(v, tr.state.params[k])
               for k, v in before.items())


def test_sharded_serving_world1_equals_unsharded(nccl):
    """The small text→3D call with ``serving_mesh`` (one NCCL rank) equals
    the call without it: frames and σ grid, through kernel 1 on both."""
    from ln3diff_tpu_torch.conditioning.clip import CLIPTextConfig
    from ln3diff_tpu_torch.models.dit import DiT2Config, DiTConfig
    from ln3diff_tpu_torch.models.vae import TriplaneVAEConfig
    from ln3diff_tpu_torch.parallel.mesh import make_mesh
    from ln3diff_tpu_torch.pipeline import SamplerSpec, build_t23d_pipeline
    kw = dict(device='cuda', seed=0,
              den_cfg=DiTConfig(input_size=8, patch_size=2, in_channels=4,
                                hidden_size=32, depth=2, num_heads=2,
                                context_dim=32, dtype=torch.float32),
              vae_cfg=TriplaneVAEConfig(
                  latent_size=8, patch_size=2, conv_sr_ch=8,
                  conv_sr_ch_mult=(1, 2), conv_sr_res_blocks=1,
                  dit2=DiT2Config(tokens_per_plane=16, hidden_size=32,
                                  depth=2, num_heads=2, dtype=torch.float32),
                  dtype=torch.float32),
              text_cfg=CLIPTextConfig(hidden_size=32, num_layers=1,
                                      num_heads=2, intermediate_size=64),
              render_resolution=16,
              sampler=SamplerSpec(kind='ddim', num_steps=2,
                                  latent_shape=(8, 8, 12)),
              render_dtype=None)
    x_init = torch.randn(1, 8, 8, 12, device='cuda',
                         generator=torch.Generator('cuda').manual_seed(3))
    cond = {'crossattn': torch.randn(1, 77, 32, device='cuda')}
    uncond = {'crossattn': torch.zeros(1, 77, 32, device='cuda')}
    out = {}
    for name, m in (('sharded', make_mesh()), ('plain', None)):
        pipe, _, _ = build_t23d_pipeline(serving_mesh=m, **kw)
        FusedOSG.launches = 0
        res = pipe(cond, uncond, num_frames=8, x_init=x_init)
        planes = pipe.decode_fn(res['latents'])
        sigma = pipe.dispatch_mesh_sigma(planes, 32, smooth=True)
        torch.cuda.synchronize()
        out[name] = (res['video'], sigma, FusedOSG.launches)
    assert out['sharded'][2] == out['plain'][2] > 0
    assert torch.equal(out['sharded'][0], out['plain'][0])
    assert torch.equal(out['sharded'][1], out['plain'][1])


def test_dit_pipeline_pp1_on_card(cuda_f32):
    """``dit_pipeline_apply`` at pp = 1 with four microbatches equals the
    plain forward on the card (the same per-sample math; 1e-5)."""
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.parallel.mesh import LocalMesh
    from ln3diff_tpu_torch.parallel.pipeline import dit_pipeline_apply
    model = DiT_TriLatent(DiTConfig(
        input_size=8, patch_size=2, in_channels=4, hidden_size=64,
        depth=4, num_heads=2, context_dim=32, dtype=torch.float32)).cuda()
    random_init_(model, torch.Generator('cuda').manual_seed(0))
    g = torch.Generator('cuda').manual_seed(1)
    x = torch.randn(4, 8, 8, 12, device='cuda', generator=g)
    t = torch.arange(4.0, device='cuda') * 100
    ctx = {'crossattn': torch.randn(4, 7, 32, device='cuda', generator=g)}
    with torch.no_grad():
        want = model(x, t, ctx)
        got = dit_pipeline_apply(model, x, t, ctx, mesh=LocalMesh('cuda'),
                                 n_micro=4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_inception_card_matches_cpu(cuda_f32):
    """The FID InceptionV3 at 299², batch 2, He-scaled random weights:
    pool3, the logits and the 2023-d spatial features on the card against
    the CPU, f32 with TF32 off (1e-3 of each output's scale)."""
    import math
    from ln3diff_tpu_torch.evaluation.inception import InceptionV3
    g = torch.Generator().manual_seed(0)
    model = InceptionV3().eval()
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k.endswith('conv.weight'):
                p.copy_(torch.randn(p.shape, generator=g)
                        * math.sqrt(2.0 / p[0].numel()))
    x = torch.rand((2, 299, 299, 3), generator=g) * 2 - 1
    with torch.no_grad():
        want = model(x)
        got = model.cuda()(x.cuda())
    for k in ('pool3', 'logits', 'spatial'):
        w = want[k]
        assert got[k].shape == w.shape and torch.isfinite(got[k]).all()
        torch.testing.assert_close(got[k].cpu(), w, rtol=0,
                                   atol=1e-3 * max(1.0, float(w.abs().max())))


def test_gradio_runner_on_kernel_1(cuda, tmp_path):
    """The image→3D demo's runner at toy widths on the card (the VAE with
    kernel 1's 32 plane and colour channels): the render and the σ grid
    launch kernel 1 (2 frames × 2 passes + one σ chunk, and colour chunks
    when the field crosses the threshold); frames, AVI and OBJ written."""
    import argparse
    import numpy as np
    from ln3diff_tpu_torch.conditioning.clip import CLIPVisionConfig
    from ln3diff_tpu_torch.models.dit import DiT2Config, DiTConfig
    from ln3diff_tpu_torch.models.vae import TriplaneVAEConfig
    from ln3diff_tpu_torch.render.renderer import RenderOptions
    from ln3diff_tpu_torch.scripts import gradio_app
    args = argparse.Namespace(num_steps=2, num_frames=2, render_resolution=16,
                              mesh_grid=32, seed=0, int8_dit=False,
                              device='cuda')
    run = gradio_app.build_runner(
        args,
        den_cfg=DiTConfig(input_size=8, patch_size=2, in_channels=4,
                          hidden_size=32, depth=2, num_heads=2,
                          variant='image-pixelart', context_dim=32,
                          pooled_vector_dim=32, t2i_final=True),
        vae_cfg=TriplaneVAEConfig(
            latent_size=8, patch_size=2, conv_sr_ch=8,
            conv_sr_ch_mult=(1, 2), conv_sr_res_blocks=1,
            dit2=DiT2Config(tokens_per_plane=16, hidden_size=32, depth=2,
                            num_heads=2, dtype=torch.float32),
            dtype=torch.float32),
        vision_cfg=CLIPVisionConfig(image_size=28, patch_size=14,
                                    hidden_size=32, num_layers=1,
                                    num_heads=2, intermediate_size=64),
        render_opts=RenderOptions(depth_resolution=8,
                                  depth_resolution_importance=8,
                                  filter_out_of_bbox=True))
    image = np.random.default_rng(0).integers(0, 256, (48, 48, 3),
                                              dtype=np.uint8)
    FusedOSG.launches = 0
    frames, mesh = run(image, str(tmp_path))
    torch.cuda.synchronize()
    assert FusedOSG.launches >= 2 * 2 + 1
    assert len(frames) == 2 and all(os.path.exists(p) for p in frames)
    assert (tmp_path / 'out.avi').stat().st_size > 0
    assert os.path.exists(mesh)


def test_profiling_trace_on_card(cuda, tmp_path):
    """``utils.profiling.trace`` around a small fused-attention DiT (head
    width 64, kernel 3 once per block): the trace holds the ``annotate``
    range and kernel 3's counter reads one launch per block."""
    import json
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.utils import profiling
    cfg = DiTConfig(input_size=8, patch_size=2, in_channels=4,
                    hidden_size=128, depth=2, num_heads=2, context_dim=32,
                    fused_attention=True, exact_gelu=False)
    model = DiT_TriLatent(cfg).cuda()
    random_init_(model, torch.Generator('cuda').manual_seed(0))
    model = model.to(torch.bfloat16).eval()
    x = torch.randn(2, 8, 8, 12, device='cuda')
    t = torch.full((2,), 10.0, device='cuda')
    ctx = {'crossattn': torch.randn(2, 7, 32, device='cuda')}
    FusedAttention.launches = 0
    with torch.no_grad(), profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate('dit_probe'):
            out = model(x, t, ctx)
        torch.cuda.synchronize()
    assert FusedAttention.launches == cfg.depth
    assert torch.isfinite(out).all()
    events = json.loads(open(prof.trace_path).read())['traceEvents']
    assert any(e.get('name') == 'dit_probe' for e in events)
