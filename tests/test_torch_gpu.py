"""CUDA kernels of the port against their plain PyTorch versions, on the
card.  Marked ``gpu``; each test skips inside itself when no CUDA device is
present.  This file imports neither JAX nor the JAX package, so it runs on
the card's machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)
"""

import pytest
import torch

from ln3diff_tpu_torch.ops.fused_attention import (FusedAttention,
                                                   attention_reference,
                                                   fused_attention)
from ln3diff_tpu_torch.ops.fused_render import (FusedOSG,
                                                osg_pointwise_fused,
                                                osg_pointwise_reference)

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
