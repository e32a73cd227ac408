"""CUDA kernels of the port against their plain PyTorch versions, on the
card.  Marked ``gpu``; each test skips inside itself when no CUDA device is
present.  This file imports neither JAX nor the JAX package, so it runs on
the card's machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)
"""

import pytest
import torch

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
