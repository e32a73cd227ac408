"""The serving dtype of the image→3D and multi-view→3D towers: the four
PixArt DiT variants (plain and fused attention) and DINOv2, run in bf16.

XLA and torch round bf16 in different places, so the port's bf16 output
is held to JAX's f32 output no further than twice JAX's own bf16 output
is, the bar of ``test_torch_models.py::test_bf16_serving_dtype``.  Both
sides load the same perturbed weights (the toy models of
``test_torch_dit_pixart.py`` and ``test_torch_vision.py``).  The JAX DiT
runs with bf16 weights, as ``bench.py`` casts them; the JAX ViT keeps f32
weights and computes in bf16 on the bf16 image, while the port casts the
whole tower, as its builders do.
"""

import numpy as np
import os
import pytest
import torch

import jax
import jax.numpy as jnp

from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.models import vit as jvit
from ln3diff_tpu.utils.misc import cast_floating
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models import vit as tvit
from test_torch_dit_pixart import B, VARIANTS, _context
from test_torch_dit_pixart import _kw as pixart_kw
from test_torch_dit_pixart import _models as pixart_models
from test_torch_vision import VIT_CASES, _images
from test_torch_vision import _vit as vit_models

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _gaps(want32, want16, got):
    want32 = np.asarray(want32, np.float32)
    jax_gap = np.abs(np.asarray(want16, np.float32) - want32).max()
    port_gap = np.abs(got.float().numpy() - want32).max()
    return port_gap, jax_gap


@pytest.mark.parametrize('fused', [False, True], ids=['plain', 'fused'])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_pixart_bf16_gap(variant, fused):
    jm32, v, sd = pixart_models(variant)
    jm16 = jdit.DiT_TriLatent(jdit.DiTConfig(dtype=jnp.bfloat16,
                                             **pixart_kw(variant, False)))
    v16 = {'params': cast_floating(v['params'], jnp.bfloat16),
           'constants': v['constants']}
    tm = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.bfloat16,
                                           **pixart_kw(variant, fused)))
    tm.load_state_dict(sd)
    tm = tm.to(torch.bfloat16).eval()
    x = np.random.default_rng(1).standard_normal(
        (B, 8, 8, 12)).astype(np.float32)
    t = np.array([0.1, 0.73], np.float32)
    ctx = _context(variant, 2)
    jargs = (jnp.asarray(x), jnp.asarray(t),
             {k: jnp.asarray(c) for k, c in ctx.items()})
    want32 = jax.jit(jm32.apply)(v, *jargs)
    want16 = jax.jit(jm16.apply)(v16, *jargs)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 {k: torch.from_numpy(c) for k, c in ctx.items()})
    port_gap, jax_gap = _gaps(want32, want16, got)
    assert port_gap <= 2 * jax_gap, (port_gap, jax_gap)


def test_dinov2_bf16_gap():
    jm32, v, _ = vit_models('dinov2')
    kw = VIT_CASES['dinov2']
    jm16 = jvit.VisionTransformer(jvit.ViTConfig(dtype=jnp.bfloat16, **kw))
    tm = tvit.VisionTransformer(tvit.ViTConfig(dtype=torch.bfloat16, **kw))
    tm.load_state_dict(bridge.vit_state_dict(
        jax.tree_util.tree_map(np.asarray, v)))
    tm = tm.to(torch.bfloat16).eval()
    img = _images(3, kw['img_size'], seed=4)
    want32 = jax.jit(jm32.apply)(v, jnp.asarray(img))
    want16 = jax.jit(jm16.apply)(v, jnp.asarray(img, jnp.bfloat16))
    with torch.no_grad():
        got = tm(torch.from_numpy(img).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    port_gap, jax_gap = _gaps(want32, want16, got)
    assert port_gap <= 2 * jax_gap, (port_gap, jax_gap)

