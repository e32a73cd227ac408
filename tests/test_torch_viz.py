"""The noise-schedule strip (``ln3diff_tpu_torch/scripts/viz.py``)
against JAX's ``scripts/scripts_lib/viz.py``: the same clean latent, the
same 1000-step linear schedule, JAX's noise draw (``PRNGKey(0)``) fed in
as ``noise=`` and toy decode and render functions written alike on both
sides (a dense map of the latent to planes; each plane's mean colour
modulated by the camera, through tanh): the five frames (t = 0, 249,
499, 749, 999) within 1e-4 of scale, f32 on the CPU, and
``save_image_strip`` writing the same PNG pixels."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ln3diff_tpu.diffusion.gaussian import make_diffusion as jmake
from ln3diff_tpu_torch.diffusion.gaussian import make_diffusion as tmake
from ln3diff_tpu_torch.scripts import viz as tviz

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'scripts'))
from scripts_lib import viz as jviz  # noqa: E402

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

H = W = 6
LATENT = (1, 4, 4, 12)


def _weights():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((12, 3 * 8)).astype(np.float32) / 3.0,
            rng.standard_normal((25, H * W)).astype(np.float32) / 5.0)


def _jax_fns():
    wd, wc = map(jnp.asarray, _weights())

    def decode(x):
        return jnp.tanh(x @ wd).reshape(x.shape[0], 16, 3, 8)

    def render(planes, cam):
        colour = planes.mean(axis=1)[:, :, :3]             # (B, 3, 3)
        light = (cam @ wc).reshape(-1, H, W, 1)
        return jnp.tanh(light * colour.mean(axis=1)[:, None, None, :])
    return decode, render


def _torch_fns():
    wd, wc = (torch.from_numpy(w) for w in _weights())

    def decode(x):
        return torch.tanh(x @ wd).reshape(x.shape[0], 16, 3, 8)

    def render(planes, cam):
        colour = planes.mean(dim=1)[:, :, :3]
        light = (cam @ wc).reshape(-1, H, W, 1)
        return torch.tanh(light * colour.mean(dim=1)[:, None, None, :])
    return decode, render


def _inputs():
    rng = np.random.default_rng(1)
    latent = rng.standard_normal(LATENT).astype(np.float32)
    cam = rng.standard_normal((1, 25)).astype(np.float32)
    return latent, cam


@pytest.fixture(scope='module')
def strips():
    latent, cam = _inputs()
    want = jviz.render_noise_schedule_strip(
        jnp.asarray(latent), jnp.asarray(cam), jmake(steps=1000),
        *_jax_fns())
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), LATENT))
    got = tviz.render_noise_schedule_strip(
        torch.from_numpy(latent), torch.from_numpy(cam), tmake(steps=1000),
        *_torch_fns(), noise=torch.from_numpy(noise))
    return got, want


def test_strip_matches_jax(strips):
    got, want = strips
    assert got.shape == want.shape == (5, H, W, 3)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    assert np.abs(got).max() <= 1.0
    # the frames differ: each t noises the latent differently
    assert not np.allclose(got[0], got[-1])


def test_custom_times_and_generator():
    latent, cam = _inputs()
    decode, render = _torch_fns()
    diffusion = tmake(steps=1000)
    ts = (0.0, 0.5)
    a = tviz.render_noise_schedule_strip(
        torch.from_numpy(latent), torch.from_numpy(cam), diffusion, decode,
        render, generator=torch.Generator().manual_seed(3), ts=ts)
    b = tviz.render_noise_schedule_strip(
        torch.from_numpy(latent), torch.from_numpy(cam), diffusion, decode,
        render, generator=torch.Generator().manual_seed(3), ts=ts)
    assert a.shape == (2, H, W, 3)
    np.testing.assert_array_equal(a, b)
    # t = 0 keeps sqrt(alpha_bar_0) of the clean latent: nearly the clean
    # render, which no draw of noise moves far
    clean = render(decode(torch.from_numpy(latent)), torch.from_numpy(cam))
    assert np.abs(a[0] - clean[0].numpy()).max() < 0.1


def test_save_image_strip_same_pixels(strips, tmp_path):
    got, want = strips
    p_t = tviz.save_image_strip(got, str(tmp_path / 'port.png'))
    p_j = jviz.save_image_strip(np.asarray(want), str(tmp_path / 'jax.png'))
    a, b = np.asarray(Image.open(p_t)), np.asarray(Image.open(p_j))
    assert a.shape == (H, 5 * W, 3) and a.dtype == np.uint8
    # the float frames agree to 1e-4, so at most a value on a level's
    # edge rounds to the next level; on JAX's own frames the pixels agree
    assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1
    p_same = tviz.save_image_strip(np.asarray(want),
                                   str(tmp_path / 'port_of_jax.png'))
    np.testing.assert_array_equal(np.asarray(Image.open(p_same)), b)
