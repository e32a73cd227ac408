"""The port's raw G-Objaverse ingestion (``ln3diff_tpu_torch/data/exr.py``,
``data/objaverse_raw.py``) against the JAX package's, on files that the
tests write.  Both are the same numpy code, so every comparison is exact
(arrays bit for bit, keys in order).

* The EXR codec: every compression (NONE, ZIPS, ZIP) and channel type
  (HALF, FLOAT, UINT), line counts that do not fill the last chunk,
  incompressible noise (stored raw inside a ZIP chunk): the port writes
  the same bytes as JAX, and each package reads the other's files to the
  same channels; the predictor both ways.
* The readers: intrinsics, the camera json, ``camera_25d``,
  ``unity2blender_fix``, ``read_dnormal`` (RGBA and other channel names,
  with and without the resize), ``load_bbox``, ``Cap3DCaptions``,
  ``composite_rgba`` and the png loader (grey and palette images).
* ``MultiViewObjaverseRaw`` over a raw render tree (all views, chosen
  ``view_ids``, captions, renders resized to the target) and
  ``RealDataset`` (png and jpg, both encoder normalisations).
"""

import json
import os

import numpy as np
import pytest
import torch

from ln3diff_tpu.data import exr as jexr
from ln3diff_tpu.data import objaverse_raw as jraw
from ln3diff_tpu_torch.data import exr as texr
from ln3diff_tpu_torch.data import objaverse_raw as traw

from test_torch_data import same

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _channels(H, W, dtype, seed=0, smooth=True):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    out = {}
    for i, name in enumerate(('A', 'B', 'G', 'R')):
        if smooth:
            v = np.sin(xx * 0.3 + i) * 2 + yy * 0.1
        else:
            v = rng.standard_normal((H, W)) * 100
        if dtype == np.uint32:
            v = np.abs(v * 1000).astype(np.uint32)
        out[name] = v.astype(dtype)
    return out


@pytest.mark.parametrize('compression', [0, 2, 3])
@pytest.mark.parametrize('dtype', [np.float16, np.float32, np.uint32])
def test_exr_roundtrip_matches_jax(tmp_path, compression, dtype):
    for H, W, smooth in ((37, 19, True), (16, 8, False)):
        chans = _channels(H, W, dtype, smooth=smooth)
        tp, jp = str(tmp_path / 't.exr'), str(tmp_path / 'j.exr')
        texr.write_exr(tp, chans, compression)
        jexr.write_exr(jp, chans, compression)
        assert open(tp, 'rb').read() == open(jp, 'rb').read()
        want = jexr.read_exr(jp)
        same(texr.read_exr(jp), want)
        same(jexr.read_exr(tp), want)
        for k, v in chans.items():
            np.testing.assert_array_equal(want[k], v.astype(np.float32))


def test_exr_widens_other_dtypes_and_refuses_what_it_lacks(tmp_path):
    p = str(tmp_path / 'x.exr')
    texr.write_exr(p, {'Y': np.arange(12, dtype=np.float64).reshape(3, 4)})
    same(texr.read_exr(p), jexr.read_exr(p))
    buf = bytearray(open(p, 'rb').read())
    buf[5] |= 0x02           # the tiled bit (0x200) of the version field
    open(p, 'wb').write(bytes(buf))
    with pytest.raises(AssertionError, match='tiled'):
        texr.read_exr(p)


def test_exr_predictor_matches_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 64, 1001):
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        enc = texr._predictor_encode(raw)
        assert enc == jexr._predictor_encode(raw)
        assert texr._predictor_decode(enc) == jexr._predictor_decode(enc) \
            == raw


def test_intrinsics_and_camera_helpers_match_jax(tmp_path):
    for h, w, norm in ((256, None, False), (128, 96, True), (1024, None,
                                                             True)):
        same(traw.get_intrinsics(h, w, norm), jraw.get_intrinsics(h, w, norm))
    p = str(tmp_path / 'cam.json')
    json.dump({'x': [0.0, 1.0, 0.0], 'y': [0.0, 0.0, 1.0],
               'z': [1.0, 0.0, 0.0], 'origin': [1.2, -0.3, 0.7]},
              open(p, 'w'))
    c2w = traw.read_camera_matrix_single(p)
    same(c2w, jraw.read_camera_matrix_single(p))
    same(traw.camera_25d(c2w, 64), jraw.camera_25d(c2w, 64))
    n = np.random.default_rng(0).standard_normal((5, 6, 3)).astype(
        np.float32)
    same(traw.unity2blender_fix(n), jraw.unity2blender_fix(n))
    for m in (np.zeros((6, 6)), np.pad(np.ones((2, 3)), ((1, 3), (2, 1)))):
        same(traw.load_bbox(m), jraw.load_bbox(m))


@pytest.mark.parametrize('names,resize', [('RGBA', None), ('RGBA', 8),
                                          ('XYZW', 6)])
def test_read_dnormal_matches_jax(tmp_path, names, resize):
    rng = np.random.default_rng(4)
    chans = {c: rng.uniform(0.0, 3.0, (12, 12)).astype(np.float32)
             for c in names}
    p = str(tmp_path / 'x_nd.exr')
    texr.write_exr(p, chans)
    pos = np.array([[1.2], [0.4], [0.9]])
    kw = dict(h=resize, w=resize) if resize else {}
    got = traw.read_dnormal(p, pos, **kw)
    want = jraw.read_dnormal(p, pos, **kw)
    same(got, want)
    assert (got[0] == 0).any() and (got[0] > 0).any()


def test_captions_and_png_helpers_match_jax(tmp_path):
    from PIL import Image
    caps = str(tmp_path / 'caps.json')
    json.dump({'fold/abc': 'a chair', 'xyz': 'a lamp'}, open(caps, 'w'))
    t, j = traw.Cap3DCaptions(caps), jraw.Cap3DCaptions(caps)
    for ins in ('/data/fold/abc', 'xyz', 'other/xyz/', 'none'):
        assert t(ins) == j(ins)
    rng = np.random.default_rng(5)
    imgs = {
        'rgba.png': Image.fromarray(rng.integers(0, 255, (9, 9, 4),
                                                 dtype=np.uint8)),
        'grey.png': Image.fromarray(rng.integers(0, 255, (9, 9),
                                                 dtype=np.uint8)),
        'palette.png': Image.fromarray(rng.integers(
            0, 255, (9, 9, 3), dtype=np.uint8)).convert('P'),
    }
    for name, im in imgs.items():
        p = str(tmp_path / name)
        im.save(p)
        raw = traw._load_png(p)
        same(raw, jraw._load_png(p))
        same(traw.composite_rgba(raw), jraw.composite_rgba(raw))


def write_raw_tree(root, n_instances=2, n_views=3, res=24, seed=0):
    """A raw G-Objaverse render tree: ``{ins}/{idx:05d}/{idx:05d}.png``
    (RGBA), ``.json`` (camera) and ``_nd.exr`` (normal RGB, depth A)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for i in range(n_instances):
        for v in range(n_views):
            d = os.path.join(root, f'ins{i:03d}', f'{v:05d}')
            os.makedirs(d, exist_ok=True)
            base = os.path.join(d, f'{v:05d}')
            ang = 2 * np.pi * v / n_views
            origin = [1.5 * np.cos(ang), 1.5 * np.sin(ang), 0.3]
            json.dump({'x': [-np.sin(ang), np.cos(ang), 0.0],
                       'y': [0.0, 0.0, 1.0],
                       'z': [np.cos(ang), np.sin(ang), 0.0],
                       'origin': origin}, open(base + '.json', 'w'))
            rgba = rng.integers(0, 255, (res, res, 4), dtype=np.uint8)
            rgba[: res // 3, :, 3] = 0
            Image.fromarray(rgba).save(base + '.png')
            depth = rng.uniform(0.0, 2.5, (res, res)).astype(np.float32)
            chans = {c: rng.standard_normal((res, res)).astype(np.float16)
                     for c in 'RGB'}
            chans['A'] = depth
            texr.write_exr(base + '_nd.exr', chans)
    return root


@pytest.mark.parametrize('kw', [dict(resolution=24), dict(resolution=16),
                                dict(resolution=24, view_ids=[2, 0])])
def test_multiview_objaverse_raw_matches_jax(tmp_path, kw):
    root = write_raw_tree(str(tmp_path / 'raw'))
    caps = str(tmp_path / 'caps.json')
    json.dump({'ins001': 'a thing'}, open(caps, 'w'))
    got = list(traw.MultiViewObjaverseRaw(
        root, captions=traw.Cap3DCaptions(caps), **kw))
    want = list(jraw.MultiViewObjaverseRaw(
        root, captions=jraw.Cap3DCaptions(caps), **kw))
    assert len(got) == 2
    same(got, want)
    assert got[1]['caption'] == 'a thing' and got[0]['caption'] == ''
    n = len(kw.get('view_ids', [0, 1, 2]))
    assert got[0]['rgb'].shape == (n, kw['resolution'], kw['resolution'], 3)


@pytest.mark.parametrize('imgnet', [True, False])
def test_real_dataset_matches_jax(tmp_path, imgnet):
    from PIL import Image
    rng = np.random.default_rng(6)
    Image.fromarray(rng.integers(0, 255, (20, 20, 4), dtype=np.uint8)).save(
        tmp_path / 'a.png')
    Image.fromarray(rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)).save(
        tmp_path / 'b.jpg')
    (tmp_path / 'notes.txt').write_text('skip me')
    t = traw.RealDataset(str(tmp_path), 16, 12, imgnet)
    j = jraw.RealDataset(str(tmp_path), 16, 12, imgnet)
    assert len(t) == len(j) == 2
    for i in range(2):
        same(t[i], j[i])
