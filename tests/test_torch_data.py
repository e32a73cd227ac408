"""The port's shard IO and G-Objaverse post-processing
(``ln3diff_tpu_torch/data/wds.py``, ``data/objaverse.py``) against the JAX
package's, on shards that the tests write.

Both packages keep these in numpy on the host, the same code, so every
comparison is exact: arrays bit for bit (``assert_array_equal`` with equal
dtypes), keys and their order equal, strings equal.

* Shards: the port's ``ShardWriter`` writes the same tar bytes as JAX's,
  and each package's ``iter_shard`` reads the other's shards to the same
  samples; ``encode_field``/``decode_field`` for npy, npz, json, txt, raw
  bytes and gz (lz4 when the package is importable).
* The stream: ``resampled_shards``, ``shuffled``, ``collate`` and
  ``load_wds_data`` give JAX's batches in JAX's order for each ``(seed,
  rank, num_replicas)``, in the infinite (resampled) and the finite
  (strided) mode, as ``tests/test_host_decorrelation.py`` checks for JAX.
* ``resize_image`` (PIL LANCZOS for uint8 RGB, BILINEAR per float
  channel), ``canonicalize_poses``, ``PostProcess`` (uint8 and float rgb,
  with and without alpha, canonical frame 0, the paired ``nv_*`` views,
  wrap-around when no view is spare) and ``DiffPostProcess``.
"""

import os

import numpy as np
import pytest
import torch

from ln3diff_tpu.data import objaverse as jobj
from ln3diff_tpu.data import synthetic as jsyn
from ln3diff_tpu.data import wds as jwds
from ln3diff_tpu_torch.data import objaverse as tobj
from ln3diff_tpu_torch.data import wds as twds

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def same(a, b, path='sample'):
    """``a`` and ``b`` equal bit for bit: dicts with their keys in order,
    arrays in dtype, shape and bytes, everything else by ``==``."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            same(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _samples(n=7):
    rng = np.random.default_rng(0)
    for i in range(n):
        yield f'{i:06d}', {
            'rgb.npy': rng.integers(0, 255, (2, 4, 4, 3), dtype=np.uint8),
            'latent.npy': rng.standard_normal((4, 4, 3)).astype(np.float32),
            'caption.txt': f'object {i}',
            'meta.json': {'idx': i, 'tags': ['a', 'b']},
            'blob.bin': bytes([i, 255 - i, 7]),
        }


def _write(writer_cls, pattern, maxcount=3, n=7):
    w = writer_cls(pattern, maxcount=maxcount)
    for key, sample in _samples(n):
        w.write(key, sample)
    w.close()
    return w.paths


@pytest.mark.parametrize('pattern', ['s-%06d.tar', 'shard'])
def test_shard_writer_writes_jax_bytes(tmp_path, pattern):
    (tmp_path / 'j').mkdir()
    (tmp_path / 't').mkdir()
    jp = _write(jwds.ShardWriter, str(tmp_path / 'j' / pattern))
    tp = _write(twds.ShardWriter, str(tmp_path / 't' / pattern))
    assert [os.path.basename(p) for p in jp] == \
        [os.path.basename(p) for p in tp]
    assert len(tp) == 3
    for a, b in zip(jp, tp):
        assert open(a, 'rb').read() == open(b, 'rb').read()


def test_iter_shard_reads_either_package_shards(tmp_path):
    (tmp_path / 'j').mkdir()
    (tmp_path / 't').mkdir()
    jp = _write(jwds.ShardWriter, str(tmp_path / 'j' / 's-%06d.tar'))
    tp = _write(twds.ShardWriter, str(tmp_path / 't' / 's-%06d.tar'))
    want = [s for p in jp for s in jwds.iter_shard(p)]
    assert len(want) == 7
    for paths in (jp, tp):
        same([s for p in paths for s in twds.iter_shard(p)], want)
    same([s for p in tp for s in jwds.iter_shard(p)], want)


def _gz(data: bytes) -> bytes:
    import gzip
    return gzip.compress(data, mtime=0)


@pytest.mark.parametrize('field,value', [
    ('x.npy', np.arange(12, dtype=np.int16).reshape(3, 4)),
    ('x.txt', 'a caption'),
    ('x.json', {'k': [1, 2.5, None]}),
    ('x.bin', b'\x00\x01raw'),
])
def test_encode_decode_fields(field, value):
    data = twds.encode_field(field, value)
    assert data == jwds.encode_field(field, value)
    same(twds.decode_field(field, data), jwds.decode_field(field, data))
    gz = _gz(data)
    same(twds.decode_field(field + '.gz', gz),
         jwds.decode_field(field + '.gz', gz))
    with pytest.raises(TypeError):
        twds.encode_field('x.bin', 3)


def test_decode_npz():
    import io
    buf = io.BytesIO()
    np.savez(buf, a=np.arange(3.0), b=np.ones((2, 2), np.uint8))
    data = buf.getvalue()
    same(twds.decode_field('x.npz', data), jwds.decode_field('x.npz', data))


def test_decode_lz4():
    lz4 = pytest.importorskip('lz4.frame')
    data = lz4.compress(twds.encode_field('x.npy', np.arange(5)))
    same(twds.decode_field('x.npy.lz4', data),
         jwds.decode_field('x.npy.lz4', data))


def test_resampled_and_shuffled_match_jax():
    paths = [f'p{i}' for i in range(5)]
    a = twds.resampled_shards(paths, np.random.default_rng(4))
    b = jwds.resampled_shards(paths, np.random.default_rng(4))
    assert [next(a) for _ in range(20)] == [next(b) for _ in range(20)]
    for n, buf in ((10, 4), (3, 8), (9, 1)):
        assert list(twds.shuffled(iter(range(n)), buf,
                                  np.random.default_rng(2))) == \
            list(jwds.shuffled(iter(range(n)), buf, np.random.default_rng(2)))


def test_collate_matches_jax():
    batch = [dict(s, __key__=k) for k, s in _samples(3)]
    for s in batch:
        del s['meta.json'], s['blob.bin']
    same(twds.collate(batch), jwds.collate(batch))


@pytest.fixture(scope='module')
def small_shards(tmp_path_factory):
    d = tmp_path_factory.mktemp('stream')
    w = twds.ShardWriter(str(d / 'objv-%06d.tar'), maxcount=3)
    for k in range(12):
        w.write(f'{k:06d}', {'x.npy': np.asarray([k]),
                             'caption.txt': f'c{k}'})
    w.close()
    return w.paths


@pytest.mark.parametrize('seed,rank,replicas,infinite,buf', [
    (3, 0, 2, True, 4), (3, 1, 2, True, 4), (0, 0, 1, True, 1),
    (0, 0, 2, False, 1), (0, 1, 2, False, 1), (5, 1, 3, False, 4),
    (5, 2, 3, True, 1)])
def test_load_wds_data_draws_jax_order(small_shards, seed, rank, replicas,
                                       infinite, buf):
    kw = dict(batch_size=2, shuffle_buffer=buf, seed=seed, rank=rank,
              num_replicas=replicas, infinite=infinite)
    a = twds.load_wds_data(small_shards, **kw)
    b = jwds.load_wds_data(small_shards, **kw)
    n = 12 if infinite else 100
    got = [x for _, x in zip(range(n), a)]
    want = [x for _, x in zip(range(n), b)]
    assert len(got) == len(want) > 0
    same(got, want)


def test_load_wds_data_defaults_to_this_process(small_shards):
    """Without a process group the defaults are rank 0 of 1."""
    a = twds.load_wds_data(small_shards, 2, seed=1)
    b = jwds.load_wds_data(small_shards, 2, seed=1, rank=0, num_replicas=1)
    same([next(a) for _ in range(5)], [next(b) for _ in range(5)])


def test_finite_mode_strides_shards_disjoint(small_shards):
    seen = []
    for rank in range(2):
        it = twds.load_wds_data(small_shards, batch_size=1, shuffle_buffer=1,
                                seed=0, infinite=False, rank=rank,
                                num_replicas=2)
        seen.append({int(b['x.npy'].ravel()[0]) for b in it})
    assert not seen[0] & seen[1]
    assert seen[0] | seen[1] == set(range(12))


# -- post-processing -----------------------------------------------------------

@pytest.mark.parametrize('case', ['uint8_rgb', 'float_rgb', 'float_2d',
                                  'uint8_rgba', 'float_5ch', 'same_size'])
def test_resize_image_matches_jax(case):
    rng = np.random.default_rng(1)
    img = {
        'uint8_rgb': rng.integers(0, 255, (24, 24, 3), dtype=np.uint8),
        'float_rgb': rng.random((24, 24, 3)).astype(np.float32),
        'float_2d': rng.random((24, 24)).astype(np.float32),
        'uint8_rgba': rng.integers(0, 255, (24, 24, 4), dtype=np.uint8),
        'float_5ch': rng.random((24, 24, 5)).astype(np.float32),
        'same_size': rng.random((16, 16, 3)).astype(np.float32),
    }[case]
    same(tobj.resize_image(img, 16), jobj.resize_image(img, 16))


def test_canonicalize_poses_matches_jax():
    c = jsyn.make_multiview_batch(4, 16, 16, seed=3)['c'].astype(np.float64)
    for anchor in (0, 2):
        out = tobj.canonicalize_poses(c, anchor)
        same(out, jobj.canonicalize_poses(c, anchor))
        np.testing.assert_allclose(out[anchor, :16], np.eye(4).ravel(),
                                   atol=1e-12)


def _raw(V=4, H=32, uint8=False, alpha=True, seed=0):
    b = jsyn.make_multiview_batch(num_views=V, resolution=H,
                                  render_resolution=H, seed=seed)
    rgb = ((b['img_hr'] + 1) / 2).astype(np.float32)
    if uint8:
        rgb = np.clip(rgb * 255, 0, 255).astype(np.uint8)
    out = {'rgb.npy': rgb, 'depth.npy': b['depth'].astype(np.float32),
           'c.npy': b['c'], 'caption.txt': 'a sphere', '__key__': '000007'}
    if alpha:
        out['alpha.npy'] = b['depth_mask'].astype(np.float32)
    return out


PP_CASES = {
    'default': (dict(reso_encoder=32, reso_render=16), {}),
    'uint8_no_alpha': (dict(reso_encoder=32, reso_render=16),
                       dict(uint8=True, alpha=False)),
    'canonical_no_depth_no_plucker': (
        dict(reso_encoder=24, reso_render=16, frame_0_as_canonical=True,
             append_depth=False, plucker=False), {}),
    'no_nv': (dict(reso_encoder=32, reso_render=32, num_views_sup=0), {}),
    'nv_wraps': (dict(reso_encoder=32, reso_render=16, num_views_input=4,
                      num_views_sup=3), {}),
    'three_of_six': (dict(reso_encoder=16, reso_render=8, num_views_input=3,
                          num_views_sup=2), dict(V=6)),
}


@pytest.mark.parametrize('case', list(PP_CASES))
def test_post_process_matches_jax(case):
    kw, raw_kw = PP_CASES[case]
    raw = _raw(**raw_kw)
    got = tobj.PostProcess(**kw)(raw)
    same(got, jobj.PostProcess(**kw)(raw))
    V = raw['rgb.npy'].shape[0]
    n_in = min(kw.get('num_views_input', 4), V)
    assert got['img_to_encoder'].shape[0] == n_in
    assert ('nv_img' in got) == (kw.get('num_views_sup', 2) > 0)


def test_diff_post_process_matches_jax():
    rng = np.random.default_rng(2)
    sample = {'latent.npy': rng.standard_normal((4, 4, 12)).astype(
        np.float16), 'caption.txt': 'x', 'img.npy': rng.random((8, 8, 3)),
        'c.npy': rng.random(25)}
    for s in (sample, {'latent.npy': sample['latent.npy']}):
        same(tobj.DiffPostProcess()(s), jobj.DiffPostProcess()(s))


def test_shards_through_post_process_match_jax(tmp_path):
    """The production flow: shards of synthetic instances, streamed with
    ``PostProcess`` by each package, the same batches."""
    w = twds.ShardWriter(str(tmp_path / 'objv-%06d.tar'), maxcount=2)
    for i in range(3):
        raw = _raw(V=3, H=32, seed=i)
        del raw['__key__']
        w.write(f'{i:06d}', raw)
    w.close()
    kw = dict(batch_size=2, shuffle_buffer=2, seed=1, rank=0,
              num_replicas=1)
    pp = dict(reso_encoder=32, reso_render=16, num_views_input=2,
              num_views_sup=1)
    a = twds.load_wds_data(w.paths, transform=tobj.PostProcess(**pp), **kw)
    b = jwds.load_wds_data(w.paths, transform=jobj.PostProcess(**pp), **kw)
    same([next(a) for _ in range(3)], [next(b) for _ in range(3)])
