"""The port's data CLIs (``ln3diff_tpu_torch/scripts/{wds_create,
lmdb_create,profile_dataloading}.py``), LMDB/directory readers
(``data/lmdb_reader.py``) and EG3D image-folder dataset (``data/eg3d.py``)
against the JAX package's scripts and modules, on files that the tests
write.  Numpy on both sides: arrays bit for bit, keys in order.

* ``wds_create`` with the synthetic source and with a raw g-buffer tree
  writes the same shard bytes as ``scripts/wds_create.py`` (run in this
  process); ``lmdb_create`` the same directory dataset; both read back by
  either package.
* ``profile_dataloading`` over the synthetic batch, shards and a directory
  dataset: it prints its rates (nothing asserts a rate).
* ``compress_array``/``decompress_array`` (gzip, none; lz4 when
  importable), ``DirectoryDataset`` written by either package and read by
  the other, ``load_data``'s batches for each ``(seed, rank,
  num_replicas)``; without the lmdb package the LMDB classes raise and
  name it, and with it (``importorskip``) a written LMDB reads back.
* ``ImageFolderDataset`` over a folder (nested, labels for some files
  only, resized) and over a zip, ``init_dataset_kwargs`` and
  ``load_eg3d_data`` for each ``(seed, rank)``.
"""

import importlib.util
import json
import os
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from ln3diff_tpu.data import eg3d as jeg3d
from ln3diff_tpu.data import lmdb_reader as jlmdb
from ln3diff_tpu.data import wds as jwds
from ln3diff_tpu_torch.data import eg3d as teg3d
from ln3diff_tpu_torch.data import lmdb_reader as tlmdb
from ln3diff_tpu_torch.data import wds as twds
from ln3diff_tpu_torch.scripts import lmdb_create, profile_dataloading
from ln3diff_tpu_torch.scripts import wds_create

from test_torch_data import same
from test_torch_objaverse_raw import write_raw_tree

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parents[1] / 'scripts'


def _jax_script(name):
    """``scripts/<name>.py`` of the JAX package, loaded under its own
    module name."""
    spec = importlib.util.spec_from_file_location(f'jax_script_{name}',
                                                  SCRIPTS / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name, argv, monkeypatch):
    monkeypatch.setattr('sys.argv', [f'{name}.py', *argv])
    _jax_script(name).main()


def _read_all(paths, iter_shard):
    return [s for p in paths for s in iter_shard(p)]


@pytest.mark.parametrize('source', ['synthetic', 'gbuffer'])
def test_wds_create_writes_jax_shards(tmp_path, monkeypatch, source):
    argv = ['--num_instances', '3', '--num_views', '2', '--resolution', '16',
            '--maxcount', '2']
    if source == 'gbuffer':
        root = write_raw_tree(str(tmp_path / 'raw'), n_instances=3,
                              n_views=3, res=24)
        caps = tmp_path / 'caps.json'
        caps.write_text(json.dumps({'ins002': 'a thing'}))
        argv += ['--source', 'gbuffer', '--source_dir', root, '--captions',
                 str(caps), '--view_ids', '2,0']
    paths = wds_create.main(['--out', str(tmp_path / 't' / 'objv-%06d.tar'),
                             *argv])
    _run_jax('wds_create', ['--out', str(tmp_path / 'j' / 'objv-%06d.tar'),
                            *argv], monkeypatch)
    jpaths = sorted(str(p) for p in (tmp_path / 'j').glob('*.tar'))
    assert len(paths) == len(jpaths) == 2
    for a, b in zip(paths, jpaths):
        assert open(a, 'rb').read() == open(b, 'rb').read()
    got = _read_all(paths, twds.iter_shard)
    same(got, _read_all(jpaths, jwds.iter_shard))
    assert len(got) == 3 and got[0]['rgb.npy'].dtype == np.float32
    if source == 'gbuffer':
        assert got[2]['caption.txt'] == 'a thing'
        assert got[0]['rgb.npy'].shape == (2, 16, 16, 3)


def test_lmdb_create_writes_jax_directory(tmp_path, monkeypatch):
    argv = ['--num_instances', '2', '--num_views', '2', '--resolution', '16',
            '--format', 'directory', '--seed', '3']
    n, kind = lmdb_create.main(['--out', str(tmp_path / 't'), *argv])
    assert (n, kind) == (2, 'directory')
    _run_jax('lmdb_create', ['--out', str(tmp_path / 'j'), *argv],
             monkeypatch)
    names = sorted(os.listdir(tmp_path / 't'))
    assert names == sorted(os.listdir(tmp_path / 'j'))
    for f in names:
        assert (tmp_path / 't' / f).read_bytes() == \
            (tmp_path / 'j' / f).read_bytes()
    t, j = tlmdb.DirectoryDataset(str(tmp_path / 't')), \
        jlmdb.DirectoryDataset(str(tmp_path / 'j'))
    assert len(t) == len(j) == 2
    for i in range(2):
        same(t[i], j[i])
    # the .npz raw source
    raw = tmp_path / 'npz'
    raw.mkdir()
    for i in range(2):
        np.savez(raw / f'{i}.npz', img=np.full((2, 4, 4, 3), i, np.float32),
                 c=np.arange(25, dtype=np.float32) + i)
    lmdb_create.main(['--out', str(tmp_path / 't2'), '--raw_dir', str(raw),
                      '--format', 'directory'])
    same(tlmdb.DirectoryDataset(str(tmp_path / 't2'))[1],
         {'img': np.full((2, 4, 4, 3), 1, np.float32),
          'c': np.arange(25, dtype=np.float32) + 1})


def test_profile_dataloading_runs_each_path(tmp_path, capsys):
    rates = profile_dataloading.main(['--batch_size', '2', '--num_batches',
                                      '3', '--resolution', '16'])
    assert list(rates) == ['synthetic']
    paths = wds_create.main(['--out', str(tmp_path / 's-%06d.tar'),
                             '--num_instances', '3', '--num_views', '2',
                             '--resolution', '16'])
    rates = profile_dataloading.main(['--path', str(tmp_path / '*.tar'),
                                      '--batch_size', '2', '--num_batches',
                                      '3', '--resolution', '16'])
    assert list(rates) == ['synthetic', 'wds'] and len(paths) == 1
    lmdb_create.main(['--out', str(tmp_path / 'ds'), '--num_instances', '2',
                      '--num_views', '2', '--resolution', '16',
                      '--format', 'directory'])
    rates = profile_dataloading.main(['--path', str(tmp_path / 'ds'),
                                      '--batch_size', '2', '--num_batches',
                                      '2', '--resolution', '16'])
    assert list(rates) == ['synthetic', 'dataset']
    assert all(r[0] > 0 for r in rates.values())
    out = capsys.readouterr().out
    assert 'batches/s' in out and 'dataset' in out


# -- LMDB / directory datasets --------------------------------------------------

@pytest.mark.parametrize('method', ['gzip', 'none', 'lz4'])
def test_compression_matches_jax(method):
    if method == 'lz4':
        pytest.importorskip('lz4.frame')
    arr = np.random.default_rng(0).standard_normal((8, 8, 3)).astype(
        np.float32)
    for data in (tlmdb.compress_array(arr, method),
                 jlmdb.compress_array(arr, method)):
        same(tlmdb.decompress_array(data, method),
             jlmdb.decompress_array(data, method))
        same(tlmdb.decompress_array(data, method), arr)
    if method == 'none':
        assert tlmdb.compress_array(arr, 'none') == \
            jlmdb.compress_array(arr, 'none')


def _dir_samples(n=5):
    return [{'raw_img': np.full((4, 4, 3), i, np.uint8),
             'c': np.arange(25, dtype=np.float32) + i,
             'ins': np.asarray([i], np.int64)} for i in range(n)]


def test_directory_dataset_crosses_packages(tmp_path):
    tlmdb.DirectoryDataset.write(str(tmp_path / 't'), iter(_dir_samples()))
    jlmdb.DirectoryDataset.write(str(tmp_path / 'j'), iter(_dir_samples()))
    for d in ('t', 'j'):
        t = tlmdb.DirectoryDataset(str(tmp_path / d))
        j = jlmdb.DirectoryDataset(str(tmp_path / d))
        assert t.indices == j.indices == list(range(5))
        for i in range(5):
            same(t[i], j[i])
    for f in os.listdir(tmp_path / 't'):
        assert (tmp_path / 't' / f).read_bytes() == \
            (tmp_path / 'j' / f).read_bytes()


@pytest.mark.parametrize('seed,rank,replicas', [(0, 0, 1), (2, 1, 2),
                                                (5, 2, 3)])
def test_load_data_draws_jax_order(tmp_path, seed, rank, replicas):
    tlmdb.DirectoryDataset.write(str(tmp_path), iter(_dir_samples(7)))
    ds = tlmdb.DirectoryDataset(str(tmp_path))
    kw = dict(rank=rank, num_replicas=replicas, seed=seed)
    a = tlmdb.load_data(ds, 3, **kw)
    b = jlmdb.load_data(jlmdb.DirectoryDataset(str(tmp_path)), 3, **kw)
    same([next(a) for _ in range(6)], [next(b) for _ in range(6)])


def test_lmdb_classes_name_the_missing_package(tmp_path, monkeypatch):
    monkeypatch.setattr(tlmdb, '_lmdb', None)
    for cls in (tlmdb.LMDBDataset, tlmdb.LMDBWriter):
        with pytest.raises(AssertionError, match='lmdb'):
            cls(str(tmp_path / 'x'))


def test_lmdb_roundtrip_matches_jax(tmp_path):
    pytest.importorskip('lmdb')
    w = tlmdb.LMDBWriter(str(tmp_path / 'db'), map_size=2**24)
    for s in _dir_samples(3):
        w.write(s)
    w.close()
    t = tlmdb.LMDBDataset(str(tmp_path / 'db'))
    j = jlmdb.LMDBDataset(str(tmp_path / 'db'))
    assert len(t) == len(j) == 3
    for i in range(3):
        same(t[i], j[i])


# -- EG3D image folders ---------------------------------------------------------

def _folder(root, n=4, res=24, labelled=(0, 2)):
    from PIL import Image
    rng = np.random.default_rng(0)
    labels = []
    for i in range(n):
        fname = f'sub{i % 2}/img{i:04d}.png'
        os.makedirs(os.path.join(root, f'sub{i % 2}'), exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (res, res, 3),
                                     dtype=np.uint8)).save(
            os.path.join(root, fname))
        if i in labelled:
            labels.append([fname, list(rng.standard_normal(25))])
    with open(os.path.join(root, 'dataset.json'), 'w') as f:
        json.dump({'labels': labels}, f)
    return root


def _zip(path, folder):
    with zipfile.ZipFile(path, 'w') as z:
        for dirpath, _, files in os.walk(folder):
            for f in files:
                full = os.path.join(dirpath, f)
                z.write(full, os.path.relpath(full, folder))
    return str(path)


@pytest.mark.parametrize('kind,resolution,labels', [
    ('folder', None, True), ('folder', 16, False), ('zip', 16, True)])
def test_image_folder_dataset_matches_jax(tmp_path, kind, resolution,
                                          labels):
    path = _folder(str(tmp_path / 'faces'))
    if kind == 'zip':
        path = _zip(tmp_path / 'faces.zip', path)
    t = teg3d.ImageFolderDataset(path, resolution, labels)
    j = jeg3d.ImageFolderDataset(path, resolution, labels)
    assert t.files == j.files and len(t) == 4 and t.label_dim == 25
    for i in range(4):
        same(t[i], j[i])
    ident = t[t.files.index('sub1/img0001.png')]['c']
    assert ident.sum() == 7.0 and ident[0] == ident[16] == 1.0
    assert (t[t.files.index('sub0/img0000.png')]['c'].sum() != 7.0) == labels
    same(teg3d.init_dataset_kwargs(path, resolution),
         jeg3d.init_dataset_kwargs(path, resolution))


def test_image_folder_needs_images(tmp_path):
    with pytest.raises(FileNotFoundError):
        teg3d.ImageFolderDataset(str(tmp_path))


@pytest.mark.parametrize('seed,rank', [(0, None), (3, 1)])
def test_load_eg3d_data_draws_jax_order(tmp_path, seed, rank):
    path = _folder(str(tmp_path / 'faces'))
    a = teg3d.load_eg3d_data(path, 3, resolution=16, seed=seed, rank=rank)
    b = jeg3d.load_eg3d_data(path, 3, resolution=16, seed=seed,
                             rank=0 if rank is None else rank)
    same([next(a) for _ in range(3)], [next(b) for _ in range(3)])
