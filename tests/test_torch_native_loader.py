"""The port's native tar-shard reader (``ln3diff_tpu_torch/native/
shard_loader.cpp`` through ``native/build.py``) against the ``tarfile``
path and the JAX package's reader, on shards that the tests write.

* ``NativeShardReader``'s raw entries equal ``tarfile``'s, names and bytes
  in order, GNU long names and empty members included; ``loop`` repeats
  the shard list.
* ``iter_shards_native`` gives the samples of ``iter_shard`` and of JAX's
  ``iter_shards_native``, bit for bit.
* A reader whose source does not build raises with the compiler's log:
  the port does not read through ``tarfile`` instead, as JAX's
  ``iter_shards_native`` does (``ROADMAP.md`` §3).

g++ builds the reader into ``ln3diff_tpu_torch/_build/`` at first use.
"""

import io
import os
import tarfile

import numpy as np
import pytest
import torch

from ln3diff_tpu.data import wds as jwds
from ln3diff_tpu_torch.data import wds as twds
from ln3diff_tpu_torch.native import build as nbuild
from ln3diff_tpu_torch.ops import _build

from test_torch_data import same

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _write_shards(tmp_path, n_samples=7, maxcount=3):
    rng = np.random.default_rng(0)
    w = twds.ShardWriter(str(tmp_path / 'shard'), maxcount=maxcount)
    for i in range(n_samples):
        w.write(f'{i:05d}', {
            'latent.npy': rng.standard_normal((4, 4, 3)).astype(np.float32),
            'caption.txt': f'sample number {i}',
        })
    w.close()
    return w.paths


def _tar_entries(paths):
    out = []
    for p in paths:
        with tarfile.open(p) as tar:
            for m in tar:
                if m.isfile():
                    out.append((m.name, tar.extractfile(m).read()))
    return out


def test_raw_entries_match_tarfile(tmp_path):
    paths = _write_shards(tmp_path)
    long = tmp_path / 'long.tar'
    with tarfile.open(long, 'w', format=tarfile.GNU_FORMAT) as tar:
        for name, data in ((('k' * 120) + '.caption.txt', b'long name'),
                           ('dir/sub/00009.empty.bin', b''),
                           ('00010.latent.npy', b'\x93NUMPY' * 100)):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        d = tarfile.TarInfo('a_dir')
        d.type = tarfile.DIRTYPE
        tar.addfile(d)
    paths = paths + [str(long)]
    reader = nbuild.NativeShardReader(paths)
    assert list(reader) == _tar_entries(paths)
    reader.close()


def test_loop_mode_repeats(tmp_path):
    paths = _write_shards(tmp_path, n_samples=2, maxcount=10)
    reader = nbuild.NativeShardReader(paths, loop=True)
    seen = [next(reader)[0] for _ in range(10)]
    reader.close()
    assert seen[:4] == [n for n, _ in _tar_entries(paths)]
    assert seen[4:8] == seen[:4]


@pytest.mark.parametrize('maxcount', [3, 10])
def test_iter_shards_native_matches_tarfile_and_jax(tmp_path, maxcount):
    paths = _write_shards(tmp_path, maxcount=maxcount)
    want = [s for p in paths for s in twds.iter_shard(p)]
    assert len(want) == 7
    same(list(twds.iter_shards_native(paths)), want)
    same(list(jwds.iter_shards_native(paths)), want)
    looped = twds.iter_shards_native(paths, loop=True)
    same([next(looped) for _ in range(9)], want + want[:2])


def test_a_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    src = tmp_path / 'native'
    src.mkdir()
    (src / 'shard_loader.cpp').write_text(
        'extern "C" int broken( { return 0; }\n')
    monkeypatch.setattr(_build, 'NATIVE', src)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, 'LIBRARIES', _build._Libraries())
    paths = _write_shards(tmp_path, n_samples=2)
    with pytest.raises(RuntimeError, match='building shard_loader failed') \
            as err:
        next(twds.iter_shards_native(paths))
    assert 'error' in str(err.value)
    assert not list((tmp_path / 'build').glob('*.so'))
