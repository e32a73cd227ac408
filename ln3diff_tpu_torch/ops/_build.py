"""Build the port's native sources and load them with ``ctypes``.

Two kinds of source, each exposing a plain ``extern "C"`` interface:

* ``ops/csrc/<name>.cu``: CUDA kernels, compiled by ``nvcc`` for sm_90a
  without PyTorch's headers, so each builds in seconds;
* ``native/<name>.cpp``: host code of the mesh stage (marching
  tetrahedra, the OBJ/PLY writers) and of the data layer (the threaded
  tar-shard reader), compiled by ``g++``.

A shared library goes to ``ln3diff_tpu_torch/_build/<name>-<hash>.so``,
where the hash covers the source (for CUDA, every file in ``csrc/``), the
compiler and the flags: a changed source builds anew, an unchanged one is
reused.  The compiler writes to a temporary name that is renamed into
place, so an interrupted build leaves nothing half-written, and no lock
file is taken that could be left behind.

Nothing here runs at import time; the first call that needs a library
builds it.  :func:`launch` calls a C entry point with the current CUDA
stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / 'ops' / 'csrc'
NATIVE = PACKAGE / 'native'
BUILD_DIR = PACKAGE / '_build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
# the flags the JAX package builds the same sources with, so that both
# march a σ grid to the same triangles on one machine
GXX_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC', '-std=c++17')
# per-source g++ flags after GXX_FLAGS, as the JAX package passes them
GXX_EXTRA = {'shard_loader': ('-pthread',)}


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float        # compile wall time; 0.0 when the file was reused
    log: str              # the compiler's stderr (nvcc: the -Xptxas -v report)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on PATH."""
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and os.path.exists(os.path.join(cand, 'bin', 'nvcc')):
            return os.path.join(cand, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit (set CUDA_HOME)')
    return found


def _source(name: str) -> tuple[Path, list[Path], list[str]]:
    """(source, files its hash covers, compiler command without -o)."""
    cu = CSRC / f'{name}.cu'
    if cu.exists():
        deps = sorted(CSRC.glob('*.cu*')) + sorted(CSRC.glob('*.h'))
        return cu, deps, [nvcc_path(), *NVCC_FLAGS]
    cpp = NATIVE / f'{name}.cpp'
    if cpp.exists():
        return cpp, [cpp], ['g++', *GXX_FLAGS, *GXX_EXTRA.get(name, ())]
    raise FileNotFoundError(f'no source named {name!r} in {CSRC} or '
                            f'{NATIVE}')


def _start(name: str):
    """Start the compiler for one source; returns (target, tmp, process)
    or (target, None, None) when the library is already built."""
    src, deps, cmd = _source(name)
    h = hashlib.sha256()
    for dep in deps:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    h.update(name.encode())
    h.update(' '.join(cmd).encode())
    out = BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.tmp{os.getpid()}')
    try:
        proc = subprocess.Popen([*cmd, '-o', str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f'building {name} needs {cmd[0]}, which is not '
                           f'installed') from e
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc, t0: float) -> BuildResult:
    if proc is None:
        log_file = out.with_suffix('.log')
        log = log_file.read_text() if log_file.exists() else ''
        return BuildResult(name, out, 0.0, log)
    stdout, stderr = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'building {name} failed (exit '
                           f'{proc.returncode}):\n{stdout}{stderr}')
    os.replace(tmp, out)
    out.with_suffix('.log').write_text(stderr)
    return BuildResult(name, out, seconds, stderr)


def all_sources() -> list[str]:
    """Every CUDA source and every native source, by name."""
    return (sorted(p.stem for p in CSRC.glob('*.cu'))
            + sorted(p.stem for p in NATIVE.glob('*.cpp')))


def build_all(names=None) -> list[BuildResult]:
    """Build every source (or ``names``), one compiler process per source,
    all started together."""
    if names is None:
        names = all_sources()
    t0 = time.perf_counter()
    started = [(n, *_start(n)) for n in names]
    return [_finish(n, out, tmp, proc, t0)
            for n, out, tmp, proc in started]


class _Libraries:
    """Loaded libraries, one per source, built on first use."""

    def __init__(self):
        self._libs: dict[str, ctypes.CDLL] = {}
        self._fns = {}    # (library, symbol) -> typed ctypes function

    def get(self, name: str) -> ctypes.CDLL:
        if name not in self._libs:
            (res,) = build_all([name])
            self._libs[name] = ctypes.CDLL(str(res.path))
        return self._libs[name]

    def function(self, name: str, symbol: str, argtypes,
                 restype=ctypes.c_int):
        """``symbol`` of library ``name`` with its ctypes signature set
        (pointers as ``c_void_p``, so that ctypes never cuts them to 32
        bits); looked up once, then taken from a dict, since the kernels'
        wrappers call this on every launch."""
        fn = self._fns.get((name, symbol))
        if fn is None:
            fn = getattr(self.get(name), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            self._fns[(name, symbol)] = fn
        return fn


LIBRARIES = _Libraries()


def launch(device, fn, *args):
    """``fn(*args, stream)`` with ``device``'s current stream, for a C entry
    point that launches on the stream it is given; enters
    ``torch.cuda.device`` only when ``device`` is not the current one."""
    index = device.index
    current = torch.cuda.current_device()
    if index is not None and index != current:
        with torch.cuda.device(index):
            return launch(torch.device('cuda', index), fn, *args)
    # the current stream's handle without building a Stream object
    raw = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    stream = (raw(current) if raw is not None
              else torch.cuda.current_stream(current).cuda_stream)
    return fn(*args, stream)
