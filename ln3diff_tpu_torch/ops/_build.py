"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface, so it
compiles in seconds without PyTorch's headers.  The shared library goes
to ``ln3diff_tpu_torch/_build/<name>-<hash>.so``, where the hash covers
the source, the headers beside it and the flags: a changed source builds
anew, an unchanged one is reused.  The compiler writes to a temporary name
that is renamed into place, so an interrupted build leaves nothing
half-written, and no lock file is taken that could be left behind.

Nothing here runs at import time; the first launch of a kernel builds it.
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

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float        # compile wall time; 0.0 when the file was reused
    log: str              # nvcc's stderr (the -Xptxas -v report)


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


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob('*.cu*')) + sorted(CSRC.glob('*.h')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(name.encode())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def _start(name: str):
    """Start one ``nvcc`` for ``csrc/<name>.cu``; returns (target, tmp,
    process) or (target, None, None) when the library is already built."""
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.tmp{os.getpid()}')
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
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
        raise RuntimeError(f'nvcc failed on csrc/{name}.cu '
                           f'(exit {proc.returncode}):\n{stdout}{stderr}')
    os.replace(tmp, out)
    out.with_suffix('.log').write_text(stderr)
    return BuildResult(name, out, seconds, stderr)


def build_all(names=None) -> list[BuildResult]:
    """Build every ``csrc/*.cu`` (or ``names``), one ``nvcc`` per source,
    all started together."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob('*.cu'))
    t0 = time.perf_counter()
    started = [(n, *_start(n)) for n in names]
    return [_finish(n, out, tmp, proc, t0)
            for n, out, tmp, proc in started]


class _Libraries:
    """Loaded kernel libraries, one per source, built on first use."""

    def __init__(self):
        self._libs: dict[str, ctypes.CDLL] = {}

    def get(self, name: str) -> ctypes.CDLL:
        if name not in self._libs:
            (res,) = build_all([name])
            self._libs[name] = ctypes.CDLL(str(res.path))
        return self._libs[name]


LIBRARIES = _Libraries()
