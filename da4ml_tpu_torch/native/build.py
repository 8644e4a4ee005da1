"""Build the native host library with g++ (no nvcc, no torch headers).

The library is built from ``native/src`` at first use (``bindings.load_lib``)
into ``build/da4ml_tpu_torch/`` at the repository root, the directory the
CUDA kernels are built into, never next to the sources. Its name carries a
digest of the sources and the flags, and a build writes a temporary file
that ``os.replace`` moves into place, so processes that build at once
(test workers, the host solver's spawned workers) each find a whole library.

Counterpart of ``da4ml_tpu/native/build.py``, with the same compiler flags.
Usage: ``python -m da4ml_tpu_torch.native.build`` prints the library's path.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / 'src'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'da4ml_tpu_torch'
CXX_FLAGS = ('-std=c++20', '-O3', '-fPIC', '-shared', '-fopenmp', '-fvisibility=hidden', '-Wall')


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob('*.cc'))


def lib_path() -> Path:
    """Where the library of these sources and flags lies once built."""
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    for p in sorted(SRC_DIR.glob('*.cc')) + sorted(SRC_DIR.glob('*.hh')):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f'libda4ml_native_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the sources into :func:`lib_path` (a no-op when it exists);
    raises with the compiler's output on failure."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which('g++')
    if cxx is None:
        raise RuntimeError('g++ not found: the native library is built from source at first use')
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so')
    proc = subprocess.run([cxx, *CXX_FLAGS, *map(str, sources()), '-o', str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed with exit code {proc.returncode}:\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)
    return out


if __name__ == '__main__':
    print(build())
