"""Build, load and count the port's hand-written CUDA kernels.

The sources are ``csrc/*.cu`` with a plain C interface. ``build()`` compiles
each one with ``nvcc`` for ``sm_90a`` into a shared library under
``_build/`` of the package directory (ignored by git; ``set_build_dir``
names another), one ``nvcc`` process
per source, all started together. The library name carries a hash of its
source, of every header in ``csrc/`` and of the flags, so an edited source
or header is never served from a stale build.
``load(name)`` builds on first use and returns the ``ctypes`` library.

``LAUNCHES`` counts kernel launches by wrapper: each wrapper adds one where
it launches its kernel and nowhere else, so a caller can show that a run
went through the kernels (``reset_launches()`` sets every count to 0).
Nothing here runs at import: importing works without CUDA or nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

SOURCES = ('attention', 'attention_bwd', 'window_lookup')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

LAUNCHES: Dict[str, int] = {'flash_attention': 0, 'flash_attention_prefix': 0,
                            'flash_attention_lse': 0,
                            'flash_attention_bwd': 0, 'window_lookup': 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def set_build_dir(path: str) -> None:
    """Build and load the libraries in ``path`` from now on (a library
    loaded before stays loaded); the names still hash only the sources,
    the headers and the flags."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = os.path.abspath(path)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, '
                           '/usr/local/cuda/bin and PATH)')
    return found


def library_path(name: str) -> str:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cuh'))
    for f in [name + '.cu', *headers]:
        with open(os.path.join(CSRC_DIR, f), 'rb') as fh:
            digest.update(f.encode() + b'\0' + fh.read())
    return os.path.join(BUILD_DIR, f'lib{name}-{digest.hexdigest()[:12]}.so')


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources (default: all) that have no current
    library, in parallel. Returns {name: ptxas report} for what was built;
    the report (registers, shared memory, spills) is also kept beside the
    library as ``.log``. Raises with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
               os.path.join(CSRC_DIR, name + '.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'--- {name} (nvcc exit {proc.returncode}) ---\n{log}')
            continue
        os.replace(tmp, out)
        with open(out + '.log', 'w') as f:
            f.write(log)
        reports[name] = log
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')
