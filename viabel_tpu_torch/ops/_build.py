"""Build the CUDA sources under ``csrc/`` and load them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``_build/<name>-<hash>.so``; the hash covers the source,
every header under ``csrc/`` and the flags, so an edited source or header
rebuilds and an unchanged one loads the cached library.  Nothing is built
at import: the first kernel launch builds what it needs, and `build_all`
builds every source at once, one ``nvcc`` process each, all started
together.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ['load', 'build_all', 'SOURCES']

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, 'csrc')
_BUILD = os.path.join(_PKG, '_build')
SOURCES = ('lw_stats', 'gaussian_lw')
_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
          '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_lock = threading.Lock()
_loaded = {}


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    for path in (shutil.which('nvcc'), os.path.join(cuda_home, 'bin', 'nvcc')):
        if path and os.path.exists(path):
            return path
    raise RuntimeError('nvcc not found (looked on PATH and in {}/bin); the '
                       'CUDA kernels build only where the CUDA toolkit is '
                       'installed'.format(cuda_home))


def _target(name):
    src = os.path.join(_CSRC, name + '.cu')
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith('.cuh'))
    digest = hashlib.sha256(' '.join(_FLAGS).encode())
    for path in [src] + [os.path.join(_CSRC, h) for h in headers]:
        with open(path, 'rb') as f:
            digest.update(f.read())
    return src, os.path.join(_BUILD, '{}-{}.so'.format(
        name, digest.hexdigest()[:16]))


def _start(name):
    """Start nvcc for `name` unless its library is built; returns
    (target, tmp, process) or None."""
    src, target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(_BUILD, exist_ok=True)
    tmp = '{}.{}.tmp'.format(target, os.getpid())
    cmd = [_nvcc(), *_FLAGS, '-o', tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name, started):
    target, tmp, proc = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed for csrc/{}.cu:\n{}'.format(name, out))
    os.replace(tmp, target)  # atomic: a concurrent reader sees all or none
    return out


def build_all():
    """Build every source, one nvcc each, all started together, and wait
    for all of them.  Returns nvcc's output (registers, spills) for each
    source it built."""
    started = {name: _start(name) for name in SOURCES}
    logs, errors = {}, []
    for name, s in started.items():
        if s is not None:
            try:
                logs[name] = _finish(name, s)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError('\n'.join(errors))
    return logs


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            s = _start(name)
            if s is not None:
                _finish(name, s)
            lib = _loaded[name] = ctypes.CDLL(_target(name)[1])
        return lib
