"""Build and load the port's CUDA kernels.

Each ``skypilot_torch/csrc/*.cu`` compiles, on first use, into its own
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so \\
         skypilot_torch/csrc/<name>.cu

and is loaded with ``ctypes``. The first request builds every missing
library at once, one ``nvcc`` per source, all started together. The
file name carries a hash of the sources and flags, so an edited source
rebuilds. ``build/`` sits beside the package (the checkout root) and is
git-ignored; ``<name>-<hash>.log`` keeps nvcc's register/spill report.

Nothing is fetched and nothing falls back: a missing ``nvcc`` or a
failed build raises :class:`BuildError`, and a C entry that returns a
CUDA error raises :class:`KernelError`. Every pointer and the stream
cross as ``c_void_p`` (a plain ``int`` would be cut to 32 bits), and
kernels launch on PyTorch's current stream.
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'kernels')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelError(RuntimeError):
    """A kernel's C entry reported a CUDA error at launch."""


def _nvcc() -> str:
    for root in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH')):
        if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.isfile(default):
        return default
    raise BuildError('nvcc not found (set CUDA_HOME or put nvcc on PATH);'
                     ' the CUDA kernels build from source and have no '
                     'prebuilt fallback')


def sources() -> Dict[str, str]:
    """Kernel library name -> its ``.cu`` source path."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu')))}


def library_path(name: str) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, '*.cuh')))
    for path in [sources()[name]] + headers:
        with open(path, 'rb') as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f'{name}-{h.hexdigest()[:16]}.so')


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel;
    returns name -> library path. Raises :class:`BuildError` naming
    each source that failed, with nvcc's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    paths = {}
    for name, src in sources().items():
        out = library_path(name)
        paths[name] = out
        if os.path.exists(out):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f'{out}.{os.getpid()}.tmp'
        log = open(os.path.splitext(out)[0] + '.log', 'wb')
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-o', tmp, src], stdout=log,
            stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            with open(log.name, encoding='utf-8', errors='replace') as f:
                failed.append(f'{name} (nvcc exit {rc}):\n{f.read()}')
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never race
    if failed:
        raise BuildError('kernel build failed: ' + '\n'.join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building on first
    use."""
    with _lock:
        if name not in _libs:
            if name not in sources():
                raise BuildError(f'no kernel source csrc/{name}.cu')
            path = library_path(name)
            if not os.path.exists(path):
                path = build_all()[name]
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


class Kernel:
    """One C entry of a kernel library, with its launch count.

    ``launches`` rises by one for each call whose launch the CUDA
    runtime accepted, and nowhere else; a run reads it to prove its
    main path went through the kernel.
    """

    def __init__(self, library: str, symbol: str,
                 argtypes: Sequence[type]):
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None

    def _bind(self):
        lib = load(self.library)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.skypilot_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._bind()
        code = self._fn(*args)
        if code != 0:
            raise KernelError(f'{self.symbol}: CUDA error {code} '
                              f'({self._err(code).decode()})')
        self.launches += 1
