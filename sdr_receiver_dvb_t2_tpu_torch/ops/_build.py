"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into
``torch_kernels/lib<name>.<hash>.so`` under :func:`build_dir` and loaded
with ctypes; the hash of the source names the library, so an edited
source is rebuilt.  :func:`build_all` starts one nvcc per source at once.
There is no prebuilt fallback: a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE = __name__.split(".")[0]
PACKAGE_DIR = Path(__file__).resolve().parents[1]


def _writable(d: Path) -> bool:
    # the mode bits must name write permission, not only grant it: a
    # superuser may write anywhere, and a directory set read-only is left
    # alone all the same
    return (d.is_dir() and os.access(d, os.W_OK)
            and bool(d.stat().st_mode & 0o222))


def build_dir(kind: str) -> Path:
    """Where the port builds its libraries of one ``kind`` (the CUDA
    kernels, the native runtime): ``<package>/_build/<kind>`` when the
    package directory is writable (a checkout, a user install), else a
    per-user cache, ``$XDG_CACHE_HOME`` or ``~/.cache``, under the
    package's name (a read-only site-packages)."""
    own = PACKAGE_DIR / "_build"
    if _writable(own if own.exists() else PACKAGE_DIR):
        return own / kind
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / PACKAGE / kind


CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = build_dir("torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of the kernels' host entry points
_SIGNATURES = {
    "ldpc_layered": {
        "ldpc_layered_decode": ([_P] * 9 + [_I] * 8 + [_P], _I),
        "ldpc_layered_shared_bytes": ([_I] * 4, _I),
        "last_error_string": ([_I], ctypes.c_char_p),
        "last_error_detail": ([], ctypes.c_char_p),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def _compile_cmd(name: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names=None) -> dict[str, str]:
    """Compile every kernel source not built yet, one nvcc each, all at
    once.  Returns each kernel's compiler output (``-Xptxas -v``)."""
    names = list(_SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                _compile_cmd(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
    return logs


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build_all([name])
            lib = ctypes.CDLL(str(out))
            for fn, (args, res) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _loaded[name] = lib
        return lib
