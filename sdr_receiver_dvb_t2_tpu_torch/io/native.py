"""ctypes bindings for the native runtime (``native/dvbt2_runtime.cc``).

The C++ source ships in the package.  At first use it is compiled with
``g++ -O2 -shared -fPIC -std=c++17`` into
``torch_native/libdvbt2_runtime.<hash>.so`` under ``ops._build.build_dir``
(in the package, or a per-user cache where the package is read-only), the
hash of the source and the flags naming the library (as ``ops/_build.py``
names the CUDA kernels).  The compiler writes a
temporary name that ``os.replace`` moves into place, so a process that
loads the library never finds it half written.  There is no fallback: a
failed build raises with the compiler's output.  The C ABI avoids a
pybind11 dependency.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops._build import build_dir

SRC = Path(__file__).resolve().parents[1] / "native" / "dvbt2_runtime.cc"
BUILD_DIR = build_dir("torch_native")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdvbt2_runtime.{digest}.so"


def build() -> Path:
    """Compile the runtime unless this source is built already; returns
    the library's path."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed for {SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded native library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    vp, i32, i64, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_uint64)
    sigs = {
        "bb_parser_new": ([], vp),
        "bb_parser_free": ([vp], None),
        "bb_parser_parse": ([vp, u8p, i32, u8p], i32),
        "bb_parser_parse_bytes": ([vp, u8p, i32, u8p, i64], i32),
        "bb_parser_parse_batch": ([vp, u8p, i32, i32, u8p, i64], i64),
        "bb_parser_copy_out": ([vp, u8p, i64], i64),
        "bb_parser_out_size": ([vp], i64),
        "bb_parser_hem": ([vp], i32),
        "bb_parser_matype": ([vp], i32),
        "bb_parser_isi": ([vp], i32),
        "dvbt2_crc8_bytes": ([u8p, i32], ctypes.c_uint8),
        "iq_ring_new": ([u64], vp),
        "iq_ring_free": ([vp], None),
        "iq_ring_push": ([vp, u8p, u64], i32),
        "iq_ring_pop": ([vp, u8p, u64], u64),
        "iq_ring_fill": ([vp], u64),
        "iq_ring_dropped": ([vp], u64),
    }
    for name in ("header_errors", "crc_errors", "unsupported",
                 "null_reinserted", "truncated", "issy_stripped",
                 "last_issy"):
        sigs[f"bb_parser_{name}"] = ([vp], i64)
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeBBFrameParser:
    """The C++ BB-frame de-encapsulator; same interface and output as
    :class:`io.bbframe.BBFrameParser`, its plain reference."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.bb_parser_new()
        self._out = np.empty(1 << 16, dtype=np.uint8)

    def parse(self, frame_bits: np.ndarray) -> np.ndarray:
        """Bit-array interface (one byte per bit); packs and delegates so
        NPD re-insertion gets the full-size output buffer."""
        return self.parse_bytes(np.packbits(
            np.ascontiguousarray(frame_bits, dtype=np.uint8)))

    def _refetch(self, out: np.ndarray, total: int) -> np.ndarray:
        """Total produced exceeded the guess buffer (heavy NPD expansion,
        up to ~256x is legal): re-copy from the parser's retained buffer.
        Nothing is ever dropped on this path."""
        if total <= len(out):
            return out[:total]
        big = np.empty(total, dtype=np.uint8)
        n = self._lib.bb_parser_copy_out(self._h, _as_u8p(big), total)
        return big[:n]

    def parse_bytes(self, frame_bytes: np.ndarray) -> np.ndarray:
        """One packed (scrambled) BB frame of k_bch/8 bytes -> TS bytes."""
        b = np.ascontiguousarray(frame_bytes, dtype=np.uint8)
        cap = max(len(self._out), 64 * len(b))
        if cap > len(self._out):
            self._out = np.empty(cap, dtype=np.uint8)
        n = self._lib.bb_parser_parse_bytes(self._h, _as_u8p(b), len(b),
                                            _as_u8p(self._out), cap)
        if n <= 0:
            return np.empty(0, dtype=np.uint8)
        return self._refetch(self._out, n).copy()

    def parse_batch(self, frames_bytes: np.ndarray) -> np.ndarray:
        """[n_frames, k_bch/8] packed scrambled BB frames -> TS bytes, in
        one native call for the whole LDPC batch."""
        f = np.ascontiguousarray(frames_bytes, dtype=np.uint8)
        n_frames, bytes_each = f.shape
        cap = 8 * n_frames * bytes_each + 256 * 188
        out = np.empty(cap, dtype=np.uint8)
        n = self._lib.bb_parser_parse_batch(self._h, _as_u8p(f), n_frames,
                                            bytes_each, _as_u8p(out), cap)
        return self._refetch(out, n)

    @property
    def header_errors(self) -> int:
        return self._lib.bb_parser_header_errors(self._h)

    @property
    def crc_errors(self) -> int:
        return self._lib.bb_parser_crc_errors(self._h)

    @property
    def unsupported(self) -> int:
        return self._lib.bb_parser_unsupported(self._h)

    @property
    def null_reinserted(self) -> int:
        return self._lib.bb_parser_null_reinserted(self._h)

    @property
    def truncated(self) -> int:
        return self._lib.bb_parser_truncated(self._h)

    @property
    def issy_stripped(self) -> int:
        """ISSY values consumed: per UP in NM, per frame in HEM."""
        return self._lib.bb_parser_issy_stripped(self._h)

    @property
    def last_issy(self) -> int:
        """Most recent ISSY value (opaque 2-3 byte ISCR), -1 if none."""
        return self._lib.bb_parser_last_issy(self._h)

    @property
    def matype(self) -> dict | None:
        """Last parsed MATYPE fields."""
        v = self._lib.bb_parser_matype(self._h)
        if v < 0:
            return None
        return dict(ts_gs=v >> 8, sis_mis=(v >> 7) & 1, ccm_acm=(v >> 6) & 1,
                    issyi=(v >> 5) & 1, npd=(v >> 4) & 1,
                    isi=self._lib.bb_parser_isi(self._h))

    @property
    def mode_hem(self):
        v = self._lib.bb_parser_hem(self._h)
        return None if v < 0 else bool(v)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bb_parser_free(self._h)
            self._h = None


class IqRing:
    """SPSC lock-free byte ring (ingest thread -> compute thread)."""

    def __init__(self, capacity: int):
        self._lib = load()
        self._h = self._lib.iq_ring_new(capacity)

    def push(self, data: np.ndarray) -> bool:
        data = np.ascontiguousarray(data).view(np.uint8)
        return bool(self._lib.iq_ring_push(self._h, _as_u8p(data),
                                           data.nbytes))

    def pop(self, n_bytes: int, dtype=np.uint8) -> np.ndarray:
        out = np.empty(n_bytes, dtype=np.uint8)
        got = self._lib.iq_ring_pop(self._h, _as_u8p(out), n_bytes)
        return out[:got].view(dtype)

    @property
    def fill(self) -> int:
        return self._lib.iq_ring_fill(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.iq_ring_dropped(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.iq_ring_free(self._h)
            self._h = None


def make_bb_parser(kind: str = "native"):
    """A BB-frame parser: ``"native"`` (the C++ runtime, built at first use;
    raises when it cannot be built) or ``"python"`` (its plain reference,
    ``io.bbframe.BBFrameParser``)."""
    if kind == "native":
        return NativeBBFrameParser()
    if kind == "python":
        from .bbframe import BBFrameParser
        return BBFrameParser()
    raise ValueError(f"unknown BB parser {kind!r}")
