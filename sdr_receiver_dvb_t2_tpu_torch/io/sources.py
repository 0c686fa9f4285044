"""IQ sample sources: recorded files and sockets (front-end L1 equivalent).

The reference supports six SDR front-ends plus raw-file playback behind one
``rx_interface`` (reference/src/rx_interface.h:11-48).  On a GPU host
the hardware drivers are out of process; this framework ingests IQ through
the same narrow interface from:

* raw capture files — gqrx/reference-compatible naming
  ``*_<rate>_<8|16|fc>.raw`` (reference/src/rx_raw.cpp:60-91), with
  optional looping and real-time pacing like the reference's player;
* UDP/TCP sockets (an SDR host daemon streams raw IQ);
* in-memory arrays (tests, fixtures).

Every source yields (block ndarray, sample_rate, fmt); conversion to
complex64 happens on the device (ops/frontend.raw_to_iq).
"""
from __future__ import annotations

import dataclasses
import re
import socket
import struct
import time
from pathlib import Path

import numpy as np

_FMT = {"8": ("u8", np.uint8), "16": ("s16", np.int16),
        "fc": ("f32", np.float32)}


def parse_raw_filename(path: str) -> tuple[float, str]:
    """``*_<rate>_<8|16|fc>.raw`` -> (sample_rate, fmt).

    Mirrors the reference parser: rate and format are the last two
    underscore-separated fields (rx_raw.cpp:60-91).
    """
    m = re.match(r".*_(\d+)_(8|16|fc)\.raw$", Path(path).name)
    if not m:
        raise ValueError(
            f"cannot parse sample rate/format from {path!r}; expected "
            "'*_<rate>_<8|16|fc>.raw'")
    return float(m.group(1)), _FMT[m.group(2)][0]


# numpy type of each wire format's samples, as the sources hand them out
# (interleaved I/Q, or complex64 for in-memory arrays)
WIRE_DTYPES = {"u8": np.uint8, "s8": np.int8, "s16": np.int16,
               "f32": np.float32, "c64": np.complex64}


@dataclasses.dataclass
class SourceInfo:
    sample_rate: float
    fmt: str                     # 'u8' | 's8' | 's16' | 'f32'


class RawFileSource:
    """Plays a recorded IQ capture; loops at EOF like the reference."""

    def __init__(self, path: str, sample_rate: float | None = None,
                 fmt: str | None = None, loop: bool = False,
                 realtime: bool = False):
        if sample_rate is None or fmt is None:
            rate_f, fmt_f = parse_raw_filename(path)
            sample_rate = sample_rate or rate_f
            fmt = fmt or fmt_f
        self.info = SourceInfo(sample_rate, fmt)
        self.path = path
        self.loop = loop
        self.realtime = realtime
        self._dtype = {"u8": np.uint8, "s8": np.int8, "s16": np.int16,
                       "f32": np.float32}[fmt]
        self._f = open(path, "rb")

    def read(self, n_samples: int) -> np.ndarray | None:
        """Next block of n_samples IQ pairs (raw ints); None at end."""
        t0 = time.monotonic() if self.realtime else None
        need = 2 * n_samples * np.dtype(self._dtype).itemsize
        buf = self._f.read(need)
        if len(buf) < need:
            if not self.loop:
                return None
            self._f.seek(0)
            buf += self._f.read(need - len(buf))
            if len(buf) < need:
                return None
        block = np.frombuffer(buf, dtype=self._dtype)
        if self.realtime:
            dt = n_samples / self.info.sample_rate - (time.monotonic() - t0)
            if dt > 0:
                time.sleep(dt)
        return block

    def close(self):
        self._f.close()


class ArraySource:
    """In-memory complex64 IQ (tests / fixtures); fmt='c64' passthrough."""

    def __init__(self, iq: np.ndarray, sample_rate: float):
        self.info = SourceInfo(sample_rate, "c64")
        self._iq = np.asarray(iq, dtype=np.complex64)
        self._pos = 0

    def read(self, n_samples: int) -> np.ndarray | None:
        if self._pos >= len(self._iq):
            return None
        block = self._iq[self._pos:self._pos + n_samples]
        self._pos += n_samples
        if len(block) < n_samples:
            block = np.pad(block, (0, n_samples - len(block)))
        return block

    def close(self):
        pass


SEQ_MAGIC = b"IQSQ"          # tools/sdr_daemon.py SeqSocket framing
_SEQ_HDR = struct.Struct("<4sIQ")


class UdpIqSource:
    """Raw IQ datagrams from an SDR host daemon.

    With ``seq=True`` each datagram carries the daemon's 16-byte header
    (magic, u32 sequence, u64 cumulative byte offset); drops are then
    DETECTED and ZERO-FILLED to the exact missing byte count, keeping
    the stream time-aligned (the affected codewords decode dirty and the
    BCH screen flags them) instead of silently shifting every later
    byte.  ``gap_events``/``gap_bytes`` count what was lost.
    """

    def __init__(self, port: int, sample_rate: float, fmt: str = "s16",
                 host: str = "0.0.0.0", timeout: float = 5.0,
                 seq: bool = False):
        self.info = SourceInfo(sample_rate, fmt)
        self._dtype = {"u8": np.uint8, "s8": np.int8, "s16": np.int16,
                       "f32": np.float32}[fmt]
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # deep kernel buffer: the compute thread services the socket in
        # bursts (one front-end block at a time), sized like the reference's
        # 128-1024 x 512 KiB ingest queue (rx_base.h:44-45)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 23)
        self._sock.bind((host, port))
        self._sock.settimeout(timeout)
        self._rem = b""
        self._seq = seq
        self._next_off = None        # next expected byte offset
        self.gap_events = 0
        self.gap_bytes = 0
        self.reordered = 0
        # zero level of the wire format ('u8' centers at 127/128)
        self._zero = b"\x80" if fmt == "u8" else b"\x00"

    def _recv_payload(self) -> bytes:
        """One datagram -> payload bytes, zero-fill prepended on a gap."""
        pkt = self._sock.recv(65536)
        if not self._seq:
            return pkt
        if len(pkt) < _SEQ_HDR.size or pkt[:4] != SEQ_MAGIC:
            return pkt               # unframed sender; pass through
        _, _, off = _SEQ_HDR.unpack_from(pkt)
        payload = pkt[_SEQ_HDR.size:]
        if self._next_off is None:
            self._next_off = off
        if off > self._next_off:     # datagrams lost: keep alignment
            missing = off - self._next_off
            self.gap_events += 1
            self.gap_bytes += missing
            payload = self._zero * missing + payload
        elif off < self._next_off:   # late duplicate/reorder: drop
            self.reordered += 1
            return b""
        self._next_off = off + (len(pkt) - _SEQ_HDR.size)
        return payload

    def read(self, n_samples: int) -> np.ndarray | None:
        need = 2 * n_samples * np.dtype(self._dtype).itemsize
        chunks, got = [self._rem], len(self._rem)
        try:
            while got < need:
                pkt = self._recv_payload()
                chunks.append(pkt)
                got += len(pkt)
        except socket.timeout:
            # keep what arrived (and any zero fill already counted against
            # _next_off) for the next call: dropping it would shift every
            # later byte
            self._rem = b"".join(chunks)
            return None
        buf = b"".join(chunks)
        self._rem = buf[need:]
        return np.frombuffer(buf[:need], dtype=self._dtype)

    def close(self):
        self._sock.close()


class RemoteSdrSource(UdpIqSource):
    """Live SDR behind a bridge daemon (tools/sdr_daemon.py).

    IQ arrives as UDP datagrams; the daemon's TCP control channel serves
    the reference's rx_interface gain contract (set_gain_db / gain_min /
    gain_max, rx_interface.h:21-48) so runtime.agc.Agc drives real hardware
    gain.  Sample rate and format come from the daemon's INFO reply.
    """

    def __init__(self, port: int, control_host: str, control_port: int,
                 host: str = "0.0.0.0", timeout: float = 5.0):
        self._ctl = socket.create_connection((control_host, control_port),
                                            timeout=timeout)
        self._ctl_f = self._ctl.makefile("rw")
        info = self._cmd("INFO").split()
        if len(info) < 6 or info[0] != "INFO":
            self._ctl.close()
            raise ConnectionError(f"not an SDR daemon INFO reply: {info}")
        rate, fmt = float(info[1]), info[2]
        self._gain_min, self._gain_max = float(info[3]), float(info[4])
        self.gain_db = float(info[5])
        # protocol capabilities advertised after the gain fields
        caps = info[6:]
        self.center_freq_hz = (float(caps[caps.index("FREQ") + 1])
                               if "FREQ" in caps else None)
        super().__init__(port, rate, fmt, host=host, timeout=timeout,
                         seq="SEQ1" in caps)

    def _cmd(self, line: str) -> str:
        self._ctl_f.write(line + "\n")
        self._ctl_f.flush()
        return self._ctl_f.readline().strip()

    # ---- the rx_interface gain contract (drives the AGC) --------------
    def gain_min(self) -> float:
        return self._gain_min

    def gain_max(self) -> float:
        return self._gain_max

    def set_gain_db(self, db: float) -> float:
        resp = self._cmd(f"GAIN {db}").split()
        if resp and resp[0] == "OK":
            self.gain_db = float(resp[1])
        return self.gain_db

    def set_biastee(self, on: bool):
        self._cmd(f"BIASTEE {int(on)}")

    def set_center_freq(self, hz: float) -> float | None:
        """Retune the front end (reference rx_base.cpp:146-152); returns
        the applied center, or None if the daemon predates FREQ."""
        resp = self._cmd(f"FREQ {hz}").split()
        if resp and resp[0] == "OK":
            self.center_freq_hz = float(resp[1])
            return self.center_freq_hz
        return None

    def close(self):
        try:
            self._cmd("QUIT")
            self._ctl.close()
        except OSError:
            pass
        super().close()


class ThreadedSource:
    """Background ingest thread feeding the native SPSC ring.

    Mirrors the reference's device-callback -> double-buffer handoff
    (rx_base.cpp:154-199): a reader thread pulls from any source into the
    lock-free ring; the compute thread pops fixed blocks.  On overrun the
    ring drops whole blocks and counts them (the reference's policy).
    """

    def __init__(self, source, capacity_blocks: int = 64,
                 block_samples: int = 1 << 17):
        import threading
        from .native import IqRing
        self.src = source
        self.info = source.info
        self._dtype = WIRE_DTYPES[source.info.fmt]
        unit = np.dtype(self._dtype).itemsize
        self._sample_bytes = unit if self._dtype == np.complex64 else 2 * unit
        self.ring = IqRing(capacity_blocks * block_samples
                           * self._sample_bytes)
        self._block = block_samples
        self._eof = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self):
        while not self._stop.is_set():
            blk = self.src.read(self._block)
            if blk is None:
                self._eof.set()
                return
            self.ring.push(np.ascontiguousarray(blk))

    @property
    def dropped_samples(self) -> int:
        return self.ring.dropped // self._sample_bytes

    def flush(self):
        """Discard everything currently buffered (retune settle)."""
        fill = self.ring.fill
        if fill:
            self.ring.pop(fill)

    def __getattr__(self, name):
        # forward the rx_interface gain/biastee/retune contract and the
        # transport gap counters to the wrapped source so the AGC and
        # the retune policy stay live through the ingest thread
        if name in ("set_gain_db", "gain_min", "gain_max", "set_biastee",
                    "set_center_freq", "center_freq_hz",
                    "gap_events", "gap_bytes", "reordered"):
            return getattr(self.src, name)
        raise AttributeError(name)

    def read(self, n_samples: int) -> np.ndarray | None:
        import time as _time
        need = n_samples * self._sample_bytes
        while self.ring.fill < need:
            if self._eof.is_set() and self.ring.fill < need:
                if self.ring.fill == 0:
                    return None
                break
            _time.sleep(0.001)
        out = self.ring.pop(need, dtype=self._dtype)
        if self._dtype != np.complex64 and len(out) % 2:
            out = out[:-1]
        if len(out) < (2 if self._dtype != np.complex64 else 1):
            return None
        return out

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.src.close()
