"""TS output sinks: UDP datagrams and files, per PLP.

Replaces the reference's GUI-configured per-PLP output table
(reference/src/DVB_T2/bb_de_header.cpp:443-461,
main_window.cpp:608-632): UDP datagrams of 7 TS packets (standard MPEG-TS
over UDP framing, playable with ``vlc udp://@:<port>``) or plain files.
"""
from __future__ import annotations

import socket
from pathlib import Path

import numpy as np

TS_PACKET = 188
_PKTS_PER_DGRAM = 7


class UdpTsSink:
    def __init__(self, host: str = "127.0.0.1", port: int = 7654):
        self.addr = (host, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._rem = b""
        self.packets_sent = 0

    def write(self, ts_bytes: np.ndarray):
        buf = self._rem + bytes(np.asarray(ts_bytes, dtype=np.uint8))
        step = TS_PACKET * _PKTS_PER_DGRAM
        pos = 0
        while pos + step <= len(buf):
            self._sock.sendto(buf[pos:pos + step], self.addr)
            pos += step
            self.packets_sent += _PKTS_PER_DGRAM
        self._rem = buf[pos:]

    def close(self):
        if self._rem:
            self._sock.sendto(self._rem, self.addr)
            self._rem = b""
        self._sock.close()


class FileTsSink:
    def __init__(self, path: str):
        self._f = open(path, "wb")
        self.packets_sent = 0

    def write(self, ts_bytes: np.ndarray):
        b = bytes(np.asarray(ts_bytes, dtype=np.uint8))
        self._f.write(b)
        self.packets_sent += len(b) // TS_PACKET

    def close(self):
        self._f.close()


class BufferTsSink:
    """Accumulates in memory (tests)."""

    def __init__(self):
        self.chunks = []
        self.packets_sent = 0

    def write(self, ts_bytes: np.ndarray):
        self.chunks.append(np.asarray(ts_bytes, dtype=np.uint8))
        self.packets_sent += len(ts_bytes) // TS_PACKET

    @property
    def data(self) -> np.ndarray:
        return (np.concatenate(self.chunks) if self.chunks
                else np.empty(0, np.uint8))

    def close(self):
        pass


def make_sink(spec: str):
    """'udp://host:port' | 'file:path' | plain path -> sink object."""
    if spec.startswith("udp://"):
        hostport = spec[6:]
        host, _, port = hostport.rpartition(":")
        return UdpTsSink(host or "127.0.0.1", int(port))
    if spec.startswith(("file:", "ts:")):
        spec = spec.split(":", 1)[1]
    return FileTsSink(spec)
