"""PyTorch/CUDA port of the DVB-T2 receiver: raw SDR IQ in, MPEG-TS out.

The package mirrors ``sdr_receiver_dvb_t2_tpu`` (``params/``, ``io/``,
``ops/``, ``models/``, ``runtime/``) and runs on an NVIDIA GPU.  The entry
point (``python -m sdr_receiver_dvb_t2_tpu_torch``, ``runtime/stream.py``)
runs the streaming front end and the P1 search on the card, acquires the
mode blind on the host, tracks, and hands frame batches to the frame
receiver (``models/receiver.py``): OFDM demod (cuFFT), pilot equalization
(linear, SFN or MISO), the composed deinterleave + soft demap to int8
LLRs, and the
layered min-sum LDPC decoder with its BCH syndrome screen as a
hand-written CUDA kernel (``ops/csrc/ldpc_layered.cu``); the BB frames go
to TS through the C++ runtime in ``native/``.

Device rule: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``.  Without a GPU and without an explicit ``cpu`` it raises;
it never falls back to the CPU on its own.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "TorchReceiver", "RxConfig", "FrameBatchResult"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda.  Raises when cuda is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def __getattr__(name):
    if name in ("TorchReceiver", "RxConfig", "FrameBatchResult"):
        from .models import receiver
        return getattr(receiver, name)
    raise AttributeError(name)
