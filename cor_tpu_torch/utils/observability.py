"""TensorBoard scalars without tensorboard: the port's copy of
``cor_tpu.utils.observability``'s dependency-free event writer (a TFRecord
file of hand-encoded ``tf.Event`` protos, CRC32C framed). The card's machine
has neither tensorboard nor tensorflow; TensorBoard reads the files.
"""

from __future__ import annotations

import socket
import struct
import time
from pathlib import Path

# CRC32C (Castagnoli) table of the TFRecord framing; the masked form is
# TFRecord's ((crc >> 15) | (crc << 17)) + 0xa282ead8
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _masked_crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        out.append(bits | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    """tf.Event{wall_time (1, double), step (2, int64), summary (5):
    Summary{value (1): Value{tag (1), simple_value (2, float)}}}."""
    tag_b = tag.encode()
    val = b"\x0a" + _varint(len(tag_b)) + tag_b + b"\x15" + struct.pack("<f", value)
    summary = b"\x0a" + _varint(len(val)) + val
    return (b"\x09" + struct.pack("<d", wall_time) + b"\x10" + _varint(step)
            + b"\x2a" + _varint(len(summary)) + summary)


def _version_event(wall_time: float) -> bytes:
    v = b"brain.Event:2"
    return b"\x09" + struct.pack("<d", wall_time) + b"\x1a" + _varint(len(v)) + v


class SummaryWriter:
    """``add_scalar(tag, value, step)`` into an event file under ``log_dir``
    (the tags of ``cor_tpu``'s trainer)."""

    def __init__(self, log_dir):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        name = f"events.out.tfevents.{time.time():.6f}.{socket.gethostname()}"
        self._f = open(log_dir / name, "wb")
        self._record(_version_event(time.time()))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc32c(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_scalar_event(time.time(), int(step), tag, float(value)))

    def close(self) -> None:
        self._f.close()
