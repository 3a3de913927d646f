"""Pure-Python TensorBoard event-file writer (no tensorboard dependency) —
copy of ``animnerf_tpu/utils/tb_events.py`` with the PNG encoder of
``utils/image.py`` in place of PIL.

Scalars and image triptychs are written as TFRecord framing (length +
masked CRC32C) around hand-encoded ``Event`` protobuf messages, the
on-disk format ``tensorboard --logdir`` reads (and the JAX package's
``read_events``).

Wire format summary (tensorflow/core/util/event.proto):

  Event    { double wall_time = 1; int64 step = 2;
             string file_version = 3; Summary summary = 5; }
  Summary  { repeated Value value = 1; }
  Value    { string tag = 1; float simple_value = 2; Image image = 4; }
  Image    { int32 height = 1; int32 width = 2; int32 colorspace = 3;
             bytes encoded_image_string = 4; }

TFRecord framing per record:
  uint64 length (LE) | uint32 masked_crc32c(length bytes) |
  data | uint32 masked_crc32c(data)
"""

from __future__ import annotations

import os
import socket
import struct
import time


# --------------------------------------------------------------------- crc32c

def _make_crc32c_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ----------------------------------------------------------- protobuf encode

def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # protobuf int64 two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _f_str(field: int, v: str) -> bytes:
    return _f_bytes(field, v.encode("utf-8"))


def _encode_png(img) -> tuple[bytes, int, int]:
    """uint8 (H, W, 3) array -> (png bytes, height, width)."""
    from animnerf_tpu_torch.utils.image import encode_png

    h, w = img.shape[:2]
    return encode_png(img), h, w


class EventWriter:
    """Writes a ``events.out.tfevents.*`` file TensorBoard can load."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()), socket.gethostname())
        self._f = open(os.path.join(log_dir, fname), "ab")
        self.path = self._f.name
        # header event: file_version (field 3)
        self._write_event(_f_double(1, time.time())
                          + _f_str(3, "brain.Event:2"))

    # ------------------------------------------------------------ low level

    def _write_event(self, event_bytes: bytes) -> None:
        length = struct.pack("<Q", len(event_bytes))
        self._f.write(length)
        self._f.write(struct.pack("<I", _masked_crc(length)))
        self._f.write(event_bytes)
        self._f.write(struct.pack("<I", _masked_crc(event_bytes)))
        self._f.flush()

    def _summary_event(self, step: int, values: bytes) -> None:
        summary = _f_bytes(5, values)
        self._write_event(
            _f_double(1, time.time()) + _f_varint(2, step) + summary)

    # ----------------------------------------------------------- public API

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        v = _f_str(1, tag) + _f_float(2, float(value))
        self._summary_event(step, _f_bytes(1, v))

    def add_scalars(self, scalars: dict, step: int) -> None:
        """All tags in one Event (one Summary with several Values)."""
        vals = b"".join(
            _f_bytes(1, _f_str(1, tag) + _f_float(2, float(v)))
            for tag, v in scalars.items())
        self._summary_event(step, vals)

    def add_image(self, tag: str, img, step: int) -> None:
        """img: uint8 (H, W, 3) numpy array."""
        png, h, w = _encode_png(img)
        image = (_f_varint(1, h) + _f_varint(2, w) + _f_varint(3, 3)
                 + _f_bytes(4, png))
        v = _f_str(1, tag) + _f_bytes(4, image)
        self._summary_event(step, _f_bytes(1, v))

    def close(self) -> None:
        self._f.close()
