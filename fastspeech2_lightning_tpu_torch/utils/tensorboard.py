"""TensorBoard event files without ``tensorboardX``, ``tensorboard`` or
``protobuf``: scalars, PNG images and PCM16 WAV audio, written as
tensorboardX 2.6 writes them and read back with their checksums checked.

An event file is a sequence of TFRecords: ``uint64 length``,
``uint32 masked_crc32c(length bytes)``, the data, ``uint32
masked_crc32c(data)``, little-endian. Each record's data is an ``Event``
protobuf, encoded here by hand for the fields used: ``Event`` (``wall_time``
1, ``step`` 2, ``file_version`` 3, ``summary`` 5), ``Summary`` (``value`` 1,
repeated), ``Summary.Value`` (``tag`` 1, ``simple_value`` 2, ``image`` 4,
``audio`` 6), ``Summary.Image`` (``height`` 1, ``width`` 2, ``colorspace``
3, ``encoded_image_string`` 4) and ``Summary.Audio`` (``sample_rate`` 1,
``num_channels`` 2, ``length_frames`` 3, ``encoded_audio_string`` 4,
``content_type`` 5). The file is named ``events.out.tfevents.<10-digit
time>.<hostname>`` and starts with ``Event(wall_time,
file_version="brain.Event:2")``, as tensorboardX's are, so ``tensorboard
--logdir`` reads it on any machine.

CRC-32C (Castagnoli) is table-driven: a buffer is cut into lanes that are
checksummed side by side, eight bytes a step (slicing-by-8 over numpy), and
the lanes' registers are then chained with a table for the shift over one
lane's length."""

from __future__ import annotations

import functools
import io
import math
import socket
import struct
import time
import wave
import zlib
from pathlib import Path
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# CRC-32C
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78  # Castagnoli, reflected
_LANE = 1024  # bytes a lane; buffers shorter than two lanes go byte by byte


@functools.lru_cache(maxsize=1)
def _tables() -> np.ndarray:
    """[8, 256] uint32: row 0 the byte-at-a-time table, row k the table for a
    byte k positions before the last of an 8-byte step."""
    t = np.zeros((8, 256), np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t[0, i] = c
    for k in range(1, 8):
        t[k] = (t[k - 1] >> 8) ^ t[0][t[k - 1] & 0xFF]
    return t


@functools.lru_cache(maxsize=1)
def _lane_shift() -> List[List[int]]:
    """Four 256-entry tables of the linear map "run the register over
    `_LANE` zero bytes", one a byte of the register."""
    t0 = _tables()[0]
    images = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    for _ in range(_LANE):
        images = t0[images & 0xFF] ^ (images >> 8)
    bits = ((np.arange(256)[:, None] >> np.arange(8)) & 1).astype(bool)
    return [np.bitwise_xor.reduce(np.where(bits, images[8 * k:8 * k + 8], 0), axis=1)
            .astype(np.uint32).tolist() for k in range(4)]


def _crc_bytes(reg: int, data: bytes) -> int:
    table = _tables()[0].tolist()
    for b in data:
        reg = table[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def crc32c(data: bytes) -> int:
    """The CRC-32C of `data` (initial register and final xor 0xFFFFFFFF)."""
    data = bytes(data)
    n_lanes = len(data) // _LANE
    if n_lanes < 2:
        return _crc_bytes(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    t = _tables()
    # [steps, 2, lanes]: the two little-endian words of each lane's 8-byte steps
    words = np.frombuffer(data, "<u4", count=n_lanes * _LANE // 4)
    words = words.reshape(n_lanes, _LANE // 8, 2).transpose(1, 2, 0).copy()
    reg = np.zeros(n_lanes, np.uint32)  # each lane from a zero register
    for lo, hi in words:
        lo = lo ^ reg
        reg = (t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF]
               ^ t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF]
               ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24])
    s0, s1, s2, s3 = _lane_shift()
    out = 0xFFFFFFFF
    for lane in reg.tolist():  # the register is linear in the bytes: shift and add
        out = s0[out & 0xFF] ^ s1[(out >> 8) & 0xFF] ^ s2[(out >> 16) & 0xFF] ^ s3[out >> 24]
        out ^= lane
    return _crc_bytes(out, data[n_lanes * _LANE:]) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: ``((c >> 15) | (c << 17)) + 0xa282ead8``."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire format, for the fields above
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int_field(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n) if n else b""


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _float_field(field: int, x: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", x)


def _event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
           value: bytes = b"") -> bytes:
    out = _key(1, 1) + struct.pack("<d", wall_time) + _int_field(2, step)
    if file_version is not None:
        return out + _bytes_field(3, file_version.encode())
    return out + _bytes_field(5, _bytes_field(1, value))  # Summary{value: [value]}


def _fields(data: bytes) -> List[Tuple[int, int, Any]]:
    """(field number, wire type, value) of a protobuf message; varints as
    ints, fixed64 and fixed32 as raw bytes, length-delimited as bytes."""
    out, i = [], 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(data, i)
        elif wire == 1:
            value, i = data[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(data, i)
            value, i = data[i:i + n], i + n
        elif wire == 5:
            value, i = data[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.append((field, wire, value))
    if i != len(data):
        raise ValueError("truncated protobuf message")
    return out


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint")
        byte = data[i]
        i += 1
        n |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return n, i


def _signed(n: int) -> int:
    return n - (1 << 64) if n >= 1 << 63 else n


_IMAGE = {1: "height", 2: "width", 3: "colorspace", 4: "encoded_image_string"}
_AUDIO = {1: "sample_rate", 2: "num_channels", 3: "length_frames", 4: "encoded_audio_string",
          5: "content_type"}


def _decode_message(data: bytes, names: Dict[int, str]) -> dict:
    out = {}
    for field, wire, value in _fields(data):
        if field in names:
            if wire == 5:
                value = struct.unpack("<f", value)[0]
            elif names[field] == "content_type":
                value = value.decode()
            out[names[field]] = value
    return out


def _decode_value(data: bytes) -> dict:
    out: Dict[str, Any] = {}
    for field, wire, value in _fields(data):
        if field == 1:
            out["tag"] = value.decode()
        elif field == 2 and wire == 5:
            out["simple_value"] = struct.unpack("<f", value)[0]
        elif field == 4:
            out["image"] = _decode_message(value, _IMAGE)
        elif field == 6:
            out["audio"] = _decode_message(value, _AUDIO)
    return out


def _decode_event(data: bytes) -> dict:
    out: Dict[str, Any] = {"wall_time": 0.0, "step": 0}
    for field, wire, value in _fields(data):
        if field == 1 and wire == 1:
            out["wall_time"] = struct.unpack("<d", value)[0]
        elif field == 2 and wire == 0:
            out["step"] = _signed(value)
        elif field == 3:
            out["file_version"] = value.decode()
        elif field == 5:
            out["summary"] = [_decode_value(v) for f, _, v in _fields(value) if f == 1]
    return out


# ---------------------------------------------------------------------------
# PNG and WAV
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """An [H, W, 3] uint8 RGB image as PNG: 8-bit, not interlaced, every row
    with filter 0, zlib at its default level."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"want an [H, W, 3] uint8 image, got {image.dtype} {image.shape}")
    h, w, _ = image.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # each row: filter byte 0, then RGB
    rows[:, 1:] = image.reshape(h, 3 * w)
    return (_PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The [H, W, 3] uint8 image of a PNG that ``encode_png`` wrote (8-bit
    RGB, filter 0 on every row); other PNGs raise ValueError."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG")
    i, idat, header = 8, [], None
    while i < len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        kind, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        (crc,) = struct.unpack(">I", data[i + 8 + n:i + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        i += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"only 8-bit RGB PNGs without interlace are read, not {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("only filter 0 is read")
    return rows[:, 1:].reshape(h, w, 3).copy()


def encode_wav(audio: np.ndarray, sample_rate: int) -> bytes:
    """Mono PCM16 WAV of `audio` clipped to [-1, 1] and scaled by 32767,
    rounded to the nearest step, as tensorboardX's ``add_audio`` writes it."""
    pcm = np.round(np.clip(np.asarray(audio, np.float64).reshape(-1), -1.0, 1.0) * 32767.0)
    out = io.BytesIO()
    with wave.open(out, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.astype("<i2").tobytes())
    return out.getvalue()


# ---------------------------------------------------------------------------
# Writer and reader
# ---------------------------------------------------------------------------


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


class SummaryWriter:
    """An event file in `logdir` with tensorboardX's name and first record.
    Every ``add_*`` writes its record through to the file, so a reader sees
    it at once; ``close`` ends the file. Opening a file that cannot be
    written raises."""

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.path = self.logdir / (f"events.out.tfevents.{str(time.time())[:10]}."
                                   f"{socket.gethostname()}")
        # append: a second writer within the same second keeps the first's events
        self._file: Optional[BinaryIO] = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        if self._file is None:
            raise ValueError(f"{self.path}: the writer is closed")
        self._file.write(_record(event))
        self._file.flush()

    def _add(self, tag: str, step: int, payload: bytes) -> None:
        self._write(_event(time.time(), int(step), value=_bytes_field(1, tag.encode())
                           + payload))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._add(tag, step, _float_field(2, float(value)))

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """`image` [H, W, 3] uint8 RGB, stored as PNG."""
        h, w = image.shape[:2]
        self._add(tag, step, _bytes_field(4, _int_field(1, h) + _int_field(2, w)
                                          + _int_field(3, 3)
                                          + _bytes_field(4, encode_png(image))))

    def add_audio(self, tag: str, audio: np.ndarray, step: int, sample_rate: int) -> None:
        """Mono `audio` in [-1, 1] (clipped beyond), stored as PCM16 WAV."""
        audio = np.asarray(audio).reshape(-1)
        self._add(tag, step, _bytes_field(6, _float_field(1, float(sample_rate))
                                          + _int_field(2, 1) + _int_field(3, audio.size)
                                          + _bytes_field(4, encode_wav(audio, sample_rate))
                                          + _bytes_field(5, b"audio/wav")))

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path) -> List[dict]:
    """The events of an event file, each a dict: ``wall_time``, ``step``,
    and ``file_version`` or ``summary`` (a list of values: ``tag`` with
    ``simple_value``, ``image`` or ``audio``, each a dict of its fields).
    Raises ValueError on a record whose length or data fails its CRC, or
    that the file cuts short."""
    data = Path(path).read_bytes()
    events, i = [], 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"{path}: a record header is cut short at byte {i}")
        header = data[i:i + 8]
        (n,), (header_crc,) = struct.unpack("<Q", header), struct.unpack("<I", data[i + 8:i + 12])
        if masked_crc32c(header) != header_crc:
            raise ValueError(f"{path}: bad length CRC at byte {i}")
        body = data[i + 12:i + 12 + n]
        if len(body) != n or i + 16 + n > len(data):
            raise ValueError(f"{path}: a record is cut short at byte {i}")
        (body_crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if masked_crc32c(body) != body_crc:
            raise ValueError(f"{path}: bad data CRC in the record at byte {i}")
        events.append(_decode_event(body))
        i += 16 + n
    return events


def scalars(events: List[dict]) -> Dict[str, List[Tuple[int, float]]]:
    """tag -> [(step, value)] of the scalar values in `events`, in order."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for e in events:
        for v in e.get("summary", ()):
            if "simple_value" in v:
                out.setdefault(v["tag"], []).append((e["step"], v["simple_value"]))
    return out


def wav_samples(encoded: bytes) -> Tuple[np.ndarray, int]:
    """(int16 samples, sample rate) of a mono PCM16 WAV."""
    with wave.open(io.BytesIO(encoded), "rb") as w:
        if w.getnchannels() != 1 or w.getsampwidth() != 2:
            raise ValueError("want mono PCM16")
        return np.frombuffer(w.readframes(w.getnframes()), "<i2"), w.getframerate()


def crc_rate_mb_s(n_bytes: int = 1 << 20, repeats: int = 3) -> float:
    """The host's CRC-32C rate in MB/s on `n_bytes` of seeded random data
    (the best of `repeats`), for the record."""
    data = np.random.default_rng(0).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    crc32c(data)  # the tables
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        crc32c(data)
        best = min(best, time.perf_counter() - t0)
    return n_bytes / best / 1e6
