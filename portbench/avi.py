"""Raw gray (``Y800``) AVI files: the writer that makes a run's clips and the reader of the reference.

The writer is a frozen copy of ``stereo_vision_tpu_torch/io/video.py``'s ``_AviWriter`` (the ``Y800``
path: one video stream, ``00dc`` chunks, an ``idx1`` index, sizes written on close) and ``_chunk`` at
commit 32282d13a4194c9fbd48da53129198c48182e76c, so that a change to the program cannot change the
benchmark's inputs. The reader is the benchmark's own: it walks the RIFF chunks to the ``idx1`` index and
reads each indexed frame, independent of the program's decoder.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

FOURCC = b"Y800"


def _chunk(cid: bytes, data: bytes) -> bytes:
    return cid + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _header(width: int, height: int, rate: int, scale: int, frames: int) -> bytes:
    w, h, fb = width, height, width * height
    usec = int(round(1e6 * scale / rate))
    avih = struct.pack("<10I16x", usec, fb * rate // scale, 0, 0x910, frames, 0, 1, fb, w, h)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", FOURCC, 0, 0, 0, 0, scale, rate, 0, frames, fb,
                       0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 8, FOURCC, fb, 0, 0, 0, 0)
    strl = b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf)
    hdrl = b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
    movi_size = 4 + sum(8 + fb + (fb & 1) for _ in range(frames))
    riff_size = 4 + 8 + len(hdrl) + 8 + movi_size + 8 + 16 * frames
    return (b"RIFF" + struct.pack("<I", riff_size) + b"AVI " + _chunk(b"LIST", hdrl)
            + b"LIST" + struct.pack("<I", movi_size) + b"movi")


def write_y800(path: Path, frames: np.ndarray, fps: float) -> None:
    """(T, H, W) uint8 frames -> a raw Y800 AVI at ``path``."""
    T, height, width = frames.shape
    base = 1
    while abs(round(fps * base) / base - fps) > 1e-3 and base < 10**6:
        base *= 10
    rate, scale = max(int(round(fps * base)), 1), base
    fb = width * height
    with open(path, "wb") as f:
        f.write(_header(width, height, rate, scale, 0))
        movi = f.tell() - 4  # the 'movi' type's offset: idx1's origin
        offsets = []
        for frame in frames:
            offsets.append(f.tell() - movi)
            f.write(b"00dc" + struct.pack("<I", fb))
            f.write(memoryview(np.ascontiguousarray(frame, np.uint8)).cast("B"))
            if fb & 1:
                f.write(b"\0")
        f.write(b"idx1" + struct.pack("<I", 16 * len(offsets)))
        f.write(b"".join(struct.pack("<4sIII", b"00dc", 0x10, off, fb) for off in offsets))
        f.seek(0)
        f.write(_header(width, height, rate, scale, len(offsets)))
        f.flush()
        os.fsync(f.fileno())  # written back now, in set-up, not during the measured window


def read_y800(path: Path, indices) -> np.ndarray:
    """The frames ``indices`` of a raw Y800 AVI as a (len(indices), H, W) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise IOError(f"{path}: not an AVI file")
    width = height = movi = index = None
    off = 12
    while off + 8 <= len(data):
        cid, size = data[off:off + 4], struct.unpack("<I", data[off + 4:off + 8])[0]
        if cid == b"LIST" and data[off + 8:off + 12] == b"hdrl":
            sub = data[off + 12: off + 8 + size]
            at = sub.find(b"strf")
            _, width, height, _, bits, fourcc = struct.unpack("<IiiHH4s", sub[at + 8: at + 28])
            if (bits, fourcc) != (8, FOURCC):
                raise IOError(f"{path}: a {fourcc!r} stream of {bits} bits, not Y800")
        elif cid == b"LIST" and data[off + 8:off + 12] == b"movi":
            movi = off + 8
        elif cid == b"idx1":
            index = [struct.unpack("<4sIII", data[i:i + 16]) for i in range(off + 8, off + 8 + size, 16)]
        off += 8 + size + (size & 1)
    if width is None or movi is None or index is None:
        raise IOError(f"{path}: no video stream, movi list or index")
    height = abs(height)
    frames = [e for e in index if e[0] == b"00dc"]
    out = np.empty((len(indices), height, width), np.uint8)
    for k, i in enumerate(indices):
        _, _, at, size = frames[i]
        if size != width * height:
            raise IOError(f"{path}: frame {i} holds {size} bytes")
        start = movi + at + 8
        out[k] = np.frombuffer(data, np.uint8, size, start).reshape(height, width)
    return out
