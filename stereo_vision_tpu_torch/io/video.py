"""Host-side video IO without OpenCV.

The port of ``stereo_vision_tpu/io/video.py``: the same functions, defaults
and frames, read and written without cv2 (the card's machine needs none).
The backend is picked from the file's header and extension, never by
catching another backend's failure:

- **Uncompressed AVI** (a RIFF ``AVI `` file whose video stream is
  ``Y800`` / ``GREY`` 8-bit gray or ``RGBA`` 32-bit, top-down rows,
  ``00dc`` chunks, an ``idx1`` index or none, and the OpenDML ``AVIX``
  parts a writer adds past 1 GiB) is
  read and written here in numpy, frames moved with ``readinto`` (which
  releases the GIL). These are the two raw formats cv2 writes and reads
  back bit for bit; what cv2 decodes from them, this module decodes.
- **Anything else** (``.mp4``, ``.mov``, a compressed AVI) goes through an
  ``ffmpeg`` subprocess (raw RGB frames on a pipe, ``ffprobe`` for the
  stream's size and rate) where ``ffmpeg`` is on ``PATH``, and otherwise
  raises ``IOError`` naming the format and the missing program.

``iter_frames(..., grayscale=True)`` converts as ``cv2.cvtColor(BGR2GRAY)``
does, ``(9798 R + 19235 G + 3735 B + 16384) >> 15`` (:func:`_cv2_gray`);
the frame ring's pack (``native.pack_gray``) keeps its 8.8 rule, as in the
reference. The writers write raw AVI for an ``.avi`` path (``Y800`` for
2-D frames, ``RGBA`` for colour) and encode other paths with ``ffmpeg``.
"""

from __future__ import annotations

import json
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Iterator

import numpy as np

from stereo_vision_tpu_torch.utils.profiling import span

VIDEO_EXTENSIONS = (".mp4", ".mov", ".avi", ".MP4", ".MOV")  # intrinsic.py:489-495

# Raw video formats read and written in numpy: fourcc -> (bits a pixel, channels of the decoded frame).
_RAW_FORMATS = {b"Y800": (8, 1), b"GREY": (8, 1), b"RGBA": (32, 3)}
_GRAY_FOURCC, _COLOR_FOURCC = b"Y800", b"RGBA"
_RIFF_LIMIT = 2**32 - 1  # a RIFF chunk's 32-bit size


def find_video(directory: str | Path, stem: str) -> Path | None:
    """Locate a video by stem trying alternate extensions
    (the reference's fallback chain, intrinsic.py:489-495)."""
    d = Path(directory)
    for ext in VIDEO_EXTENSIONS:
        p = d / f"{stem}{ext}"
        if p.exists():
            return p
    return None


def _cv2_gray(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> (...) uint8 gray, bit for bit
    ``cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)``: BT.601 in 15-bit fixed point,
    ``(9798 R + 19235 G + 3735 B + 16384) >> 15``."""
    f = rgb.astype(np.uint32)
    g = 9798 * f[..., 0] + 19235 * f[..., 1] + 3735 * f[..., 2] + 16384
    return (g >> 15).astype(np.uint8)


def _missing(path: Path, what: str, program: str) -> IOError:
    return IOError(f"{path}: {what} needs {program} to decode or encode, and {program} was not found on PATH")


def _container(path: Path) -> str:
    return f"a {path.suffix or 'extensionless'} container"


# ---------------------------------------------------------------- raw AVI


def _chunks(f, start: int, end: int) -> Iterator[tuple[bytes, int, int]]:
    """(id, data offset, size) of the RIFF chunks in [start, end); a LIST's
    id is its list type, its data the chunks after the type."""
    off = start
    while off + 8 <= end:
        f.seek(off)
        head = f.read(12)
        if len(head) < 8:
            return
        cid, size = head[:4], struct.unpack("<I", head[4:8])[0]
        if cid in (b"RIFF", b"LIST"):
            yield head[8:12], off + 12, size - 4
        else:
            yield cid, off + 8, size
        off += 8 + size + (size & 1)


class _AviReader:
    """The video stream of an AVI file: its format and where its frames lie.

    Raises IOError for a RIFF file that holds no video stream."""

    def __init__(self, path: Path):
        self.path = path
        with open(path, "rb") as f:
            size = f.seek(0, 2)
            self._parse(f, size)

    def _parse(self, f, size: int) -> None:
        stream, strh, strf, idx1, movis = None, None, None, None, []
        for riff_type, data, length in _chunks(f, 0, size):
            if riff_type not in (b"AVI ", b"AVIX"):
                continue
            for cid, off, n in _chunks(f, data, min(data + length, size)):
                if cid == b"hdrl":
                    k = 0
                    for sid, soff, sn in _chunks(f, off, off + n):
                        if sid != b"strl":
                            continue
                        parts = {c: (o, m) for c, o, m in _chunks(f, soff, soff + sn)}
                        if b"strh" not in parts:
                            continue
                        f.seek(parts[b"strh"][0])
                        head = f.read(parts[b"strh"][1])
                        if head[:4] == b"vids" and stream is None and b"strf" in parts:
                            f.seek(parts[b"strf"][0])
                            stream, strh, strf = k, head, f.read(parts[b"strf"][1])
                        k += 1
                elif cid == b"movi":
                    movis.append((off - 4, off + n))  # idx1 offsets count from the 'movi' type
                elif cid == b"idx1" and riff_type == b"AVI ":
                    f.seek(off)
                    idx1 = f.read(n)
        if stream is None:
            raise IOError(f"{self.path}: an AVI file with no video stream")
        scale, rate = struct.unpack("<2I", strh[20:28])
        _, width, height, _, bits, fourcc = struct.unpack("<IiiHH4s", strf[:20])
        self.fourcc, self.bits = fourcc, bits
        self.width, self.height = width, abs(height)
        self.fps = rate / scale if scale else 0.0
        self.raw = _RAW_FORMATS.get(fourcc, (None,))[0] == bits
        if not self.raw:
            return
        self.channels = _RAW_FORMATS[fourcc][1]
        self.frame_bytes = self.width * self.height * bits // 8
        ids = (b"%02ddc" % stream, b"%02ddb" % stream)
        self.frames_at = self._index(f, idx1, movis[0], ids) if idx1 and movis else None
        if self.frames_at is None:
            self.frames_at = [o for m in movis[:1] for o in self._walk(f, *m, ids)]
        for m in movis[1:]:  # OpenDML parts past the first RIFF: idx1 covers none of them
            self.frames_at += self._walk(f, *m, ids)
        self.frame_count = len(self.frames_at)

    @staticmethod
    def _index(f, idx1: bytes, movi: tuple[int, int], ids) -> list[tuple[int, int]] | None:
        """Data offsets and sizes of the stream's chunks from ``idx1``
        (offsets from the 'movi' type), or None where the index does not
        point at the stream's chunks (the caller then walks the list)."""
        entries = [struct.unpack("<4sIII", idx1[i:i + 16]) for i in range(0, len(idx1) - 15, 16)]
        entries = [(off, size) for cid, _, off, size in entries if cid in ids]
        if not entries:
            return None
        f.seek(movi[0] + entries[0][0])
        if f.read(4) not in ids:
            return None
        return [(movi[0] + off + 8, size) for off, size in entries]

    @staticmethod
    def _walk(f, start: int, end: int, ids) -> list[tuple[int, int]]:
        """Data offsets and sizes of the stream's chunks in a 'movi' list
        (index and JUNK chunks skipped)."""
        return [(off, n) for cid, off, n in _chunks(f, start + 4, end) if cid in ids]

    def frames(self, start: int, interval: int, max_frames: int | None,
               into: np.ndarray | None = None, clip: str | None = None) -> Iterator[tuple[int, np.ndarray]]:
        """(index, frame) from ``start`` every ``interval`` frames, at most
        ``max_frames`` (at least one, as the reference's loop tests after its
        yield). Frames are (H, W) gray or (H, W, 3) RGB uint8; with ``into``
        ((N, H, W[, 3])) the k-th frame is read into ``into[k % N]``, else
        each is a fresh array. Each frame's read is a ``loader.read`` span
        (``utils.profiling.span``) tagged ``clip``, its seq the window
        ``k // N`` it fills (None without ``into``)."""
        shape = (self.height, self.width) if self.channels == 1 else (self.height, self.width, 3)
        rgba = np.empty((self.height, self.width, 4), np.uint8) if self.channels == 3 else None
        with open(self.path, "rb", buffering=0) as f:
            for k, idx in enumerate(range(start, self.frame_count, interval)):
                out = np.empty(shape, np.uint8) if into is None else into[k % len(into)]
                off, size = self.frames_at[idx]
                if size != self.frame_bytes:
                    raise IOError(f"{self.path}: frame {idx} holds {size} bytes, a {self.fourcc.decode()} "
                                  f"frame of {self.width}x{self.height} {self.frame_bytes}")
                f.seek(off)
                buf = out if rgba is None else rgba
                with span("loader.read", None if into is None else k // len(into), clip):
                    got = f.readinto(memoryview(buf).cast("B"))
                if got != size:
                    raise IOError(f"{self.path}: frame {idx} is cut short")
                if rgba is not None:
                    for c in range(3):  # a plane at a time: ~4x faster than one (H, W, 3) strided copy
                        out[..., c] = rgba[..., c]
                yield idx, out
                if max_frames is not None and k + 1 >= max_frames:
                    return


class _AviWriter:
    """Raw AVI: one video stream (``Y800`` for 1 channel, ``RGBA`` for 3),
    ``00dc`` chunks, an ``idx1`` index; the sizes and counts are written on
    :meth:`close`. Raises IOError before a frame would take the file past
    a RIFF's 4 GiB."""

    def __init__(self, path: Path, width: int, height: int, fps: float, channels: int):
        self.path, self.width, self.height, self.channels = path, width, height, channels
        self.frame_bytes = width * height * (1 if channels == 1 else 4)
        base = 1
        while abs(round(fps * base) / base - fps) > 1e-3 and base < 10**6:  # cv2's writer's rate / scale
            base *= 10
        self.rate, self.scale = max(int(round(fps * base)), 1), base
        self.offsets: list[int] = []
        self._f = open(path, "wb")
        self._f.write(self._header(0))
        self._movi = self._f.tell() - 4  # the 'movi' type's offset: idx1's origin

    def _header(self, frames: int) -> bytes:
        fourcc = _GRAY_FOURCC if self.channels == 1 else _COLOR_FOURCC
        w, h, fb = self.width, self.height, self.frame_bytes
        usec = int(round(1e6 * self.scale / self.rate))
        avih = struct.pack("<10I16x", usec, fb * self.rate // self.scale, 0, 0x910, frames, 0, 1, fb, w, h)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, self.scale, self.rate, 0, frames,
                           fb, 0xFFFFFFFF, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 8 if self.channels == 1 else 32, fourcc, fb, 0, 0, 0, 0)
        strl = b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf)
        hdrl = b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
        movi_size = 4 + sum(8 + fb + (fb & 1) for _ in range(frames))
        riff_size = 4 + 8 + len(hdrl) + 8 + movi_size + 8 + 16 * frames
        return (b"RIFF" + struct.pack("<I", riff_size) + b"AVI " + _chunk(b"LIST", hdrl)
                + b"LIST" + struct.pack("<I", movi_size) + b"movi")

    def write(self, frame: np.ndarray) -> None:
        if self.channels == 3:
            rgba = np.empty((self.height, self.width, 4), np.uint8)
            rgba[..., :3] = frame
            rgba[..., 3] = 255
            frame = rgba
        pad = self.frame_bytes & 1
        end = self._f.tell() + 8 + self.frame_bytes + pad + 8 + 16 * (len(self.offsets) + 1)
        if end - 8 > _RIFF_LIMIT:
            raise IOError(f"{self.path}: frame {len(self.offsets)} would take the AVI past 4 GiB")
        self.offsets.append(self._f.tell() - self._movi)
        self._f.write(b"00dc" + struct.pack("<I", self.frame_bytes))
        self._f.write(memoryview(np.ascontiguousarray(frame)).cast("B"))
        if pad:
            self._f.write(b"\0")

    def close(self) -> None:
        if self._f.closed:
            return
        n = len(self.offsets)
        self._f.write(b"idx1" + struct.pack("<I", 16 * n))
        self._f.write(b"".join(struct.pack("<4sIII", b"00dc", 0x10, off, self.frame_bytes) for off in self.offsets))
        self._f.seek(0)
        self._f.write(self._header(n))
        self._f.close()


def _chunk(cid: bytes, data: bytes) -> bytes:
    return cid + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


# ---------------------------------------------------------------- ffmpeg


class _FfmpegReader:
    """A compressed video decoded by an ``ffmpeg`` subprocess (raw RGB
    frames on a pipe), its size and rate from ``ffprobe``."""

    channels = 3

    def __init__(self, path: Path, what: str):
        self.path = path
        self.ffmpeg, ffprobe = shutil.which("ffmpeg"), shutil.which("ffprobe")
        if self.ffmpeg is None or ffprobe is None:
            raise _missing(path, what, "ffmpeg" if self.ffmpeg is None else "ffprobe")
        out = subprocess.run([ffprobe, "-v", "error", "-select_streams", "v:0", "-show_entries",
                              "stream=width,height,avg_frame_rate,r_frame_rate,nb_frames:format=duration",
                              "-of", "json", str(path)], capture_output=True, text=True, timeout=300)
        info = json.loads(out.stdout or "{}")
        streams = info.get("streams") or []
        if out.returncode != 0 or not streams:
            raise IOError(f"could not open video: {path}")
        s = streams[0]
        self.width, self.height = int(s["width"]), int(s["height"])
        self.fps = next((_ratio(s.get(k)) for k in ("avg_frame_rate", "r_frame_rate") if _ratio(s.get(k))), 0.0)
        nb = s.get("nb_frames")
        duration = float(info.get("format", {}).get("duration") or 0.0)
        self.frame_count = int(nb) if nb and nb != "N/A" else int(np.floor(duration * self.fps + 0.5))

    def frames(self, start: int, interval: int, max_frames: int | None,
               into: np.ndarray | None = None, clip: str | None = None) -> Iterator[tuple[int, np.ndarray]]:
        """As :meth:`_AviReader.frames`; frames before ``start`` are decoded
        and dropped (their reads are spans without a seq)."""
        shape = (self.height, self.width, 3)
        nbytes = int(np.prod(shape))
        proc = subprocess.Popen([self.ffmpeg, "-v", "error", "-nostdin", "-i", str(self.path), "-f", "rawvideo",
                                 "-pix_fmt", "rgb24", "-"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        try:
            idx, k = 0, 0
            scratch = np.empty(shape, np.uint8)
            while True:
                keep = idx >= start and (idx - start) % interval == 0
                out = (np.empty(shape, np.uint8) if into is None else into[k % len(into)]) if keep else scratch
                view = memoryview(out).cast("B")
                got = 0
                with span("loader.read", k // len(into) if keep and into is not None else None, clip):
                    while got < nbytes:
                        n = proc.stdout.readinto(view[got:])
                        if not n:
                            break
                        got += n
                if got < nbytes:
                    return
                if keep:
                    yield idx, out
                    k += 1
                    if max_frames is not None and k >= max_frames:
                        return
                idx += 1
        finally:
            proc.kill()
            proc.wait()
            proc.stdout.close()


class _FfmpegWriter:
    """Frames encoded by an ``ffmpeg`` subprocess (MPEG-4 part 2, the
    reference's ``mp4v``) from raw RGB on its stdin; gray frames are
    repeated into the three channels, as the reference writes them."""

    channels = 3

    def __init__(self, path: Path, width: int, height: int, fps: float, channels: int):
        self.path = path
        self._proc = subprocess.Popen([shutil.which("ffmpeg"), "-v", "error", "-nostdin", "-y", "-f", "rawvideo",
                                       "-pix_fmt", "rgb24", "-s", f"{width}x{height}", "-r", repr(float(fps)),
                                       "-i", "-", "-c:v", "mpeg4", "-q:v", "2", str(path)],
                                      stdin=subprocess.PIPE, stderr=subprocess.DEVNULL)

    def write(self, frame: np.ndarray) -> None:
        if frame.ndim == 2:
            frame = np.stack([frame] * 3, axis=-1)
        self._proc.stdin.write(memoryview(np.ascontiguousarray(frame)).cast("B"))

    def close(self) -> None:
        if self._proc.stdin.closed:
            return
        self._proc.stdin.close()
        if self._proc.wait() != 0:
            raise IOError(f"{self.path}: ffmpeg failed to encode")


def _ratio(text) -> float:
    try:
        num, _, den = str(text).partition("/")
        return float(num) / float(den or 1)
    except (ValueError, ZeroDivisionError):
        return 0.0


# ---------------------------------------------------------------- entry points


def _open(video_path: str | Path):
    """The reader for a video file, picked from its header: raw AVI in
    numpy, anything else through ffmpeg (IOError where it is missing)."""
    path = Path(video_path)
    if not path.is_file():
        raise IOError(f"could not open video: {video_path}")
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        avi = _AviReader(path)
        if avi.raw:
            return avi
        what = f"an AVI stream of format {avi.fourcc!r} ({avi.bits} bits a pixel)"
    else:
        what = _container(path)
    return _FfmpegReader(path, what)


def iter_frames(
    video_path: str | Path,
    start: int = 0,
    interval: int = 1,
    max_frames: int | None = None,
    grayscale: bool = False,
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (frame_index, RGB/gray ndarray) from a video file."""
    reader = _open(video_path)
    for idx, frame in reader.frames(start, interval, max_frames):
        if grayscale:
            out = frame if reader.channels == 1 else _cv2_gray(frame)
        else:
            out = np.stack([frame] * 3, axis=-1) if reader.channels == 1 else frame
        yield idx, out


def extract_frames(
    video_path: str | Path,
    start: int = 0,
    interval: int = 15,
    max_frames: int = 20,
    grayscale: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Batch frame extraction: (frames (T, H, W[, 3]), indices (T,)).

    Defaults mirror the reference's sampling (interval 15, max 20,
    start 30 handled by the caller's config — intrinsic.py:452-467).
    """
    frames, indices = [], []
    for idx, f in iter_frames(video_path, start, interval, max_frames, grayscale):
        frames.append(f)
        indices.append(idx)
    if not frames:
        return np.empty((0,)), np.empty((0,), np.int64)
    return np.stack(frames), np.asarray(indices)


def video_info(video_path: str | Path) -> dict:
    """fps / frame count / size; all -1 for a file that does not exist (cv2
    5's properties of a capture that did not open)."""
    if not Path(video_path).is_file():
        return {"fps": -1.0, "frame_count": -1, "width": -1, "height": -1}
    r = _open(video_path)
    return {"fps": r.fps, "frame_count": r.frame_count, "width": r.width, "height": r.height}


def extract_timestamps_ffprobe(video_path: str | Path) -> np.ndarray:
    """Per-frame presentation timestamps via ffprobe
    (flash_sync.py:15-133). Returns (T,) seconds; empty array if ffprobe
    is unavailable."""
    try:
        out = subprocess.run(
            [
                "ffprobe",
                "-v", "quiet",
                "-select_streams", "v:0",
                "-show_entries", "frame=pts_time",
                "-of", "json",
                str(video_path),
            ],
            capture_output=True,
            text=True,
            timeout=300,
        )
        frames = json.loads(out.stdout).get("frames", [])
        return np.array([float(f["pts_time"]) for f in frames if "pts_time" in f])
    except (OSError, subprocess.SubprocessError, json.JSONDecodeError):
        return np.empty(0)


def _writer_backend(path: Path):
    """Raw AVI for an ``.avi`` path, else ffmpeg (IOError where it is missing)."""
    if path.suffix.lower() == ".avi":
        return _AviWriter
    if shutil.which("ffmpeg") is None:
        raise _missing(path, _container(path), "ffmpeg")
    return _FfmpegWriter


def write_video(
    path: str | Path,
    frames: np.ndarray,
    fps: float = 30.0,
    is_rgb: bool = True,
) -> Path:
    """Write (T, H, W[, 3]) frames: raw AVI for an ``.avi`` path (``Y800``
    for gray frames, ``RGBA`` for colour; read back bit for bit), else
    MPEG-4 through ffmpeg."""
    with VideoSink(path, fps, is_rgb) as sink:
        for f in np.asarray(frames):
            sink.append(f)
    return Path(path)


class VideoSink:
    """Incremental video writer: open once, append frames as they stream.

    ``write_video`` takes the whole clip at once; buffering a streaming
    pipeline's output that way is unbounded host memory (~2 MB/frame at
    1080p grayscale). The sink writes each window's frames as they
    arrive and sizes itself from the first frame; an ``.avi`` sink also
    takes its format from it (``Y800`` for a 2-D frame, refusing colour
    frames after it; ``RGBA`` for a colour one, gray frames repeated into
    its channels). Another path is encoded by ffmpeg (IOError here when it
    is missing).
    """

    def __init__(self, path: str | Path, fps: float = 30.0, is_rgb: bool = True):
        self.path = Path(path)
        self._backend = _writer_backend(self.path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.fps = float(fps)
        self.is_rgb = is_rgb
        self._vw = None
        self.frames = 0

    def append(self, frame: np.ndarray) -> None:
        f = np.asarray(frame)
        if f.ndim not in (2, 3) or (f.ndim == 3 and f.shape[2] != 3):
            raise ValueError(f"a frame is (H, W) or (H, W, 3), got {f.shape}")
        if self._vw is None:
            self._hw = (f.shape[0], f.shape[1])
            h, w = self._hw
            self._vw = self._backend(self.path, w, h, self.fps, 1 if f.ndim == 2 else 3)
        elif (f.shape[0], f.shape[1]) != self._hw:
            # The reference's cv2.VideoWriter.write silently drops
            # mismatched frames — fail loudly instead.
            raise ValueError(
                f"frame shape {f.shape[:2]} != sink shape {self._hw}"
            )
        if f.ndim == 3 and self._vw.channels == 1:
            raise ValueError(f"{self.path}: a gray (Y800) sink takes 2-D frames, got {f.shape}")
        if f.ndim == 2 and self._vw.channels == 3:
            f = np.stack([f] * 3, axis=-1)
        elif f.ndim == 3 and not self.is_rgb:
            f = f[..., ::-1]  # BGR -> RGB
        self._vw.write(np.ascontiguousarray(f, np.uint8))
        self.frames += 1

    def close(self) -> None:
        if self._vw is not None:
            self._vw.close()
            self._vw = None

    def __enter__(self) -> "VideoSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def create_synchronized_videos(
    left_video: str | Path,
    right_video: str | Path,
    left_start: int,
    right_start: int,
    out_dir: str | Path,
    duration_frames: int | None = None,
    fps: float | None = None,
) -> tuple[Path, Path]:
    """Write an aligned stereo pair starting at the given frame indices
    (the reference writes flash+3s onward — flash_sync.py:238-319; callers
    pass flash_frame + 3*fps here). A raw AVI source gives
    ``left_synced.avi`` / ``right_synced.avi`` in its own format, frames
    copied exactly; any other gives ``left_synced.mp4`` /
    ``right_synced.mp4`` through ffmpeg, as the reference names them."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = []
    for src, start, stem in (
        (left_video, left_start, "left_synced"),
        (right_video, right_start, "right_synced"),
    ):
        reader = _open(src)
        n = duration_frames if duration_frames is not None else reader.frame_count - start
        dst = out_dir / (f"{stem}.avi" if isinstance(reader, _AviReader) else f"{stem}.mp4")
        vw = _writer_backend(dst)(dst, reader.width, reader.height, fps or reader.fps or 30.0, reader.channels)
        try:
            if n > 0:
                for _, frame in reader.frames(start, 1, n):
                    vw.write(frame)
        finally:
            vw.close()
        outs.append(dst)
    return outs[0], outs[1]
