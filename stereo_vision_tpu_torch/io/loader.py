"""Prefetching video-window loader over the native frame ring.

The port of ``stereo_vision_tpu/io/loader.py``. The card consumes WINDOWS
of frames (``parallel.streaming.stream_video_pair``: 32 frames a hier4x3
call, 8 a BM one), so the host's job is to have the next window decoded,
grayscale-packed and contiguous by the time the card finishes the current
one.

Shape of the pipeline::

    decode thread (io.video: raw AVI frames read with readinto, or an
    ffmpeg pipe; both release the GIL)
        -> native ring_put_gray (C++ OpenMP RGB->gray pack into a slot,
           GIL released; blocks when the ring is full = backpressure),
           or ring_put_raw for a gray video (the pack of a gray pixel
           repeated into R, G and B is the pixel itself)
        -> consumer ring_get_into (GIL-released memcpy into a fresh numpy
           window)

With the native extension unavailable, a queue.Queue fallback keeps the
same API (pack via numpy; still overlaps decode with compute because file
reads and numpy release the GIL for the heavy parts).

Both backends count their waits (:func:`ring_counters`, read through
``utils.profiling.counters``), and the decode threads and the consumer
record spans (``utils.profiling.span``): ``loader.read`` a frame,
``loader.put`` a window into the ring, ``loader.get`` a window out of it,
each with the window's seq and its clip ("left" or "right").

``VideoPrefetcher`` streams one video; ``StereoPairLoader`` zips two
prefetchers into aligned (left, right) windows.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from pathlib import Path
from typing import Iterator

import numpy as np

from stereo_vision_tpu_torch import native
from stereo_vision_tpu_torch.io import video
from stereo_vision_tpu_torch.utils.profiling import span

_WAIT_KEYS = ("put_wait_ns", "puts", "get_wait_ns", "gets")
_fallback_totals = dict.fromkeys(_WAIT_KEYS, 0)  # every fallback ring's, closed ones too
_fallback_lock = threading.Lock()


def ring_counters() -> dict[str, int]:
    """Nanoseconds waited and calls, on each side, summed over every frame
    ring of the process since it started, closed ones too: ``put_wait_ns``
    and ``puts`` (producers waiting for a free slot), ``get_wait_ns`` and
    ``gets`` (consumers waiting for a filled slot); both backends."""
    with _fallback_lock:
        totals = dict(_fallback_totals)
    for k, v in zip(_WAIT_KEYS, native.frame_ring_totals()):
        totals[k] += v
    return totals


def _tally(waits: dict, side: str, t0: int | None) -> None:
    """Add a fallback call and its wait since ``t0`` (None: it did not wait)
    to the ring's ``waits`` and to the process's totals."""
    waited = 0 if t0 is None else time.monotonic_ns() - t0
    with _fallback_lock:
        for d in (waits, _fallback_totals):
            d[f"{side}_wait_ns"] += waited
            d[f"{side}s"] += 1


class FrameRing:
    """Fixed-capacity blocking ring of equal-sized uint8 windows.

    Native-backed (C++ mutex/condvar, GIL-free waits) when the extension
    builds; otherwise a bounded ``queue.Queue``. Both backends are MPMC:
    seqs are dense 0,1,2,... in publish order under any number of
    producers/consumers. The fallback serializes producers on a lock for
    the claim+enqueue pair — an unlocked read-then-increment of ``_seq``
    double-assigns seqs under producer contention, and enqueue-after-claim
    without the lock would publish out of seq order.

    Each put and get adds its wait to the ring's :meth:`waits` and to
    :func:`ring_counters`: from the call's first try that finds the lock
    taken or the slot not ready to the slot's release. The fallback times
    the same waits (its producers' lock included) but not the queue's own
    internal lock, which it holds only for an append or a pop.
    """

    def __init__(self, slots: int, slot_shape: tuple[int, ...]):
        self.slot_shape = tuple(int(s) for s in slot_shape)
        self.slot_bytes = int(np.prod(self.slot_shape))
        self._mod = native.frame_ring_module()
        if self._mod is not None:
            self._h = self._mod.ring_create(int(slots), self.slot_bytes)
            self._q = None
        else:
            self._h = None
            self._q = queue.Queue(maxsize=int(slots))
            self._seq = 0
            self._closed = threading.Event()
            self._plock = threading.Lock()
            self._waits = dict.fromkeys(_WAIT_KEYS, 0)

    # -- producer side -------------------------------------------------
    def put_gray(self, rgb: np.ndarray) -> int:
        """Pack (..., 3) uint8 RGB to grayscale into a slot; returns seq.

        Blocks while the ring is full (backpressure on the decode thread).
        """
        rgb = np.ascontiguousarray(rgb, np.uint8)
        if rgb.size != self.slot_bytes * 3:
            raise ValueError(
                f"rgb size {rgb.size} != slot_bytes*3 {self.slot_bytes * 3}"
            )
        if self._mod is not None:
            return self._mod.ring_put_gray(self._h, rgb)
        gray = native.pack_gray(rgb.reshape((-1,) + rgb.shape[-3:])).reshape(
            self.slot_shape
        )
        return self._put_fallback(gray)

    def put(self, window: np.ndarray) -> int:
        """memcpy a pre-packed uint8 window of slot_shape; returns seq."""
        window = np.ascontiguousarray(window, np.uint8)
        if window.size != self.slot_bytes:
            raise ValueError(f"window size {window.size} != {self.slot_bytes}")
        if self._mod is not None:
            return self._mod.ring_put_raw(self._h, window)
        return self._put_fallback(window.copy())

    def _put_fallback(self, arr: np.ndarray) -> int:
        # _plock is held ACROSS the blocking retry loop: when the ring
        # is full, all producers serialize behind one waiter, and a
        # blocked producer observes close() one 50 ms tick at a time.
        # Correct under contention, and enough for one decode thread a
        # ring; if multi-producer throughput ever matters, claim
        # self._seq under the lock but wait for queue space OUTSIDE it on
        # a condition variable.
        t0 = None  # set at the first try that finds the lock taken or the ring full
        if not self._plock.acquire(blocking=False):
            t0 = time.monotonic_ns()
            self._plock.acquire()
        try:
            while True:
                if self._closed.is_set():
                    raise RuntimeError("put on closed ring")
                try:
                    self._q.put((self._seq, arr), block=t0 is not None, timeout=0.05)
                except queue.Full:
                    t0 = time.monotonic_ns() if t0 is None else t0
                    continue
                seq = self._seq
                self._seq += 1
                return seq
        finally:
            _tally(self._waits, "put", t0)
            self._plock.release()

    # -- consumer side ---------------------------------------------------
    def get(self, timeout: float | None = None) -> tuple[int, np.ndarray] | None:
        """Next (seq, window) in put order; None when closed and drained.

        ``timeout`` seconds (None = wait forever) raises queue.Empty on
        expiry, mirroring queue.Queue semantics.
        """
        if self._mod is not None:
            out = np.empty(self.slot_shape, np.uint8)
            ms = -1 if timeout is None else max(int(timeout * 1000), 0)
            while True:
                seq = self._mod.ring_get_into(self._h, out, ms)
                if seq == -2:
                    return None
                if seq == -1:
                    if timeout is not None:
                        raise queue.Empty()
                    continue  # spurious wake under infinite wait
                return seq, out
        t0 = None  # set at the first try that finds the ring empty
        try:
            while True:
                try:
                    return self._q.get(block=t0 is not None, timeout=0.05 if timeout is None else timeout)
                except queue.Empty:
                    if self._closed.is_set() and self._q.empty():
                        return None
                    if t0 is None:
                        t0 = time.monotonic_ns()
                    elif timeout is not None:
                        raise
        finally:
            _tally(self._waits, "get", t0)

    def close(self) -> None:
        if self._mod is not None:
            self._mod.ring_close(self._h)
        else:
            self._closed.set()

    def waits(self) -> dict[str, int]:
        """This ring's ``put_wait_ns``, ``puts``, ``get_wait_ns`` and ``gets``."""
        if self._mod is not None:
            return dict(zip(_WAIT_KEYS, self._mod.ring_waits(self._h)))
        with _fallback_lock:
            return dict(self._waits)

    def stats(self) -> tuple[int, int, bool]:
        """(occupied, slots, closed)."""
        if self._mod is not None:
            n, s, c = self._mod.ring_stats(self._h)
            return n, s, bool(c)
        return self._q.qsize(), self._q.maxsize, self._closed.is_set()

    def __del__(self):
        try:
            if getattr(self, "_mod", None) is not None:
                self._mod.ring_destroy(self._h)
        except Exception:
            pass


class VideoPrefetcher:
    """Background-decoded grayscale window stream from one video.

    Iterating yields ``(seq, window (T, H, W) uint8, n_valid)`` in order;
    the final partial window is padded by repeating its last frame and
    reports ``n_valid < T``. The decode thread blocks when ``depth``
    windows are already buffered (bounded memory). Raises IOError at once
    for a video that cannot be opened or decoded here (``io.video``); an
    error while decoding is raised on the consumer side. ``clip`` ("left"
    or "right") tags the spans of its decode thread and its gets.
    """

    def __init__(
        self,
        video_path: str | Path,
        window: int,
        start: int = 0,
        interval: int = 1,
        max_frames: int | None = None,
        depth: int = 3,
        clip: str | None = None,
    ):
        reader = video._open(video_path)
        if reader.width <= 0 or reader.height <= 0:
            raise IOError(f"could not open video: {video_path}")
        self.window = int(window)
        self.height, self.width = reader.height, reader.width
        self.fps = reader.fps
        self.clip = clip
        self._ring = FrameRing(depth, (self.window, self.height, self.width))
        # Single-producer seq counter mirrors the ring's; metadata for a
        # seq is recorded BEFORE its put so the consumer never misses it.
        self._meta: dict[int, int] = {}
        self._next_seq = 0
        self._err: list[BaseException] = []
        self._thread = threading.Thread(
            target=self._produce,
            args=(reader, start, interval, max_frames),
            daemon=True,
            name=f"decode-{clip}" if clip else None,
        )
        self._thread.start()

    def _produce(self, reader, start, interval, max_frames):
        # Frames are decoded straight into the window: RGB, packed by the
        # ring's put_gray, or gray (a gray video), copied by its put.
        gray = reader.channels == 1
        win = np.empty((self.window, self.height, self.width) + (() if gray else (3,)), np.uint8)
        put = self._ring.put if gray else self._ring.put_gray
        n = 0
        try:
            for _ in reader.frames(start, interval, max_frames, into=win, clip=self.clip):
                n += 1
                if n == self.window:
                    self._emit(put, win, n)
                    n = 0
            if n:
                win[n:] = win[n - 1]  # pad the tail window
                self._emit(put, win, n)
        except BaseException as e:  # surfaced on the consumer side
            self._err.append(e)
        finally:
            self._ring.close()

    def _emit(self, put, win: np.ndarray, n_valid: int) -> None:
        seq = self._next_seq
        self._meta[seq] = n_valid
        self._next_seq += 1
        with span("loader.put", seq, self.clip):
            put(win)  # copies (or packs) into a ring slot before it returns

    def __iter__(self) -> Iterator[tuple[int, np.ndarray, int]]:
        for expected in itertools.count():  # the ring's seqs are dense, in put order
            with span("loader.get", expected, self.clip):
                item = self._ring.get()
            if item is None:
                if self._err:
                    raise self._err[0]
                return
            seq, win = item
            yield seq, win, self._meta.pop(seq)

    def close(self) -> None:
        self._ring.close()


class StereoPairLoader:
    """Aligned (left, right) grayscale windows from two videos.

    The reference syncs streams by frame offset (stereo_frame_sync.py via
    sync/mapper.py); pass the per-stream ``start`` offsets from the flash
    sync here. Yields ``(seq, left (T,H,W), right (T,H,W), n_valid)``; the
    stream ends when either side ends (windows stay aligned — both sides
    share window/interval).
    """

    def __init__(
        self,
        left_path: str | Path,
        right_path: str | Path,
        window: int,
        left_start: int = 0,
        right_start: int = 0,
        interval: int = 1,
        max_frames: int | None = None,
        depth: int = 3,
    ):
        self.left = VideoPrefetcher(
            left_path, window, left_start, interval, max_frames, depth, clip="left"
        )
        self.right = VideoPrefetcher(
            right_path, window, right_start, interval, max_frames, depth, clip="right"
        )

    def __iter__(self):
        for (sl, wl, nl), (sr, wr, nr) in zip(iter(self.left), iter(self.right)):
            if sl != sr:
                raise RuntimeError(f"stereo prefetchers desynced: left window {sl}, right {sr}")
            yield sl, wl, wr, min(nl, nr)
        self.close()

    def close(self) -> None:
        self.left.close()
        self.right.close()
