"""Output sinks: PNG/JPEG stills and raw/y4m video pipes.

The port's own copy of `cuburn_tpu/output.py`, without its optional C
encoder: PNG is written here with zlib (standard library), JPEG with
PIL.  The decoded pixels are the JAX package's; the bytes may differ.

Equivalent of the reference's cuburn/output.py (SURVEY.md §2 layer 5):
PIL-based still writer plus a frame pipe suitable for feeding ffmpeg /
x264 downstream.  The y4m writer is dependency-free so animations work
even without an encoder installed.
"""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import zlib
from typing import IO

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgba: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 4) u8 -> PNG bytes: 8-bit RGBA, no interlace, filter 0 on
    every row, one zlib stream."""
    h, w = rgba.shape[:2]
    rows = np.zeros((h, 1 + 4 * w), np.uint8)     # leading 0: no filter
    rows[:, 1:] = rgba.reshape(h, 4 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def write_image(path: str, img: np.ndarray):
    """Write a (H, W, 4) or (H, W, 3) u8 frame as PNG/JPEG by
    extension (RGB is upgraded to opaque RGBA, like the video sinks).

    PNG goes through encode_png (zlib); JPEG uses PIL."""
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        from PIL import Image
        Image.fromarray(arr[..., :3], "RGB").save(path, quality=95)
        return
    if arr.ndim == 3 and arr.shape[2] == 3:
        arr = np.concatenate(
            [arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)],
            axis=2)
    with open(path, "wb") as f:
        f.write(encode_png(arr))


class Y4MSink:
    """Stream frames as yuv4mpeg2 (mono-convertible by any encoder).

    Writes 4:4:4 YCbCr; plays with `mpv file.y4m` or pipes into
    `ffmpeg -i - out.mp4`."""

    def __init__(self, stream_or_path, width: int, height: int,
                 fps: float = 24.0):
        if isinstance(stream_or_path, (str, os.PathLike)):
            self.stream: IO[bytes] = open(stream_or_path, "wb")
            self._own = True
        else:
            self.stream = stream_or_path
            self._own = False
        num = int(round(fps * 1000))
        # XCOLORRANGE=FULL: the frames are full-range BT.601; without
        # the param decoders assume limited range and crush contrast
        self.stream.write(
            f"YUV4MPEG2 W{width} H{height} F{num}:1000 Ip A1:1 C444 "
            f"XCOLORRANGE=FULL\n".encode())

    def write_frame(self, img: np.ndarray):
        arr = np.ascontiguousarray(img, dtype=np.uint8)
        self.stream.write(b"FRAME\n")
        rgb = arr[..., :3].astype(np.float32) / 255.0
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 0.5 + (b - y) * 0.564
        cr = 0.5 + (r - y) * 0.713
        for plane in (y, cb, cr):
            self.stream.write(
                np.clip(plane * 255.0 + 0.5, 0, 255)
                .astype(np.uint8).tobytes())

    def close(self):
        if self._own:
            self.stream.close()


class FFmpegSink:
    """Pipe frames into ffmpeg if available (H.264 etc.).

    Equivalent of the reference's encoder pipe (SURVEY.md §3.1 process
    boundary at output)."""

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 24.0, codec: str = "libx264"):
        import tempfile
        self.path = path
        self._err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgba",
             "-s", f"{width}x{height}", "-r", str(fps), "-i", "-",
             "-an", "-c:v", codec, "-pix_fmt", "yuv420p", path],
            stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=self._err)

    def write_frame(self, img: np.ndarray):
        img = np.asarray(img, np.uint8)
        if img.ndim == 3 and img.shape[2] == 3:
            # ffmpeg was launched expecting rgba frames; silently
            # writing w*h*3 bytes would shift every later frame
            # boundary (Y4MSink upgrades RGB the same way)
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)],
                axis=2)
        try:
            self.proc.stdin.write(img.tobytes())
        except BrokenPipeError:
            raise RuntimeError(
                f"ffmpeg died while encoding {self.path}:\n"
                + self._err_tail())

    def _err_tail(self) -> str:
        try:
            self._err.seek(0)
            return self._err.read().decode(
                errors="replace")[-2000:]
        except Exception:
            return "(stderr unavailable)"

    def close(self):
        try:
            self.proc.stdin.close()
        except (BrokenPipeError, OSError):
            # ffmpeg already died with buffered stdin pending; fall
            # through so the user sees rc + the stderr tail, not a
            # raw BrokenPipeError
            pass
        rc = self.proc.wait()
        tail = self._err_tail()
        self._err.close()
        if rc != 0:
            raise RuntimeError(
                f"ffmpeg exited with {rc} for {self.path}:\n{tail}")


def make_video_sink(path: str, width: int, height: int, fps: float):
    if path.endswith(".y4m"):
        return Y4MSink(path, width, height, fps)
    try:
        subprocess.run(["ffmpeg", "-version"], capture_output=True,
                       timeout=10)
        return FFmpegSink(path, width, height, fps)
    except (OSError, subprocess.TimeoutExpired):
        y4m = os.path.splitext(path)[0] + ".y4m"
        print(f"ffmpeg unavailable; writing {y4m}", file=sys.stderr)
        return Y4MSink(y4m, width, height, fps)
