"""The native output encoder: `fastout.c`, built at first use.

The host C compiler (`$CC`, else `cc`) builds `fastout.c` into a shared
library under `cuburn_tpu_torch/_build/`, named by a hash of the source
and the flags, and `ctypes` loads it, as kernels/build.py does for the
CUDA kernels.  Nothing is built at import time.  Where there is no C
compiler or the build fails, `load` says so once on stderr and returns
None, and output.py keeps its Python encoders.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("fastout.c")
BUILD_DIR = SOURCE.parent.parent / "_build"
CFLAGS = ("-O3", "-shared", "-fPIC")

_LIB: list = []         # [the loaded library, or None] once tried


def find_cc() -> str:
    """The host C compiler: $CC, else cc on PATH.  Raises RuntimeError
    if there is none."""
    path = shutil.which(os.environ.get("CC") or "cc")
    if path is None:
        raise RuntimeError("no C compiler (set CC or put cc on PATH)")
    return path


def library_path() -> Path:
    """Where the library built from fastout.c with CFLAGS lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"libfastout-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile fastout.c unless the library for this exact source
    exists; returns its path.  Raises RuntimeError with the compiler's
    output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([find_cc(), *CFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cc failed building fastout.c (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)    # atomic: a concurrent build never sees half
    return out


def load():
    """The loaded library with its entries typed, or None where it
    cannot be built (said once on stderr).  Built and loaded once a
    process."""
    if not _LIB:
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            print(f"cuburn-tpu-torch: native output encoder unavailable "
                  f"({str(e).splitlines()[0]}); using the Python encoders",
                  file=sys.stderr)
            lib = None
        else:
            u8p = ctypes.c_void_p
            lib.paeth_rows.argtypes = (u8p, ctypes.c_int64, ctypes.c_int64,
                                       u8p)
            lib.rgb_to_ycbcr444.argtypes = (u8p, ctypes.c_int64,
                                            ctypes.c_int64, u8p)
            lib.paeth_rows.restype = lib.rgb_to_ycbcr444.restype = None
        _LIB.append(lib)
    return _LIB[0]


def _pixels(img: np.ndarray, channels) -> np.ndarray:
    """`img` as a C-contiguous (H, W, C) u8 array, C in `channels`."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] not in channels:
        raise ValueError(f"expected (H, W, {' or '.join(map(str, channels))})"
                         f" u8 pixels, got shape {img.shape}")
    return img


def paeth_rows(rgba: np.ndarray) -> bytes:
    """(H, W, 4) u8 -> the PNG scanlines of the frame: each row's filter
    byte (4, Paeth) and its Paeth-filtered bytes.  Needs `load()`."""
    rgba = _pixels(rgba, (4,))
    h, w = rgba.shape[:2]
    out = np.empty((h, 1 + 4 * w), np.uint8)
    load().paeth_rows(rgba.ctypes.data, w, h, out.ctypes.data)
    return out.tobytes()


def rgb_to_ycbcr444(img: np.ndarray) -> bytes:
    """(H, W, 3 or 4) u8 -> planar Y, Cb, Cr planes of H x W bytes each
    (BT.601 full range, x1024 fixed point).  Needs `load()`."""
    img = _pixels(img, (3, 4))
    h, w, c = img.shape
    out = np.empty(3 * h * w, np.uint8)
    load().rgb_to_ycbcr444(img.ctypes.data, h * w, c, out.ctypes.data)
    return out.tobytes()
