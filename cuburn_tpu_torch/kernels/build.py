"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C entry point;
what several share lives in `csrc/*.cuh` headers.  `nvcc` compiles a
source for Hopper (`sm_90a`) into a shared library under
`cuburn_tpu_torch/_build/`, named by a hash of the source, every header
and the flags, and `ctypes` loads it.  The build runs at first use in a
process, from the sources in the checkout; a library already built from
the same source is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# flags of one library on top of NVCC_FLAGS.  The chaos game rounds every
# float op as PyTorch does: no FMA contraction, and no --use_fast_math
# (which would also fold away its isfinite test); ptxas reports its
# registers and spills into the library's .log.
LIBRARY_FLAGS = {"chaos_iterate": ("-fmad=false", "-Xptxas", "-v")}

_LOADED: dict = {}
# (library, entry) -> its ctypes function with argtypes and restype set
_ENTRIES: dict = {}


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default install location.  Raises if there is none."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from csrc/<name>.cu with NVCC_FLAGS and
    its LIBRARY_FLAGS lives.  The name changes with the source and with
    any csrc/*.cuh header, so a changed header rebuilds every library."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    if name in LIBRARY_FLAGS:
        digest.update(" ".join(LIBRARY_FLAGS[name]).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this exact source
    already exists; returns the library path.  What the compiler prints
    on success goes to the library's .log beside it.  Raises
    RuntimeError with the compiler's output if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *LIBRARY_FLAGS.get(name, ()), "-o",
           str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    if proc.stdout or proc.stderr:
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)    # atomic: concurrent builders never see half
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per
    process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib


def _entry(lib, entry: str, argtypes):
    """C entry `entry` of the loaded library `lib`, typed once: its
    argtypes are `argtypes` plus the trailing stream, it returns int."""
    fn = _ENTRIES.get((lib, entry))
    if fn is None:
        fn = getattr(lib, entry)
        fn.argtypes = (*argtypes, ctypes.c_void_p)
        fn.restype = ctypes.c_int
        _ENTRIES[(lib, entry)] = fn
    return fn


def launch(counts: dict, kernel: str, lib: str, entry: str, argtypes,
           stream: int, *args) -> None:
    """One kernel launch: call C entry `entry` of csrc/<lib>.cu, which
    launches exactly one kernel on `stream` (a raw handle, as
    torch.cuda.current_stream(device).cuda_stream gives it; no sync) and
    returns cudaGetLastError(), then add one to counts[kernel].
    `argtypes` leaves out the trailing stream argument; pointers are
    passed as ints.  Raises RuntimeError on a launch error, uncounted."""
    fn = _entry(load(lib), entry, argtypes)
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    counts[kernel] += 1
