"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C entry point;
what several share lives in `csrc/*.cuh` headers.  `nvcc` compiles a
source for Hopper (`sm_90a`) into a shared library under
`cuburn_tpu_torch/_build/`, named by a hash of the source, every header,
the flags and the `-D` definitions, and `ctypes` loads it.  A source
built with other definitions is another library: the chaos game's
kernel is compiled once per structure key that way
(`ops/chaos.key_defines`).  The build runs at first use in a process,
from the sources in the checkout; a library already built from the same
source and definitions is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
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


def library_path(name: str, defines=()) -> Path:
    """Where the library built from csrc/<name>.cu with NVCC_FLAGS, its
    LIBRARY_FLAGS and `-D` + each of `defines` lives.  The name changes
    with the source, the definitions and any csrc/*.cuh header, so a
    changed header rebuilds every library."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    if name in LIBRARY_FLAGS:
        digest.update(" ".join(LIBRARY_FLAGS[name]).encode())
    if defines:
        digest.update(("\0".join(("-D", *defines))).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, defines=()) -> Path:
    """Compile csrc/<name>.cu with `-D` + each of `defines` unless the
    library for this exact source and definitions already exists;
    returns the library path.  What the compiler prints on success goes
    to the library's .log beside it.  Raises RuntimeError with the
    compiler's output if nvcc fails."""
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *LIBRARY_FLAGS.get(name, ()),
           *(f"-D{d}" for d in defines), "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(
        f"{name}.cu {' '.join(defines)}\nbuild seconds: "
        f"{time.perf_counter() - t0:.3f}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)    # atomic: concurrent builders never see half
    return out


def report(build_dir: Path = BUILD_DIR) -> list:
    """One line a library built in `build_dir`, from its .log: the
    source and definitions, the build's seconds, and ptxas's registers,
    stack frame and spills where the flags asked for them."""
    lines = []
    for log in sorted(build_dir.glob("*.log")):
        text = log.read_text().splitlines()
        ptxas = [ln.strip() for ln in text
                 if "registers" in ln or "stack frame" in ln]
        lines.append(" | ".join([log.stem, *text[:2], *ptxas]))
    return lines


def load(name: str, defines=()) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library of csrc/<name>.cu
    with `defines`, once per process."""
    defines = tuple(defines)
    lib = _LOADED.get((name, defines))
    if lib is None:
        lib = ctypes.CDLL(str(build(name, defines)))
        _LOADED[name, defines] = lib
    return lib


def typed_entry(lib, entry: str, argtypes):
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
           stream: int, *args, defines=()) -> None:
    """One kernel launch: call C entry `entry` of csrc/<lib>.cu built
    with `defines`, which launches exactly one kernel on `stream` (a raw
    handle, as torch.cuda.current_stream(device).cuda_stream gives it;
    no sync) and returns cudaGetLastError(), then add one to
    counts[kernel].  `argtypes` leaves out the trailing stream argument;
    pointers are passed as ints.  Raises RuntimeError on a launch error,
    uncounted."""
    fn = typed_entry(load(lib, defines) if defines else load(lib), entry,
                     argtypes)
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    counts[kernel] += 1


if __name__ == "__main__":
    # python -m cuburn_tpu_torch.kernels.build: what was built here
    print("\n".join(report()))
