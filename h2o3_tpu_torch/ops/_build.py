"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

Every ``csrc/*.cu`` source compiles, on first use and never at import, into
one library under ``build/`` beside this package (listed in ``.gitignore``).
The file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is loaded from the cache.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points: name -> (restype, argtypes). Pointers and the stream are
# c_void_p (a bare Python int would be cut to 32 bits), counts c_int or
# c_longlong as the C signature has them.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "h2o3_level_hist": (_I, [_I, _P, _I, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _L, _P]),
    "h2o3_level_hist_blocks_per_sm": (_I, [_I, _I, _I, _I,
                                           ctypes.POINTER(_I)]),
    "h2o3_cuda_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the last build or load did: library path, seconds spent compiling
#: (0.0 when the cached library was reused) and the compiler's output,
#: which includes ptxas' per-kernel register and shared-memory report
build_info: dict = {}


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, else ``PATH``, else the toolkit's default
    install location; raises when none has it."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit or put nvcc on "
        "PATH; the port's CUDA kernels are compiled on first use")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if no library for their hash exists; return it."""
    srcs = _sources()
    target = BUILD_DIR / f"libh2o3_torch_{_digest(srcs)}.so"
    if target.is_file():
        build_info.update(path=str(target), seconds=0.0, log="")
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, target)   # atomic: a concurrent builder sees all or none
    build_info.update(path=str(target), seconds=seconds, log=log)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().h2o3_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
