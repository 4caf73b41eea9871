"""The native CSV tokenizer, ``native/csv_parser.cpp``, built and loaded by
the port — the port's counterpart of ``h2o3_tpu/native/__init__.py``.

The C++ source is read in place from the repository's ``native/`` folder
and compiled with ``g++`` on first use (never at import) into
``h2o3_tpu_torch/build/`` (listed in ``.gitignore``), under a name that
carries a hash of the source and flags, so an edited source rebuilds. It
splits the buffer at newlines into one chunk per thread, tokenizes the
chunks in parallel and merges their types and categorical domains
(reference ``ParseDataset``'s ``MultiFileParseTask`` and
``PackedDomains``); a file with quotes is parsed on one thread. The
library has a plain C interface, bound with ctypes.
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

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "csv_parser.cpp"
BUILD_DIR = _PKG / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: the last build or load: library path and seconds spent compiling (0.0
#: when the cached library was loaded)
build_info: dict = {}

_P = ctypes.c_void_p
_SIGNATURES = {
    "h2o3_parse_csv": (_P, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_char, ctypes.c_int]),
    "h2o3_nrows": (ctypes.c_int64, [_P]),
    "h2o3_ncols": (ctypes.c_int32, [_P]),
    "h2o3_col_name": (ctypes.c_char_p, [_P, ctypes.c_int]),
    "h2o3_col_type": (ctypes.c_int32, [_P, ctypes.c_int]),
    "h2o3_col_data": (ctypes.POINTER(ctypes.c_double), [_P, ctypes.c_int]),
    "h2o3_col_card": (ctypes.c_int32, [_P, ctypes.c_int]),
    "h2o3_col_level": (ctypes.c_char_p, [_P, ctypes.c_int, ctypes.c_int]),
    "h2o3_free": (None, [_P]),
}


def _build() -> Path:
    """The library's path, compiling it first if no build of this source
    and these flags exists; raises when ``g++`` is missing or fails."""
    if not SOURCE.is_file():
        raise RuntimeError(f"the native CSV parser's source {SOURCE} is "
                           "missing")
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"libh2o3_csv_{h.hexdigest()[:16]}.so"
    if so.is_file():
        build_info.update(path=str(so), seconds=0.0)
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native CSV parser is "
                           "compiled on first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name first, then an atomic rename: concurrent first uses
    # (test workers) never load a half-written library
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0)
    return so


def library() -> ctypes.CDLL:
    """The native library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
        return _lib


def parse_csv(data: bytes, sep: str = ","):
    """Tokenize CSV bytes with a header line, on up to 16 threads:
    ``(names, columns)``, each column ``("num", float64 values)`` or
    ``("cat", int32 codes, sorted domain)``; None where the parser declines
    the input (no bytes, a quoted header)."""
    lib = library()
    h = lib.h2o3_parse_csv(data, len(data), 1, sep.encode(),
                           min(os.cpu_count() or 4, 16))
    if not h:
        return None
    try:
        nrows, ncols = lib.h2o3_nrows(h), lib.h2o3_ncols(h)
        names, cols = [], []
        for c in range(ncols):
            names.append(lib.h2o3_col_name(h, c).decode())
            arr = np.ctypeslib.as_array(lib.h2o3_col_data(h, c),
                                        shape=(nrows,)).copy() \
                if nrows else np.zeros(0)
            if lib.h2o3_col_type(h, c) == 0:
                cols.append(("num", arr))
            else:
                dom = tuple(lib.h2o3_col_level(h, c, i).decode()
                            for i in range(lib.h2o3_col_card(h, c)))
                cols.append(("cat", arr.astype(np.int32), dom))
        return names, cols
    finally:
        lib.h2o3_free(h)
