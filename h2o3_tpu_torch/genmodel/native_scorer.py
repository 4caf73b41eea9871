"""The standalone C++ MOJO scorer, ``native/mojo_scorer.cpp``, built and run
by the port.

The scorer reads a MOJO (``model.ini``, ``structure.json``,
``arrays.npz``: either package's) and scores a CSV with only libc and zlib,
printing one prediction line per row: the proof that the artifact needs
neither Python nor the package that wrote it. It scores GBM and DRF
(regression, bernoulli, multinomial, categorical group splits, NA
routing).

The source is read in place from the repository's ``native/`` folder and
compiled with ``g++ -O2 -std=c++17 ... -lz`` on first use (never at
import) into ``h2o3_tpu_torch/build/`` (listed in ``.gitignore``), under a
name that carries a hash of the source and flags, so an edited source
rebuilds. It runs as a subprocess::

    from h2o3_tpu_torch.genmodel.native_scorer import score_csv
    rows = score_csv("model.mojo", "data.csv")   # list of string fields
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "mojo_scorer.cpp"
BUILD_DIR = _PKG / "build"
GXX_FLAGS = ("-O2", "-std=c++17")
LIBS = ("-lz",)

_lock = threading.Lock()
_exe: Path | None = None
#: the binary's path and the seconds this process spent compiling it (0.0
#: when a build of this source was found)
build_info: dict = {}


def executable() -> Path:
    """The scorer's path, compiling it first if no build of this source and
    these flags exists; raises when ``g++`` is missing or fails (zlib's
    header or library missing among its causes)."""
    global _exe
    with _lock:
        if _exe is not None:
            return _exe
        if not SOURCE.is_file():
            raise RuntimeError(f"the MOJO scorer's source {SOURCE} is "
                               "missing")
        h = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
        h.update(SOURCE.read_bytes())
        exe = BUILD_DIR / f"mojo_score_{h.hexdigest()[:16]}"
        if exe.is_file():
            build_info.update(path=str(exe), seconds=0.0)
            _exe = exe
            return exe
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the MOJO scorer is compiled "
                               "on first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a private name first, then an atomic rename: concurrent first
        # uses (test workers) never run a half-written binary
        tmp = exe.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), *LIBS,
                               "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, exe)
        build_info.update(path=str(exe), seconds=time.perf_counter() - t0)
        _exe = exe
        return exe


def score_csv(mojo_path: str, csv_path: str,
              timeout: float | None = None) -> list[list[str]]:
    """Score the CSV (a header line naming the model's columns, raw level
    strings for categoricals, empty cells NA) through the MOJO: per row
    its fields as the scorer prints them (a regression's prediction; a
    classifier's label and class probabilities)."""
    proc = subprocess.run([str(executable()), mojo_path, csv_path],
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the MOJO scorer failed on {mojo_path}:\n"
                           f"{proc.stderr}")
    return [line.split(",") for line in proc.stdout.strip().splitlines()]
