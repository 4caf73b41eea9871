"""Parsing local delimited text into Frames — the port of
``h2o3_tpu/frame/parse.py`` for ``csv``/``txt``/``data`` files.

:func:`import_file` takes the reference's two routes. With the default
``header``, no ``na_strings`` and a one-character separator, the native
chunk-parallel tokenizer (:mod:`h2o3_tpu_torch.frame.native_csv`, built
from ``native/csv_parser.cpp`` on first use) parses the bytes; otherwise,
or where the tokenizer declines the file (a quoted header), pandas reads
it and :meth:`Frame.from_pandas` guesses the types. Either way the frame
goes into the port's DKV under its key. Where the reference leaves
``col_types`` unapplied, the port applies them: a column typed
``"string"`` stays a host STR column, ``"enum"`` is categorical and
``"numeric"`` reads tokens that are not numbers as missing. Duplicate
header names take pandas' suffixes on both routes (``x``, ``x.1``).

:class:`RawFile` holds uploaded bytes under a DKV key (the zip that
``utils/udf.py`` loads a user's function from, or a file parsed on
demand); :func:`parse_raw` parses CSV text in memory through pandas.

Refused by name, and left for a later slice: URIs and cloud schemes,
Parquet, ORC, ARFF, SVMLight, Avro and XLSX, and the streaming ``ingest/``
path that the reference picks by ``H2O3TPU_INGEST_STREAMING``.
"""

from __future__ import annotations

import io
import os
import time

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame import native_csv
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec, _guess_type
from h2o3_tpu_torch.utils.registry import DKV

#: the extensions this slice parses
TEXT_EXTS = ("csv", "txt", "data")
#: formats the reference parses that this slice refuses, by extension
_REFUSED_EXTS = {"parquet": "Parquet", "pq": "Parquet", "orc": "ORC",
                 "arff": "ARFF", "svmlight": "SVMLight", "svm": "SVMLight",
                 "avro": "Avro", "xlsx": "XLSX", "xls": "XLSX"}
#: h2o-py's col_types names, by the type they ask for
_COL_TYPES = {"string": VecType.STR, "str": VecType.STR,
              "enum": VecType.CAT, "cat": VecType.CAT,
              "categorical": VecType.CAT, "factor": VecType.CAT,
              "numeric": VecType.NUM, "real": VecType.NUM,
              "float": VecType.NUM, "int": VecType.NUM}

#: how many parses took each route (the chip smoke run checks the native
#: route ran)
routes = {"native": 0, "pandas": 0}
#: seconds of the last parse's steps: read, tokenize, upload
last_timing: dict = {}


def _stream_requested(path: str, ext: str) -> bool:
    """Whether the reference's ``_stream_mode`` would send this file to
    the streaming pipeline (``H2O3TPU_INGEST_STREAMING``: 1 for every
    text file, auto for gzip files and files over
    ``H2O3TPU_INGEST_STREAM_MIN_BYTES``)."""
    mode = os.environ.get("H2O3TPU_INGEST_STREAMING", "0").strip().lower()
    if mode in ("", "0", "off", "false") or ext not in TEXT_EXTS + ("gz",):
        return False
    if mode in ("1", "on", "true", "force"):
        return True
    if mode != "auto":
        return False
    with open(path, "rb") as fh:
        if ext == "gz" or fh.read(2) == b"\x1f\x8b":
            return True
    floor = int(os.environ.get("H2O3TPU_INGEST_STREAM_MIN_BYTES",
                               str(64 << 20)))
    return os.path.getsize(path) >= floor


def _check_readable(path: str) -> None:
    if not os.path.exists(path):
        raise FileNotFoundError(f"import_file: no such file or directory: "
                                f"{path!r}")
    if os.path.isdir(path):
        raise IsADirectoryError(f"import_file: {path!r} is a directory, "
                                "not a data file")
    if not os.access(path, os.R_OK):
        raise PermissionError(f"import_file: {path!r} is not readable")


def _col_types(col_types: dict | None) -> dict[str, VecType]:
    out = {}
    for name, t in (col_types or {}).items():
        vt = t if isinstance(t, VecType) else _COL_TYPES.get(str(t).lower())
        if vt not in (VecType.STR, VecType.CAT, VecType.NUM):
            raise ValueError(f"col_types[{name!r}] = {t!r}: string, enum "
                             "or numeric")
        out[str(name)] = vt
    return out


def dedupe_names(names: list[str]) -> list[str]:
    """pandas' C reader's mangling of duplicate header names: the second
    ``x`` becomes ``x.1``, the third ``x.2``, skipping any name the header
    holds."""
    header = list(names)
    counts: dict[str, int] = {}
    for i, col in enumerate(header):
        old, cur = col, counts.get(col, 0)
        while cur > 0:
            counts[old] = cur + 1
            col = f"{old}.{cur}"
            cur = cur + 1 if col in header else counts.get(col, 0)
        header[i] = col
        counts[col] = cur + 1
    return header


def import_file(path: str, key: str | None = None, header: int | None = 0,
                col_types: dict | None = None,
                na_strings: list[str] | None = None, sep: str | None = None,
                device: str | torch.device | None = None) -> Frame:
    """Parse a local delimited text file into a Frame on ``device`` and
    put it into the DKV (reference: ``h2o.import_file`` → ``POST
    /3/Parse``)."""
    dev = resolve_device(device)
    if "://" in path:
        scheme = path.split("://", 1)[0].lower()
        if scheme != "file":
            raise NotImplementedError(
                f"import_file: {scheme!r} URIs are not parsed by the port "
                "yet (persist backends: ROADMAP queue A)")
        path = path.split("://", 1)[1]
    _check_readable(path)
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext in _REFUSED_EXTS:
        raise NotImplementedError(
            f"import_file: {_REFUSED_EXTS[ext]} files are not parsed by the "
            "port yet (binfmt: ROADMAP queue A)")
    if _stream_requested(path, ext):
        raise NotImplementedError(
            "import_file: the streaming ingest path (H2O3TPU_INGEST_"
            "STREAMING) is not ported yet (ingest/: ROADMAP queue A)")
    key = key or _key_from_path(path)
    forced = _col_types(col_types)
    frame = None
    if ext in TEXT_EXTS and na_strings is None and header == 0 \
            and (sep is None or len(sep) == 1):
        frame = _parse_csv_native(path, sep or ",", key, forced, dev)
    if frame is None:
        frame = _parse_pandas(path, key, header, forced, na_strings, sep,
                              dev)
    DKV.put(frame.key, frame)
    return frame


def _parse_csv_native(path: str, sep: str, key: str,
                      forced: dict[str, VecType], dev) -> Frame | None:
    """The native tokenizer's frame; None where it declines the file, or
    where a column forced to string or enum came out numeric (its source
    text is gone: pandas reads it again)."""
    t0 = time.perf_counter()
    with open(path, "rb") as fh:
        data = fh.read()
    t1 = time.perf_counter()
    out = native_csv.parse_csv(data, sep=sep)
    if out is None:
        return None
    names, cols = out
    names = dedupe_names(names)
    for n, col in zip(names, cols):
        if col[0] == "num" and forced.get(n) in (VecType.STR, VecType.CAT):
            return None
    t2 = time.perf_counter()
    vecs: dict[str, Vec] = {}
    nums = []
    for n, col in zip(names, cols):
        want = forced.get(n)
        if col[0] == "cat" and want is VecType.NUM:
            # levels that read as numbers, the rest missing
            lut = np.array([_to_float(s) for s in col[2]] + [np.nan])
            vals = lut[np.where(col[1] >= 0, col[1], len(col[2]))]
            nums.append((n, vals.astype(np.float32), VecType.NUM))
        elif col[0] == "cat" and want is VecType.STR:
            labels = np.full(len(col[1]), None, dtype=object)
            ok = col[1] >= 0
            labels[ok] = np.array(col[2], dtype=object)[col[1][ok]]
            vecs[n] = Vec(None, VecType.STR, host_values=labels)
        elif col[0] == "cat":
            vecs[n] = Vec(torch.as_tensor(col[1]).to(dev), VecType.CAT,
                          domain=tuple(col[2]))
        else:
            v32 = col[1].astype(np.float32)
            nums.append((n, v32, want or _guess_type(v32)))
    if nums:
        mat = torch.as_tensor(np.stack([v for _, v, _ in nums])).to(dev)
        for i, (n, _, t) in enumerate(nums):
            vecs[n] = Vec(mat[i], t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    last_timing.update(read=t1 - t0, tokenize=t2 - t1,
                       upload=time.perf_counter() - t2)
    routes["native"] += 1
    return Frame(names, [vecs[n] for n in names], key=key)


def _to_float(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        return float("nan")


def _parse_pandas(path: str, key: str, header, forced: dict[str, VecType],
                  na_strings, sep, dev) -> Frame:
    """pandas' C reader, then :meth:`Frame.from_pandas`, with the forced
    column types applied."""
    import pandas as pd
    kw = dict(header=header, na_values=na_strings, compression="infer")
    if sep is not None:
        kw["sep"] = sep
    text_cols = [n for n, t in forced.items() if t is not VecType.NUM]
    if text_cols:
        kw["dtype"] = {n: str for n in text_cols}
    df = pd.read_csv(path, engine="c", **kw)
    routes["pandas"] += 1
    return _typed(df, forced, key, dev)


def _typed(df, forced: dict[str, VecType], key: str | None, dev) -> Frame:
    import pandas as pd
    for n, t in forced.items():
        if n in df.columns and t is VecType.NUM:
            df[n] = pd.to_numeric(df[n], errors="coerce")
    fr = Frame.from_pandas(df, key=key, device=dev)
    vecs = []
    for n, v in zip(fr.names, fr.vecs):
        if forced.get(n) is VecType.STR and v.is_categorical:
            v = Vec(None, VecType.STR, host_values=v.labels())
        vecs.append(v)
    return Frame(fr.names, vecs, key=key)


def upload_file(path: str, key: str | None = None, **kw) -> Frame:
    """Alias of :func:`import_file`: one process owns the parse."""
    return import_file(path, key=key, **kw)


class RawFile:
    """Unparsed uploaded bytes (reference: ``water/fvec/UploadFileVec``, the
    raw key ``POST /3/PostFile`` and ``/3/PutKey`` create). The UDF loader
    reads ``data``; :meth:`frame` parses the bytes once, under a transient
    key that leaves the DKV with the parse."""

    nrows = 0
    ncols = 0

    def __init__(self, data: bytes, name: str = "upload"):
        self.data = data
        self.name = name
        self._frame: Frame | None = None

    def frame(self, device: str | torch.device | None = None) -> Frame:
        if self._frame is None:
            import tempfile
            import uuid
            suffix = os.path.splitext(self.name)[1] or ".csv"
            fd, tmp = tempfile.mkstemp(suffix=suffix)
            tkey = f"_upload_{uuid.uuid4().hex[:12]}"
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(self.data)
                self._frame = import_file(tmp, key=tkey, device=device)
            finally:
                os.unlink(tmp)
            if tkey in DKV:
                DKV.remove(tkey)
        return self._frame


def parse_raw(text: str, key: str | None = None,
              device: str | torch.device | None = None, **kw) -> Frame:
    """Parse CSV text in memory with pandas (``kw`` go to
    ``pandas.read_csv``); a keyed frame goes into the DKV."""
    import pandas as pd
    df = pd.read_csv(io.StringIO(text), **kw)
    frame = Frame.from_pandas(df, key=key, device=resolve_device(device))
    if key:
        DKV.put(key, frame)
    return frame


def _key_from_path(path: str) -> str:
    return os.path.basename(path).replace(".", "_") + ".hex"
