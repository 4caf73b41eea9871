"""File import into Frames — the port of ``h2o3_tpu/frame/parse.py``.

:func:`import_file` routes a path or URI as the reference does:

- ``s3://``, ``gs://`` and ``hdfs://`` URIs are fetched to a temporary file
  through :data:`h2o3_tpu_torch.persist.cloud.MANAGER` and parsed as local
  files; ``file://`` is a local path; ``http(s)://`` passes the scheme
  check and then fails the readability check with ``FileNotFoundError``,
  as in the JAX package (neither fetches over HTTP).
- Delimited text goes to the streaming chunked parse
  (:mod:`h2o3_tpu_torch.ingest.pipeline`, inside a Job) when
  ``H2O3TPU_INGEST_STREAMING`` asks for it (``auto``: gzip files and files
  over ``H2O3TPU_INGEST_STREAM_MIN_BYTES``); otherwise, with the default
  ``header``, no ``na_strings`` and a one-character separator, the native
  chunk-parallel tokenizer (:mod:`h2o3_tpu_torch.frame.native_csv`, built
  from ``native/csv_parser.cpp`` on first use) parses the bytes, and pandas
  elsewhere. Where the reference's eager path leaves ``col_types``
  unapplied, the port applies them: ``"string"`` keeps a host STR column,
  ``"enum"`` is categorical and ``"numeric"`` reads tokens that are not
  numbers as missing. Duplicate header names take pandas' suffixes on
  every route (``x``, ``x.1``).
- Parquet and ORC are read with ``pyarrow`` (imported at the call) and
  typed as the reference's ``pd.read_parquet`` → ``Frame.from_pandas``
  types them; ARFF keeps its declared nominal domains; SVMLight files of
  up to ``_SVMLIGHT_DENSE_MAX_COLS`` columns are dense (``C0`` the label),
  wider ones a :class:`~h2o3_tpu_torch.frame.sparse.SparseFrame`; Avro and
  XLSX go through :mod:`h2o3_tpu_torch.frame.binfmt`.

Every frame goes into the port's DKV under its key. :class:`RawFile` holds
uploaded bytes under a DKV key (the zip ``utils/udf.py`` loads a user's
function from, or a file parsed on demand); :func:`parse_raw` parses CSV
text in memory through pandas.
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
from h2o3_tpu_torch.persist.frame_io import CLOUD_SCHEMES
from h2o3_tpu_torch.utils.registry import DKV

#: the extensions the native tokenizer parses
TEXT_EXTS = ("csv", "txt", "data")
#: extensions the streaming pipeline parses (delimited text, and gzip)
_STREAMABLE_EXTS = TEXT_EXTS + ("gz",)
#: widths beyond this stay a SparseFrame (reference: CXI chunks stay
#: sparse)
_SVMLIGHT_DENSE_MAX_COLS = 1000
#: h2o-py's col_types names, by the type they ask for
_COL_TYPES = {"string": VecType.STR, "str": VecType.STR,
              "enum": VecType.CAT, "cat": VecType.CAT,
              "categorical": VecType.CAT, "factor": VecType.CAT,
              "numeric": VecType.NUM, "real": VecType.NUM,
              "float": VecType.NUM, "int": VecType.NUM}

#: how many parses took each route (the chip smoke run checks the native
#: route ran)
routes = {"native": 0, "pandas": 0, "streaming": 0}
#: seconds of the last parse's steps: read, tokenize, upload
last_timing: dict = {}


def _stream_mode(path: str, ext: str) -> bool:
    """Whether this import takes the streaming pipeline, by
    ``H2O3TPU_INGEST_STREAMING``: ``0`` or unset never, ``1`` every
    streamable file, ``auto`` gzip files (by their magic bytes) and files
    of at least ``H2O3TPU_INGEST_STREAM_MIN_BYTES`` (64 MiB)."""
    mode = os.environ.get("H2O3TPU_INGEST_STREAMING", "0").strip().lower()
    if mode in ("", "0", "off", "false") or ext not in _STREAMABLE_EXTS:
        return False
    if mode in ("1", "on", "true", "force"):
        return True
    if mode != "auto":
        return False
    from h2o3_tpu_torch.frame.binfmt import is_gzipped
    if ext == "gz" or is_gzipped(path):
        return True
    floor = int(os.environ.get("H2O3TPU_INGEST_STREAM_MIN_BYTES",
                               str(64 << 20)))
    try:
        return os.path.getsize(path) >= floor
    except OSError:
        return False


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
                device: str | torch.device | None = None):
    """Parse a file or a cloud URI into a Frame on ``device`` and put it
    into the DKV (reference: ``h2o.import_file`` → ``POST /3/Parse``)."""
    dev = resolve_device(device)
    if "://" in path:
        scheme = path.split("://", 1)[0].lower()
        if scheme in CLOUD_SCHEMES:
            from h2o3_tpu_torch.persist.cloud import MANAGER
            tmp = MANAGER.fetch_to_temp(path)
            try:
                return import_file(tmp, key=key or _key_from_path(path),
                                   header=header, col_types=col_types,
                                   na_strings=na_strings, sep=sep,
                                   device=dev)
            finally:
                os.unlink(tmp)
        if scheme not in ("http", "https", "file"):
            raise ValueError(f"unknown URI scheme {scheme!r}")
        if scheme == "file":
            path = path.split("://", 1)[1]
    _check_readable(path)
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    key = key or _key_from_path(path)
    if _stream_mode(path, ext):
        return _stream(path, key, header, col_types, na_strings, sep, dev)
    if ext in ("parquet", "pq", "orc"):
        frame = _parse_arrow(path, ext, key, dev)
    elif ext in ("svmlight", "svm"):
        frame = _parse_svmlight(path, key, dev)
    elif ext == "arff":
        frame = _parse_arff(path, key, dev)
    elif ext == "avro":
        from h2o3_tpu_torch.frame.binfmt import parse_avro
        return parse_avro(path, key, device=dev)
    elif ext in ("xlsx", "xls"):
        from h2o3_tpu_torch.frame.binfmt import parse_xlsx
        return parse_xlsx(path, key, device=dev)
    else:
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


def _stream(path: str, key: str, header, col_types, na_strings, sep, dev):
    """The streaming parse inside a Job; a cancelled parse raises."""
    from h2o3_tpu_torch.ingest.pipeline import stream_import
    from h2o3_tpu_torch.models.job import Job
    job = Job(f"Parse {os.path.basename(path)}")
    job.run(lambda j: stream_import(path, key=key, header=header,
                                    col_types=col_types,
                                    na_strings=na_strings, sep=sep, job=j,
                                    device=dev))
    if job.exception is not None:
        raise job.exception
    if job.result is None:
        raise ValueError(f"parse of {path!r} was cancelled (job {job.key})")
    routes["streaming"] += 1
    return job.result


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


def _parse_arrow(path: str, ext: str, key: str, dev) -> Frame:
    """Parquet or ORC through pyarrow, typed as the reference's
    ``pd.read_parquet`` (or ``pyarrow.orc`` → ``to_pandas``) →
    ``Frame.from_pandas`` types them: dictionary and string columns
    categorical with sorted domains, integers with nulls as float32 with
    NaN, booleans INT 0/1 (with nulls categorical ``False``/``True``, as
    pandas' object column), timestamps TIME, other numbers float32."""
    if ext == "orc":
        import pyarrow.orc as orc
        table = orc.ORCFile(path).read()
    else:
        import pyarrow.parquet as pq
        table = pq.read_table(path)
    cols: dict[str, np.ndarray] = {}
    types: dict[str, VecType] = {}
    times: dict[str, np.ndarray] = {}
    names = [str(n) for n in table.column_names]
    for name, col in zip(names, table.columns):
        typ = col.type
        if hasattr(typ, "value_type"):         # dictionary-encoded
            col = col.cast(typ.value_type)
            typ = col.type
        vals = col.to_numpy(zero_copy_only=False)
        kind = vals.dtype.kind
        if kind == "M":
            times[name] = vals
        elif kind == "b":
            cols[name] = vals.astype(np.float32)
            types[name] = VecType.INT
        elif kind in "OUS":
            cols[name] = np.asarray(vals, dtype=object)
        else:
            cols[name] = vals.astype(np.float32)
    fr = Frame.from_arrays(cols, types=types, device=dev)
    vecs = [Vec.from_numpy(times[n], type=VecType.TIME, device=dev)
            if n in times else fr.vec(n) for n in names]
    return Frame(names, vecs, key=key)


def _parse_arff(path: str, key: str, dev) -> Frame:
    """ARFF (reference: ``water/parser/ARFFParser.java``): ``@attribute``
    lines declare each column's name and type (numeric, a nominal
    ``{a,b,...}`` or string); the ``@data`` rows are CSV read by pandas as
    the reference reads them (``?`` missing). A declared nominal domain is
    kept whole, levels no row uses included."""
    import pandas as pd
    names: list[str] = []
    kinds: list[tuple[str, tuple[str, ...] | None]] = []
    data_lines: list[str] = []
    in_data = False
    with open(path) as f:
        for line in f:
            st = line.strip()
            if not st or st.startswith("%"):
                continue
            low = st.lower()
            if in_data:
                data_lines.append(st)
            elif low.startswith("@attribute"):
                rest = st.split(None, 2)[1:]
                names.append(rest[0].strip("'\""))
                typ = rest[1] if len(rest) > 1 else "numeric"
                if typ.startswith("{"):
                    kinds.append(("nominal", tuple(
                        v.strip().strip("'\"")
                        for v in typ.strip("{}").split(","))))
                elif typ.lower() in ("numeric", "real", "integer"):
                    kinds.append(("numeric", None))
                else:
                    kinds.append(("string", None))
            elif low.startswith("@data"):
                in_data = True
    df = pd.read_csv(io.StringIO("\n".join(data_lines)), header=None,
                     names=names, na_values=["?"], skipinitialspace=True)
    vecs = []
    for name, (kind, dom) in zip(names, kinds):
        col = df[name]
        if kind == "nominal":
            lut = {lvl: i for i, lvl in enumerate(dom)}
            codes = np.array([lut.get(str(v).strip("'\""), -1)
                              if not pd.isna(v) else -1
                              for v in col.astype("object")], np.int32)
            vecs.append(Vec.from_numpy(codes, VecType.CAT, domain=dom,
                                       device=dev))
        elif kind == "numeric":
            vecs.append(Vec.from_numpy(col.to_numpy(np.float32), device=dev))
        else:
            vecs.append(Vec.from_numpy(col.astype(str).to_numpy(),
                                       VecType.STR, device=dev))
    return Frame(names, vecs, key=key)


def _parse_svmlight(path: str, key: str, dev):
    """SVMLight (reference: ``water/parser/SVMLightParser.java``): a file
    of up to ``_SVMLIGHT_DENSE_MAX_COLS`` feature columns is dense, the
    label ``C0`` and the features ``C1``, ``C2``, ...; a wider one stays a
    :class:`~h2o3_tpu_torch.frame.sparse.SparseFrame`."""
    from h2o3_tpu_torch.frame.sparse import (parse_svmlight_sparse,
                                             read_svmlight)
    labels, rows, cols, vals, ncols = read_svmlight(path)
    if ncols > _SVMLIGHT_DENSE_MAX_COLS:
        return parse_svmlight_sparse(path, key=key, device=dev)
    X = np.zeros((len(labels), ncols), np.float64)
    np.add.at(X, (rows, cols), vals)
    X = X.astype(np.float32)
    arrays = {"C0": labels.astype(np.float32)}
    for j in range(ncols):
        arrays[f"C{j + 1}"] = X[:, j]
    return Frame.from_arrays(arrays, key=key, device=dev)


def import_svmlight(path: str, key: str | None = None, sparse: bool = True,
                    device: str | torch.device | None = None):
    """SVMLight explicitly: ``sparse=True`` always gives a SparseFrame."""
    from h2o3_tpu_torch.frame.sparse import parse_svmlight_sparse
    key = key or _key_from_path(path)
    dev = resolve_device(device)
    fr = (parse_svmlight_sparse(path, key=key, device=dev) if sparse
          else _parse_svmlight(path, key, dev))
    DKV.put(key, fr)
    return fr


def _key_from_path(path: str) -> str:
    return os.path.basename(path).replace(".", "_") + ".hex"
