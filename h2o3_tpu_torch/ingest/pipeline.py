"""The streaming chunked parse — the port of ``h2o3_tpu/ingest/pipeline.py``.

Reference: the two-phase distributed parse (``water/parser/
ParseDataset.java``: a ParseSetup type guess, then chunks parsed in
parallel). The eager parse (``frame/parse.py``) reads the whole file; this
one runs four stages joined by small bounded queues,

    read (raw byte blocks)
      -> decompress (incremental gzip, record re-assembly, fixed-row batches)
      -> tokenize (CSV -> typed columns -> CompressedChunk)
      -> assemble (one Vec a column, its tensor built lazily on the card)

so the host holds O(chunk) transient bytes beside the compressed payloads
the Frame keeps. Every queue wait polls an abort flag: a stage that dies
wakes its neighbours within one poll period.

The first batch is the type sample. A later batch that breaks a guessed
numeric column raises :class:`ParsePromoted`, and the parse restarts with
that column forced categorical (at most one restart a column). Header names
are made unique by :func:`h2o3_tpu_torch.frame.parse.dedupe_names`, as on
the eager routes, so both give ``NA,x,x`` as ``["NA", "x", "x.1"]``.
"""

from __future__ import annotations

import io
import os
import queue
import threading
import zlib

import numpy as np

from h2o3_tpu_torch.frame.types import CAT_NA, VecType
from h2o3_tpu_torch.utils import telemetry as _tm
from h2o3_tpu_torch.ingest.encode import (CompressedChunk, concat_chunks,
                                          encode_codes, encode_numeric)

#: raw-read block size (bytes) — the unit the read stage hands downstream
_READ_BLOCK = 1 << 20

#: bounded-queue poll period: every wait checks the abort flag this often
_POLL_S = 0.2

_EOF = object()


class ParsePromoted(Exception):
    """A batch past the sample broke the numeric guess of one or more
    columns: parse again with them forced categorical. It carries every
    column the batch broke, so k breaks cost one restart."""

    def __init__(self, columns: list[str]):
        super().__init__(", ".join(columns))
        self.columns = list(columns)


class _Aborted(Exception):
    """A sibling stage failed; unwind quietly (its error is the one)."""


class IngestStats:
    """One streaming parse's accounting (``Frame._ingest_stats``)."""

    def __init__(self):
        self.rows = 0
        self.chunks = 0
        self.bytes_in = 0            # decompressed source bytes consumed
        self.bytes_raw = 0           # the eager float32/int32 columns' bytes
        self.bytes_encoded = 0       # compressed host payload bytes
        self.restarts = 0
        self.inflight_peak = 0       # most bytes queued between stages
        self._inflight = 0
        self._lock = threading.Lock()

    def grow(self, n: int) -> None:
        with self._lock:
            self._inflight += n
            if self._inflight > self.inflight_peak:
                self.inflight_peak = self._inflight

    def shrink(self, n: int) -> None:
        with self._lock:
            self._inflight -= n

    @property
    def compression_ratio(self) -> float:
        return (self.bytes_raw / self.bytes_encoded) if self.bytes_encoded \
            else 1.0

    def as_dict(self) -> dict:
        return {"rows": self.rows, "chunks": self.chunks,
                "bytes_in": self.bytes_in, "bytes_raw": self.bytes_raw,
                "bytes_encoded": self.bytes_encoded,
                "compression_ratio": round(self.compression_ratio, 3),
                "restarts": self.restarts,
                "inflight_peak_bytes": self.inflight_peak}


def chunk_rows_default() -> int:
    return int(os.environ.get("H2O3TPU_INGEST_CHUNK_ROWS", str(1 << 16)))


def queue_depth_default() -> int:
    return int(os.environ.get("H2O3TPU_INGEST_QUEUE", "4"))


# ---------------------------------------------------------------------------
# bounded queues: every wait polls the abort flag


def _q_put(q: "queue.Queue", item, abort: threading.Event) -> None:
    while True:
        if abort.is_set():
            raise _Aborted()
        try:
            q.put(item, timeout=_POLL_S)
            return
        except queue.Full:
            continue


def _q_get(q: "queue.Queue", abort: threading.Event):
    while True:
        if abort.is_set():
            raise _Aborted()
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            continue


def _split_records(data: bytes, in_quote: bool):
    """Split ``data`` at newlines outside double-quoted fields (RFC 4180:
    a quoted field may hold newlines; a ``""`` escape flips the parity
    twice). Vectorised over the block. Returns (records, remainder,
    in_quote), ``in_quote`` being the state at the start of the remainder
    (a cut sits at quote depth 0, so any cut resets it). A block without
    quotes is split by ``bytes.split``, to the same records."""
    if not in_quote and b'"' not in data:
        records = data.split(b"\n")
        return records[:-1], records[-1], False
    arr = np.frombuffer(data, np.uint8)
    parity = (np.cumsum(arr == ord('"')) & 1).astype(bool)
    if in_quote:
        parity = ~parity
    cuts = np.flatnonzero((arr == ord("\n")) & ~parity)
    records = []
    start = 0
    for c in cuts.tolist():
        records.append(data[start:c])
        start = c + 1
    return records, data[start:], in_quote if not len(cuts) else False


class _Stage(threading.Thread):
    """One pipeline stage: runs ``fn``, records its error, trips the shared
    abort flag so every sibling unwinds within one poll period."""

    def __init__(self, name: str, fn, abort: threading.Event):
        super().__init__(name=f"ingest-{name}", daemon=True)
        self._fn = fn
        self._abort = abort
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            self._fn()
        except _Aborted:
            pass
        except BaseException as e:   # noqa: BLE001 — carried to the driver
            self.error = e
            self._abort.set()


# ---------------------------------------------------------------------------
# stage bodies


def _read_stage(path: str, out_q, abort, progress) -> None:
    """Raw byte blocks off disk, never the whole file; ``progress`` gets
    the on-disk offset for the Job's progress."""
    with open(path, "rb") as fh:
        while True:
            block = fh.read(_READ_BLOCK)
            progress["raw_pos"] = fh.tell()
            if not block:
                break
            _q_put(out_q, block, abort)
    _q_put(out_q, _EOF, abort)


def _decompress_stage(in_q, out_q, abort, gzipped: bool, chunk_rows: int,
                      stats: IngestStats, has_header: bool) -> None:
    """Incremental gunzip + line re-assembly + fixed-row-count batching.

    Emits ``("header", line)`` once (when the file has one), then
    ``("lines", [line, ...])`` batches of exactly ``chunk_rows`` rows
    (except the tail). Holds at most one partial line + one open batch —
    O(chunk) regardless of file size."""
    dec = zlib.decompressobj(wbits=47) if gzipped else None   # gzip|zlib hdr
    tail = b""
    in_quote = False

    def gunzip(block: bytes) -> bytes:
        """Incremental gunzip across member boundaries: concatenated
        members (pigz, ``cat a.gz b.gz``) are one stream, but a
        decompressobj stops at its member's end."""
        nonlocal dec
        out = b""
        while block:
            out += dec.decompress(block)
            if not dec.eof:
                break
            block = dec.unused_data
            dec = zlib.decompressobj(wbits=47)
        return out
    batch: list[bytes] = []
    header_sent = not has_header

    def flush_batch():
        nonlocal batch
        if batch:
            nb = sum(map(len, batch))
            stats.grow(nb)
            _q_put(out_q, ("lines", batch, nb), abort)
            batch = []

    while True:
        block = _q_get(in_q, abort)
        if block is _EOF:
            if dec is not None:
                tail += dec.flush()
            break
        if dec is not None:
            block = gunzip(block)
        stats.bytes_in += len(block)
        lines, tail, in_quote = _split_records(tail + block, in_quote)
        # records without a trailing \r, empty ones dropped
        if b"\r" in block:
            lines = [ln[:-1] if ln.endswith(b"\r") else ln for ln in lines]
        lines = list(filter(None, lines))
        if not header_sent and lines:
            header_sent = True
            _q_put(out_q, ("header", lines[0]), abort)
            lines = lines[1:]
        while lines:
            take = chunk_rows - len(batch)
            batch.extend(lines[:take])
            lines = lines[take:]
            if len(batch) >= chunk_rows:
                flush_batch()
    if tail.strip():
        ln = tail[:-1] if tail.endswith(b"\r") else tail
        if not header_sent:
            _q_put(out_q, ("header", ln), abort)
        else:
            batch.append(ln)
    flush_batch()
    _q_put(out_q, _EOF, abort)


class _ColumnState:
    """One column's encoded chunks and, for a categorical, the dictionary
    built across chunks in insertion order."""

    def __init__(self, name: str, forced: "VecType | None"):
        self.name = name
        self.forced = forced
        self.kind: str | None = \
            "cat" if forced is VecType.CAT else \
            "num" if forced in (VecType.NUM, VecType.INT) else None
        self.chunks: list[CompressedChunk] = []
        self.lut: dict[str, int] = {}        # categorical level -> raw code
        # INT or NUM by the eager _guess_type rule (some finite values, all
        # integral), not by the codec (a wide integral span is f32)
        self.integral = True
        self.has_finite = False


def _tokenize_stage(in_q, out_q, abort, sep: str, na_strings, forced: dict,
                    columns: list[_ColumnState], stats: IngestStats) -> None:
    """CSV lines -> typed columns -> CompressedChunks.

    The first batch is the type sample: a column not forced guesses
    numeric or categorical from it. A later batch whose guessed numeric
    column holds a token that is not a number raises
    :class:`ParsePromoted`."""
    import pandas as pd

    from h2o3_tpu_torch.frame.parse import dedupe_names

    def parse_batch(lines: list[bytes], na_filter: bool = True):
        # the eager pd.read_csv's dialect (no skipinitialspace), so both
        # routes give the same names and domains. Tokens are Python str
        # objects (dtype=object): pandas' pyarrow-backed strings (dtype=str)
        # can crash the process when parsed on a stage thread
        buf = io.BytesIO(b"\n".join(lines))
        if not na_filter:   # header parse: a column named "NA" stays "NA"
            return pd.read_csv(buf, header=None, sep=sep, dtype=object,
                               na_filter=False)
        return pd.read_csv(buf, header=None, sep=sep, dtype=object,
                           na_values=na_strings, keep_default_na=True)

    while True:
        item = _q_get(in_q, abort)
        if item is _EOF:
            break
        if item[0] == "header":
            # parse the header line with the SAME csv reader as the data
            # (quoted names containing the separator split correctly) but
            # WITHOUT NA filtering — a column literally named "NA" keeps
            # its name, matching the eager path
            hdr = parse_batch([item[1]], na_filter=False)
            names = [str(v) if v is not None and v == v else ""
                     for v in hdr.iloc[0].tolist()]
            names = dedupe_names([n or f"C{i + 1}"
                                  for i, n in enumerate(names)])
            columns.extend(_ColumnState(n, forced.get(n)) for n in names)
            continue
        _tag, lines, nb = item
        df = parse_batch(lines)
        if not columns:            # headerless file: C1..Cn on first batch
            for i in range(df.shape[1]):
                columns.append(_ColumnState(f"C{i + 1}",
                                            forced.get(f"C{i + 1}")))
        if df.shape[1] != len(columns):
            raise ValueError(
                f"row has {df.shape[1]} fields, header declares "
                f"{len(columns)} (chunk of {len(lines)} rows)")
        enc_bytes = 0
        promote: list[str] = []
        for j, col in enumerate(columns):
            s = df.iloc[:, j]
            # a categorical column's tokens are never read as numbers
            nums = None if col.kind == "cat" else \
                pd.to_numeric(s, errors="coerce")
            if col.kind is None:
                # the sample decides: any token that is non-NA yet
                # non-numeric makes the column categorical
                bad = nums.isna() & s.notna()
                col.kind = "cat" if bool(bad.any()) else "num"
            if col.kind == "num":
                bad = nums.isna() & s.notna()
                if bool(bad.any()) and col.forced is None:
                    # only a GUESSED numeric promotes; a user-forced
                    # numeric column treats bad tokens as NA (h2o-py
                    # col_types semantics), which the coerce already did.
                    # Keep scanning: every column this chunk breaks rides
                    # ONE restart
                    promote.append(col.name)
                    continue
                host = nums.to_numpy(np.float32)
                finite = host[np.isfinite(host)]
                if finite.size:
                    col.has_finite = True
                    if not np.all(finite == np.round(finite)):
                        col.integral = False
                chunk = encode_numeric(host)
            else:
                # vectorized dictionary build: factorize the chunk (C
                # loop), then extend the cross-chunk dictionary only over
                # this chunk's O(cardinality) distinct levels
                local, uniques = pd.factorize(s)
                lut = col.lut
                if len(uniques):
                    mapping = np.array(
                        [lut.setdefault(str(u), len(lut)) for u in uniques],
                        dtype=np.int32)
                    codes = np.where(
                        local >= 0, mapping[np.clip(local, 0, None)],
                        np.int32(CAT_NA)).astype(np.int32)
                else:                      # all-NA chunk
                    codes = np.full(len(s), CAT_NA, dtype=np.int32)
                chunk = encode_codes(codes, len(lut))
            col.chunks.append(chunk)
            enc_bytes += chunk.nbytes
            stats.bytes_raw += chunk.raw_bytes
        if promote:
            raise ParsePromoted(promote)
        stats.bytes_encoded += enc_bytes
        stats.rows += df.shape[0]
        stats.chunks += 1
        stats.shrink(nb)
        _q_put(out_q, ("chunk", df.shape[0]), abort)
    _q_put(out_q, _EOF, abort)


# ---------------------------------------------------------------------------
# driver


def _assemble(columns: list[_ColumnState], lazy: bool, device):
    """One Vec a column from its chunks, on ``device``. Categorical
    dictionaries are sorted (the parser's lexicographic domains) and the
    codes remapped chunk by chunk."""
    from h2o3_tpu_torch.frame.vec import Vec
    vecs = []
    for col in columns:
        if col.kind == "cat":
            domain = sorted(col.lut)
            rank = {lvl: i for i, lvl in enumerate(domain)}
            perm = np.full(max(len(col.lut), 1), CAT_NA, dtype=np.int32)
            for lvl, raw in col.lut.items():
                perm[raw] = rank[lvl]
            remapped = []
            for ch in col.chunks:
                codes = ch.decode()
                ok = codes >= 0
                codes[ok] = perm[codes[ok]]
                remapped.append(encode_codes(codes, len(domain)))
            fused = concat_chunks(remapped, is_categorical=True,
                                  cardinality=len(domain))
            vecs.append(Vec.from_compressed(fused, VecType.CAT,
                                            domain=tuple(domain),
                                            device=device))
        else:
            fused = concat_chunks(col.chunks)
            # the eager _guess_type rule, not the codec: a wide integral
            # span is an f32 payload of an INT column
            vtype = VecType.INT if (col.has_finite and col.integral) \
                else VecType.NUM
            vecs.append(Vec.from_compressed(fused, vtype, device=device))
        col.chunks = []            # the fused chunk owns the payload now
    if not lazy:
        for v in vecs:
            _ = v.data      # build each column's tensor now
    return vecs


def stream_import(path: str, key: str | None = None, header: int | None = 0,
                  col_types: dict | None = None,
                  na_strings: list | None = None, sep: str | None = None,
                  chunk_rows: int | None = None, lazy: bool | None = None,
                  job=None, device=None):
    """Streaming chunked CSV parse into a Frame of compressed host columns
    whose tensors are built on ``device`` (the card by default) at first
    use, or at once with ``lazy=False`` (``H2O3TPU_INGEST_EAGER=1``).

    ``job`` (a :class:`~h2o3_tpu_torch.models.job.Job`) gets row and byte
    progress per chunk; cancelling it stops every stage within one poll
    period and raises :class:`~h2o3_tpu_torch.models.job.JobCancelled`."""
    from h2o3_tpu_torch.device import resolve_device
    from h2o3_tpu_torch.frame.binfmt import is_gzipped
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.utils.registry import DKV

    dev = resolve_device(device)

    sep = sep or ","
    chunk_rows = chunk_rows or chunk_rows_default()
    if lazy is None:
        lazy = os.environ.get("H2O3TPU_INGEST_EAGER", "0") != "1"
    gzipped = is_gzipped(path)       # magic bytes, never the extension
    total_bytes = os.path.getsize(path)
    na = list(na_strings) if na_strings else None
    # h2o-py's col_types names ("enum", "numeric") as VecTypes
    forced: dict[str, VecType] = {}
    for cname, t in (col_types or {}).items():
        if isinstance(t, VecType):
            forced[cname] = t
        elif str(t).lower() in ("enum", "cat", "categorical", "factor",
                                "string"):
            forced[cname] = VecType.CAT
        else:
            forced[cname] = VecType.NUM
    stats = IngestStats()

    # each restart forces at least one more column categorical, so the
    # count is bounded by the width (64 before a header has been seen)
    restarts = 0
    while True:
        abort = threading.Event()
        depth = queue_depth_default()
        raw_q: queue.Queue = queue.Queue(maxsize=depth)
        line_q: queue.Queue = queue.Queue(maxsize=depth)
        done_q: queue.Queue = queue.Queue(maxsize=depth)
        columns: list[_ColumnState] = []
        progress = {"raw_pos": 0}
        stages = [
            _Stage("read", lambda: _read_stage(path, raw_q, abort, progress),
                   abort),
            _Stage("decompress",
                   lambda: _decompress_stage(raw_q, line_q, abort, gzipped,
                                             chunk_rows, stats,
                                             has_header=header is not None
                                             and header >= 0),
                   abort),
            _Stage("tokenize",
                   lambda: _tokenize_stage(line_q, done_q, abort, sep, na,
                                           forced, columns, stats),
                   abort),
        ]
        for s in stages:
            s.start()
        nrows = 0
        try:
            while True:
                item = _q_get(done_q, abort)
                if item is _EOF:
                    break
                nrows += item[1]
                if job is not None:
                    frac = min(progress["raw_pos"] / total_bytes, 1.0) \
                        if total_bytes else 1.0
                    job.update(0.95 * frac,
                               f"parsed {nrows} rows / "
                               f"{stats.bytes_in} bytes")
        except _Aborted:
            pass
        except BaseException:
            abort.set()
            raise
        finally:
            for s in stages:
                s.join(timeout=30.0)
        err = next((s.error for s in stages if s.error is not None), None)
        if isinstance(err, ParsePromoted):
            restarts += 1
            if restarts > max(64, len(columns)):
                raise ValueError(
                    f"parse of {path!r} exceeded {max(64, len(columns))} "
                    "type-promotion restarts")
            for cname in err.columns:
                forced[cname] = VecType.CAT
            stats.restarts += 1
            _tm.INGEST_RESTARTS.inc()
            # rewind the aborted pass's accounting (its queued items died
            # with its stages)
            stats.rows = stats.chunks = 0
            stats.bytes_in = stats.bytes_raw = stats.bytes_encoded = 0
            with stats._lock:
                stats._inflight = 0
            continue
        if err is not None:
            raise err
        break

    # throughput counters land ONCE per successful parse — per-chunk
    # increments would double-count every promote-and-reparse restart
    _tm.INGEST_CHUNKS.inc(stats.chunks)
    _tm.INGEST_ROWS.inc(stats.rows)
    _tm.INGEST_BYTES.inc(stats.bytes_in)
    _tm.INGEST_ENCODED_BYTES.inc(stats.bytes_encoded)
    vecs = _assemble(columns, lazy, dev)
    fr = Frame([c.name for c in columns], vecs, key=key)
    fr._ingest_stats = stats.as_dict()
    if job is not None:
        job.update(1.0, f"parsed {nrows} rows / {stats.bytes_in} bytes")
    if key:
        DKV.put(key, fr)
    return fr
