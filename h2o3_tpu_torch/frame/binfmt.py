"""Avro and Excel ingestion — the port of ``h2o3_tpu/frame/binfmt.py``.

Reference: ``h2o-parsers/h2o-avro-parser/`` (``AvroParser.java``) and
``water/parser/XlsParser.java``. Both readers need only the standard
library and numpy:

- Avro: the object-container reader (JSON schema, zigzag varints, the
  ``null`` and ``deflate`` codecs, records of primitives with ``["null",
  T]`` unions); other codecs and complex nests raise by name.
- Excel: ``.xlsx`` (a zip of XML) through ``zipfile`` and
  ``xml.etree``: shared and inline strings, numbers, the header row.
  Legacy BIFF ``.xls`` is refused with guidance, as in the reference.

:func:`is_gzipped` sniffs the gzip magic bytes for the import router and
the streaming pipeline.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

#: RFC 1952 gzip member header magic
_GZIP_MAGIC = b"\x1f\x8b"


def is_gzipped(path: str) -> bool:
    """Whether the file starts with the gzip magic bytes (reference: the
    parser's ``ZipUtil`` reads bytes, never the extension)."""
    try:
        with open(path, "rb") as fh:
            return fh.read(2) == _GZIP_MAGIC
    except OSError:
        return False


# ---------------------------------------------------------------------------
# Avro object container

_MAGIC = b"Obj\x01"


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def long(self) -> int:
        shift, acc = 0, 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)       # zigzag

    def bytes_(self) -> bytes:
        return self.read(self.long())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def value(self, schema):
        if isinstance(schema, str):
            t = schema
        elif isinstance(schema, dict):
            t = schema["type"]
        else:                                 # union
            idx = self.long()
            return self.value(schema[idx])
        if t == "null":
            return None
        if t == "boolean":
            return self.read(1) == b"\x01"
        if t in ("int", "long"):
            return self.long()
        if t == "float":
            return struct.unpack("<f", self.read(4))[0]
        if t == "double":
            return struct.unpack("<d", self.read(8))[0]
        if t == "string":
            return self.string()
        if t == "bytes":
            return self.bytes_()
        if t == "enum":
            return schema["symbols"][self.long()]
        if t == "record":
            return {f["name"]: self.value(f["type"])
                    for f in schema["fields"]}
        raise ValueError(f"unsupported Avro type {t!r} (tabular subset only)")


def read_avro(path: str) -> tuple[list[str], list[dict]]:
    """(column names, row dicts) from an Avro object-container file."""
    with open(path, "rb") as f:
        buf = f.read()
    r = _Reader(buf)
    if r.read(4) != _MAGIC:
        raise ValueError(f"{path!r} is not an Avro object-container file")
    meta = {}
    while True:
        n = r.long()
        if n == 0:
            break
        if n < 0:       # block with byte size
            r.long()
            n = -n
        for _ in range(n):
            k = r.string()
            meta[k] = r.bytes_()
    r.read(16)          # sync marker
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    if schema.get("type") != "record":
        raise ValueError("Avro ingestion expects a record schema")
    names = [f["name"] for f in schema["fields"]]

    rows: list[dict] = []
    while r.pos < len(r.buf):
        count = r.long()
        size = r.long()
        block = r.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise ValueError(f"unsupported Avro codec {codec!r}")
        br = _Reader(block)
        for _ in range(count):
            rows.append(br.value(schema))
        r.read(16)      # sync
    return names, rows


def parse_avro(path: str, key: str | None = None, device=None):
    """An Avro file as a Frame: all-number columns float32, others
    categorical, put into the DKV under ``key``."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.utils.registry import DKV
    names, rows = read_avro(path)
    cols: dict[str, np.ndarray] = {}
    for n in names:
        vals = [row.get(n) for row in rows]
        if all(v is None or isinstance(v, (int, float, bool)) for v in vals):
            cols[n] = np.array([np.nan if v is None else float(v)
                                for v in vals], np.float32)
        else:
            cols[n] = np.array([None if v is None else str(v) for v in vals],
                               dtype=object)
    fr = Frame.from_arrays(cols, key=key, device=device)
    if fr.key:
        DKV.put(fr.key, fr)
    return fr


# ---------------------------------------------------------------------------
# Excel (.xlsx)

def _col_to_idx(ref: str) -> int:
    """'BC12' → zero-based column index of 'BC'."""
    idx = 0
    for ch in ref:
        if ch.isalpha():
            idx = idx * 26 + (ord(ch.upper()) - 64)
        else:
            break
    return idx - 1


def read_xlsx(path: str, sheet: int = 0) -> list[list]:
    """Cell grid of one worksheet (numbers as float, text as str)."""
    import xml.etree.ElementTree as ET
    import zipfile

    ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    with zipfile.ZipFile(path) as z:
        sheets = sorted(n for n in z.namelist()
                        if n.startswith("xl/worksheets/sheet"))
        if not sheets:
            raise ValueError(f"{path!r} has no worksheets")
        shared: list[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.iter(f"{ns}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{ns}t")))
        root = ET.fromstring(z.read(sheets[sheet]))
        grid: list[list] = []
        for row in root.iter(f"{ns}row"):
            cells: dict[int, object] = {}
            for c in row.iter(f"{ns}c"):
                ref = c.get("r", "A1")
                j = _col_to_idx(ref)
                ctype = c.get("t", "n")
                vel = c.find(f"{ns}v")
                if ctype == "inlineStr":
                    cells[j] = "".join(t.text or ""
                                       for t in c.iter(f"{ns}t"))
                elif vel is None:
                    continue
                elif ctype == "s":
                    cells[j] = shared[int(vel.text)]
                elif ctype == "b":
                    cells[j] = float(vel.text)
                elif ctype == "str":
                    cells[j] = vel.text
                else:
                    try:
                        cells[j] = float(vel.text)
                    except (TypeError, ValueError):
                        cells[j] = vel.text
            width = max(cells) + 1 if cells else 0
            grid.append([cells.get(j) for j in range(width)])
    width = max((len(r) for r in grid), default=0)
    return [r + [None] * (width - len(r)) for r in grid]


def parse_xlsx(path: str, key: str | None = None, device=None):
    """The first worksheet of an ``.xlsx`` file as a Frame (its first row
    the header), put into the DKV under ``key``."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.utils.registry import DKV
    if path.lower().endswith(".xls"):
        raise ValueError(
            "legacy BIFF .xls is not supported — save as .xlsx (OOXML); "
            "the reference's XlsParser covers the pre-2007 format only")
    grid = read_xlsx(path)
    if not grid:
        raise ValueError(f"{path!r} is empty")
    header = [str(h) if h is not None else f"C{j + 1}"
              for j, h in enumerate(grid[0])]
    body = grid[1:]
    cols: dict[str, np.ndarray] = {}
    for j, name in enumerate(header):
        vals = [row[j] if j < len(row) else None for row in body]
        if all(v is None or isinstance(v, float) for v in vals):
            cols[name] = np.array([np.nan if v is None else v for v in vals],
                                  np.float32)
        else:
            cols[name] = np.array([None if v is None else str(v)
                                   for v in vals], dtype=object)
    fr = Frame.from_arrays(cols, key=key, device=device)
    if fr.key:
        DKV.put(fr.key, fr)
    return fr
