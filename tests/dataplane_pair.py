"""Helpers the data-plane tests of the port share (imported as a top-level
module: pytest puts ``tests/`` on the path): frames of either package
compared column by column, two port GBMs compared tree by tree, and small
writers of Avro and XLSX files."""

import json
import struct
import zipfile
import zlib

import numpy as np
import torch


def host(v):
    """A column's host values: labels of a categorical, else numbers."""
    if v.is_categorical:
        return list(v.labels()[:v.nrows])
    return np.asarray(v.to_numpy())[:v.nrows]


def same_frame(a, b):
    """Two frames (either package) alike: names, types, domains, values,
    float32 bits and NA positions."""
    assert list(a.names) == list(b.names)
    assert a.nrows == b.nrows
    for n in a.names:
        va, vb = a.vec(n), b.vec(n)
        assert str(va.type) == str(vb.type), n
        if va.is_categorical:
            assert tuple(va.domain) == tuple(vb.domain), n
            assert host(va) == host(vb), n
        else:
            x = np.asarray(host(va), np.float32)
            y = np.asarray(host(vb), np.float32)
            np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
            ok = ~np.isnan(x)
            np.testing.assert_array_equal(x[ok].view(np.int32),
                                          y[ok].view(np.int32))


def heaps_equal(a, b) -> bool:
    """Every tree's heap fields and left masks equal bit for bit."""
    from h2o3_tpu_torch.models.tree import HEAP_FIELDS
    ta, tb = a.output["trees"], b.output["trees"]
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        for f in HEAP_FIELDS + ("left_mask",):
            u, v = getattr(x, f), getattr(y, f)
            if (u is None) != (v is None) or (
                    u is not None and not torch.equal(u, v)):
                return False
    return True


def zigzag(n: int) -> bytes:
    """Avro's zigzag varint of n."""
    n = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _avro_bytes(b: bytes) -> bytes:
    return zigzag(len(b)) + b


def write_avro(path, schema: dict, rows: list[dict], codec=b"null",
               block_rows: int = 1000):
    """An Avro object-container file of ``rows``, in blocks."""
    def encode_val(t, v):
        if isinstance(t, list):
            if v is None:
                return zigzag(t.index("null"))
            other = [x for x in t if x != "null"][0]
            return zigzag(t.index(other)) + encode_val(other, v)
        if t == "double":
            return struct.pack("<d", v)
        if t == "float":
            return struct.pack("<f", v)
        if t in ("long", "int"):
            return zigzag(int(v))
        if t == "string":
            return _avro_bytes(v.encode())
        if t == "boolean":
            return b"\x01" if v else b"\x00"
        raise ValueError(t)

    sync = b"S" * 16
    meta = {"avro.schema": json.dumps(schema).encode(), "avro.codec": codec}
    with open(path, "wb") as f:
        f.write(b"Obj\x01")
        f.write(zigzag(len(meta)))
        for k, v in meta.items():
            f.write(_avro_bytes(k.encode()) + _avro_bytes(v))
        f.write(zigzag(0))
        f.write(sync)
        for s in range(0, len(rows), block_rows):
            part = rows[s:s + block_rows]
            body = b"".join(b"".join(encode_val(fd["type"], row[fd["name"]])
                                     for fd in schema["fields"])
                            for row in part)
            if codec == b"deflate":
                comp = zlib.compressobj(9, zlib.DEFLATED, -15)
                body = comp.compress(body) + comp.flush()
            f.write(zigzag(len(part)) + zigzag(len(body)) + body + sync)


def write_xlsx(path, header, rows):
    """A one-sheet .xlsx: strings shared, numbers inline, None empty."""
    shared, idx = [], {}

    def cell(ref, v):
        if v is None:
            return ""
        if isinstance(v, str):
            if v not in idx:
                idx[v] = len(shared)
                shared.append(v)
            return f'<c r="{ref}" t="s"><v>{idx[v]}</v></c>'
        return f'<c r="{ref}"><v>{v!r}</v></c>'

    def col(j):
        s = ""
        j += 1
        while j:
            j, r = divmod(j - 1, 26)
            s = chr(65 + r) + s
        return s

    body = []
    for i, row in enumerate([header] + rows):
        cells = "".join(cell(f"{col(j)}{i + 1}", v) for j, v in enumerate(row))
        body.append(f'<row r="{i + 1}">{cells}</row>')
    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    sheet = (f'<worksheet {ns}><sheetData>{"".join(body)}</sheetData>'
             '</worksheet>')
    sst = f'<sst {ns}>' + "".join(f"<si><t>{s}</t></si>" for s in shared) \
        + "</sst>"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("xl/worksheets/sheet1.xml", sheet)
        z.writestr("xl/sharedStrings.xml", sst)
