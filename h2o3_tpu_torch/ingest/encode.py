"""Compressed column encodings — the port of ``h2o3_tpu/ingest/encode.py``.

A :class:`CompressedChunk` is one column's host payload in its cheapest
lossless encoding (reference ``water/fvec/NewChunk.java``'s codec choice):

- ``i8``/``i16``: integral numeric columns shifted by a bias into the
  narrow width; the width's minimum is the NA sentinel;
- ``dict8``/``dict16``/``dict32``: categorical codes narrowed to the
  cheapest width that holds the cardinality (-1 = NA fits every width);
- ``f32``: the identity, when nothing narrower is lossless.

:meth:`CompressedChunk.decode` gives on the host exactly the float32 (or
int32 code) array the eager parse holds; :meth:`CompressedChunk.to_tensor`
gives the same tensor on a device by uploading the narrow payload and
widening it there with torch operations (an IEEE float32 add of the bias,
the same rounding as numpy's), so a column moves its payload's bytes to the
card and not four per row.
"""

from __future__ import annotations

import numpy as np
import torch

#: widths tried for integral numeric columns, cheapest first; each keeps its
#: dtype's minimum as the NA sentinel
_INT_WIDTHS = (np.int8, np.int16)

#: widths tried for categorical codes (CAT_NA = -1 fits each)
_DICT_WIDTHS = ((np.int8, "dict8"), (np.int16, "dict16"))


class CompressedChunk:
    """One column's host payload in its cheapest lossless encoding:
    ``payload`` is the narrow numpy array, ``codec`` names the encoding and
    ``bias`` shifts a narrow-int payload back to the values."""

    __slots__ = ("codec", "payload", "bias", "raw_bytes")

    def __init__(self, codec: str, payload: np.ndarray, bias: float = 0.0,
                 raw_bytes: int | None = None):
        self.codec = codec
        self.payload = payload
        self.bias = float(bias)
        # the bytes of the float32/int32 column it stands for: the numerator
        # of the compression ratio
        self.raw_bytes = int(raw_bytes if raw_bytes is not None
                             else len(payload) * 4)

    @property
    def nbytes(self) -> int:
        return int(self.payload.nbytes)

    @property
    def nrows(self) -> int:
        return int(len(self.payload))

    @property
    def is_codes(self) -> bool:
        return self.codec.startswith("dict")

    def decode(self) -> np.ndarray:
        """The eager parse's host array: float32 with NaN for the numeric
        codecs, int32 codes (-1 for missing) for the dict codecs. The
        identity codec returns its payload itself."""
        p = self.payload
        if self.codec == "f32":
            return p
        if self.is_codes:
            return p.astype(np.int32)
        sentinel = np.iinfo(p.dtype).min
        out = p.astype(np.float32) + np.float32(self.bias)
        out[p == sentinel] = np.nan
        return out

    def to_tensor(self, device: torch.device) -> torch.Tensor:
        """The decoded column as a tensor on ``device``, equal bit for bit
        to ``torch.as_tensor(self.decode())``: the narrow payload is copied
        and widened on the device."""
        p = torch.as_tensor(self.payload).to(device)
        if self.codec == "f32":
            return p
        if self.is_codes:
            return p.to(torch.int32)
        sentinel = int(np.iinfo(self.payload.dtype).min)
        out = p.to(torch.float32) + torch.tensor(np.float32(self.bias),
                                                 device=device)
        return out.masked_fill_(p == sentinel, float("nan"))

    def __repr__(self) -> str:
        return (f"CompressedChunk({self.codec}, n={self.nrows}, "
                f"{self.nbytes}B/{self.raw_bytes}B)")


def encode_numeric(values: np.ndarray) -> CompressedChunk:
    """Encode a float32 column (NaN = missing) losslessly: a narrow width
    when every finite value is integral and the bias-shifted span fits,
    checked by decoding (float32 holds every integer only up to 2**24)."""
    v = np.asarray(values, dtype=np.float32)
    finite = v[np.isfinite(v)]
    if finite.size and np.all(finite == np.round(finite)):
        lo = float(finite.min())
        hi = float(finite.max())
        for dtype in _INT_WIDTHS:
            info = np.iinfo(dtype)
            if hi - lo <= info.max - (info.min + 1):
                sentinel = info.min
                shifted = np.full(v.shape, sentinel, dtype=dtype)
                ok = np.isfinite(v)
                shifted[ok] = (v[ok] - np.float32(lo)).astype(np.int64) \
                    + (sentinel + 1)
                chunk = CompressedChunk(f"i{np.dtype(dtype).itemsize * 8}",
                                        shifted, bias=lo - (sentinel + 1),
                                        raw_bytes=v.nbytes)
                if np.array_equal(chunk.decode(), v, equal_nan=True):
                    return chunk
    return CompressedChunk("f32", v, raw_bytes=v.nbytes)


def encode_codes(codes: np.ndarray, cardinality: int) -> CompressedChunk:
    """Dictionary codes narrowed to the cheapest width that holds
    ``cardinality`` levels."""
    c = np.asarray(codes, dtype=np.int32)
    for dtype, codec in _DICT_WIDTHS:
        if cardinality - 1 <= np.iinfo(dtype).max:
            return CompressedChunk(codec, c.astype(dtype), raw_bytes=c.nbytes)
    return CompressedChunk("dict32", c, raw_bytes=c.nbytes)


def encode_column(values: np.ndarray, is_categorical: bool = False,
                  cardinality: int = 0) -> CompressedChunk:
    """Encode one parsed column (float32 numbers or int32 codes)."""
    if is_categorical:
        return encode_codes(values, cardinality)
    return encode_numeric(values)


def concat_chunks(chunks: list[CompressedChunk],
                  is_categorical: bool = False,
                  cardinality: int = 0) -> CompressedChunk:
    """One column-spanning chunk from a column's chunks, encoded again so
    the payload is as narrow as the whole column's span allows."""
    if len(chunks) == 1 and not is_categorical:
        return chunks[0]
    decoded = np.concatenate([c.decode() for c in chunks]) if chunks \
        else np.empty(0, np.float32)
    return encode_column(decoded, is_categorical=is_categorical,
                         cardinality=cardinality)
