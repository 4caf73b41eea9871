"""String functions on STR (host) and CAT (domain) columns — the port of
``h2o3_tpu/rapids/strings.py``.

Reference: ``water/rapids/ast/prims/string/`` (``AstToUpper``,
``AstStrSplit``, ``AstReplaceAll`` ...). A categorical column is
transformed through its domain, once per level rather than once per row
(levels that collapse, as "A" and "a" under :func:`tolower`, are
factorized again); a string column's values live on the host and are
mapped there. A function with a numeric result returns a float32 column on
the card (a categorical column's result is gathered on its own device from
a per-level table); missing strings give NaN.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec


def _values(vec: Vec) -> list:
    """A STR or CAT column's strings (None = missing)."""
    if vec.is_categorical:
        return list(vec.labels())
    if vec.type is not VecType.STR:
        raise TypeError(f"string op on {vec.type} column")
    return list(vec.host_values)


def _apply(vec: Vec, fn) -> Vec:
    """A str -> str function: CAT maps its domain, STR its values."""
    if vec.is_categorical:
        new_dom = [fn(s) for s in vec.domain]
        if len(set(new_dom)) == len(new_dom):
            return Vec(vec.data, VecType.CAT, domain=tuple(new_dom))
        table = np.array(new_dom + [None], dtype=object)
        codes = vec.to_numpy()
        return Vec.from_numpy(table[np.where(codes >= 0, codes,
                                             len(new_dom))],
                              device=vec.device)
    if vec.type is not VecType.STR:
        raise TypeError(f"string op on {vec.type} column")
    out = np.array([None if s is None else fn(s) for s in vec.host_values],
                   dtype=object)
    return Vec(None, VecType.STR, host_values=out)


def _apply_num(vec: Vec, fn, device=None) -> Vec:
    """A str -> float function; a missing string gives NaN. A CAT column
    evaluates ``fn`` once per level and gathers the table by its codes on
    its device; a STR column's values upload to ``device``."""
    if vec.is_categorical:
        lut = torch.tensor([fn(s) for s in vec.domain] + [np.nan],
                           dtype=torch.float64, device=vec.device)
        codes = vec.data.long()
        idx = torch.where(codes >= 0, codes, len(vec.domain))
        return Vec(lut[idx].float(), VecType.NUM)
    if vec.type is not VecType.STR:
        raise TypeError(f"string op on {vec.type} column")
    vals = np.array([np.nan if s is None else fn(s) for s in vec.host_values],
                    dtype=np.float64)
    return Vec(torch.as_tensor(vals.astype(np.float32)).to(
        resolve_device(device)), VecType.NUM)


def toupper(vec: Vec) -> Vec: return _apply(vec, str.upper)
def tolower(vec: Vec) -> Vec: return _apply(vec, str.lower)
def trim(vec: Vec) -> Vec: return _apply(vec, str.strip)


def lstrip(vec: Vec, chars: str | None = None) -> Vec:
    return _apply(vec, lambda s: s.lstrip(chars))


def rstrip(vec: Vec, chars: str | None = None) -> Vec:
    return _apply(vec, lambda s: s.rstrip(chars))


def nchar(vec: Vec, device=None) -> Vec:
    return _apply_num(vec, len, device)


def substring(vec: Vec, start: int, end: int | None = None) -> Vec:
    return _apply(vec, lambda s: s[start:end])


def sub(vec: Vec, pattern: str, replacement: str,
        ignore_case: bool = False) -> Vec:
    """Replace the first regex match (reference: ``AstReplaceFirst``)."""
    rx = re.compile(pattern, re.IGNORECASE if ignore_case else 0)
    return _apply(vec, lambda s: rx.sub(replacement, s, count=1))


def gsub(vec: Vec, pattern: str, replacement: str,
         ignore_case: bool = False) -> Vec:
    """Replace every regex match (reference: ``AstReplaceAll``)."""
    rx = re.compile(pattern, re.IGNORECASE if ignore_case else 0)
    return _apply(vec, lambda s: rx.sub(replacement, s))


def grep(vec: Vec, pattern: str, ignore_case: bool = False,
         invert: bool = False, device=None) -> Vec:
    """1.0 where the regex matches (reference: ``AstGrep``)."""
    rx = re.compile(pattern, re.IGNORECASE if ignore_case else 0)
    return _apply_num(vec, lambda s: float(bool(rx.search(s)) != invert),
                      device)


def startswith(vec: Vec, prefix: str, device=None) -> Vec:
    return _apply_num(vec, lambda s: float(s.startswith(prefix)), device)


def endswith(vec: Vec, suffix: str, device=None) -> Vec:
    return _apply_num(vec, lambda s: float(s.endswith(suffix)), device)


def strsplit(vec: Vec, pattern: str) -> list[Vec]:
    """Split on a regex into string columns, ragged rows padded with
    missing values (reference: ``AstStrSplit``)."""
    rx = re.compile(pattern)
    parts = [None if s is None else rx.split(s) for s in _values(vec)]
    width = max((len(p) for p in parts if p is not None), default=0)
    return [Vec(None, VecType.STR, host_values=np.array(
        [None if p is None or i >= len(p) else p[i] for p in parts],
        dtype=object)) for i in range(width)]


def _entropy(s: str) -> float:
    if not s:
        return 0.0
    _, cnt = np.unique(list(s), return_counts=True)
    p = cnt / cnt.sum()
    return float(-(p * np.log2(p)).sum())


def entropy(vec: Vec, device=None) -> Vec:
    """Each string's Shannon entropy in bits (reference: ``AstEntropy``)."""
    return _apply_num(vec, _entropy, device)


def num_valid_substrings(vec: Vec, words: list[str], device=None) -> Vec:
    """How many of ``words`` each string contains (reference:
    ``AstCountSubstringsWords``)."""
    return _apply_num(vec, lambda s: float(sum(w in s for w in words)),
                      device)
