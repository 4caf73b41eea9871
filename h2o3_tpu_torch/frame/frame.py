"""Frame — a named list of equal-length columns — the port of
``h2o3_tpu/frame/frame.py``.

All on-device columns of a Frame live on one device and carry no padding;
host-resident string columns sit beside them. :meth:`Frame.from_pandas`
and :meth:`Frame.to_pandas` convert from and to pandas; the munging
methods (sort, group_by, merge, ...) call :mod:`h2o3_tpu_torch.rapids`.
Columns of the streaming parse keep compressed host payloads whose
tensors are built on first use; :attr:`Frame.nbytes` and
:meth:`Frame.drop_device_views` serve the memory meter and the Cleaner.

Under a mesh of W > 1 ranks a frame made from host columns is row-blocked
(``frame/vec.py``): each rank's device holds its block of every column,
:attr:`Frame.nrows` counts all the rows and :attr:`Frame.block` names the
block. ``sort`` and ``split_frame`` gather the whole frame and cut the
result into blocks again (correct, not fast); every other whole-frame
operation raises :class:`~h2o3_tpu_torch.parallel.mesh.MeshUnsupported`
there. The reference's mesh views are left out.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import (Vec, _factorize, _guess_type,
                                      row_block, upload_rows)
from h2o3_tpu_torch.parallel.mesh import refuse_on_mesh


class Frame:
    """Columnar table on one device (reference: ``water.fvec.Frame``)."""

    def __init__(self, names: Sequence[str], vecs: Sequence[Vec],
                 key: str | None = None):
        if len(names) != len(vecs):
            raise ValueError("names/vecs length mismatch")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")
        if len({v.nrows for v in vecs}) > 1:
            raise ValueError("vecs disagree on nrows")
        if len({v.device for v in vecs if v.device is not None}) > 1:
            raise ValueError("vecs live on different devices")
        if len({v.block for v in vecs}) > 1:
            raise ValueError("vecs disagree on their row blocks")
        self.names: list[str] = list(names)
        self.vecs: list[Vec] = list(vecs)
        self.key = key

    @staticmethod
    def from_arrays(cols: Mapping[str, np.ndarray],
                    types: Mapping[str, VecType] | None = None,
                    key: str | None = None,
                    device: str | torch.device | None = None) -> "Frame":
        """Build a frame from host columns, uploading all numeric columns as
        one [ncols, nrows] float32 transfer; categorical columns (strings,
        or any column typed CAT) are factorized to sorted domains."""
        dev = resolve_device(device)
        types = types or {}
        names = list(cols.keys())
        vecs: dict[str, Vec] = {}
        floats: list[tuple[str, np.ndarray, VecType]] = []
        for k in names:
            v = np.asarray(cols[k])
            t = types.get(k) or _guess_type(v)
            if t is VecType.CAT and v.dtype.kind not in "iu":
                codes, dom = _factorize(v)
                data, kw = upload_rows(codes, dev)
                vecs[k] = Vec(data, VecType.CAT, domain=tuple(dom), **kw)
            elif t in (VecType.NUM, VecType.INT) and v.dtype.kind in "fiub":
                floats.append((k, v, t))
            else:
                vecs[k] = Vec.from_numpy(v, type=t, device=dev)
        if floats:
            mat = np.empty((len(floats), len(floats[0][1])), np.float32)
            for i, (_, v, _) in enumerate(floats):
                mat[i] = v
            block = row_block(mat.shape[1])
            if block is None:
                dmat = torch.as_tensor(mat).to(dev)
                for i, (k, _, t) in enumerate(floats):
                    vecs[k] = Vec(dmat[i], t)
            else:   # this rank's rows; each column's whole on the host
                dmat = torch.as_tensor(np.ascontiguousarray(
                    mat[:, block[0]:block[1]])).to(dev)
                for i, (k, _, t) in enumerate(floats):
                    vecs[k] = Vec(dmat[i], t, block=block, host_full=mat[i])
        return Frame(names, [vecs[k] for k in names], key=key)

    @staticmethod
    def from_pandas(df, key: str | None = None,
                    device: str | torch.device | None = None) -> "Frame":
        """A pandas DataFrame as a Frame, with the parser's type guessing:
        object and string columns become categorical (sorted domains),
        datetimes TIME, booleans INT (0/1) and numbers NUM or INT, through
        :meth:`from_arrays`' batched upload."""
        dev = resolve_device(device)
        cols: dict[str, np.ndarray] = {}
        types: dict[str, VecType] = {}
        times: dict[str, np.ndarray] = {}
        for col in df.columns:
            s, name = df[col], str(col)
            if s.dtype.kind in "OUS" or str(s.dtype) in ("category", "str"):
                # a category column is factorized again: sorted domain
                cols[name] = (s.astype(object).to_numpy()
                              if str(s.dtype) == "category"
                              else s.to_numpy(dtype=object))
            elif s.dtype.kind == "M":
                times[name] = s.to_numpy()
            elif s.dtype.kind == "b":
                cols[name] = s.to_numpy().astype(np.float32)
                types[name] = VecType.INT
            else:
                cols[name] = s.to_numpy(dtype=np.float32, na_value=np.nan)
        fr = Frame.from_arrays(cols, types=types, device=dev)
        vecs = [Vec.from_numpy(times[str(c)], type=VecType.TIME, device=dev)
                if str(c) in times else fr.vec(str(c)) for c in df.columns]
        return Frame([str(c) for c in df.columns], vecs, key=key)

    def to_pandas(self):
        """The frame as a pandas DataFrame: categorical columns as their
        labels (None for missing), string columns as objects, TIME columns
        as datetimes, numbers as float32."""
        refuse_on_mesh("Frame.to_pandas")
        import pandas as pd
        out = {}
        for n, v in zip(self.names, self.vecs):
            if v.is_categorical:
                out[n] = pd.Series(v.labels(), dtype=object)
            elif v.type is VecType.TIME:
                out[n] = pd.to_datetime(pd.Series(v.to_numpy()), unit="ms")
            elif v.data is not None:
                out[n] = v.to_numpy()
            else:
                out[n] = pd.Series(v.host_values, dtype=object)
        return pd.DataFrame(out)

    @property
    def nrows(self) -> int:
        """Rows of the frame: all of them for a row-blocked frame."""
        if not self.vecs:
            return 0
        b = self.vecs[0].block
        return b[2] if b is not None else self.vecs[0].nrows

    @property
    def local_nrows(self) -> int:
        """Rows this rank holds on its device: all of them outside a
        mesh."""
        return self.vecs[0].nrows if self.vecs else 0

    @property
    def block(self) -> tuple | None:
        """(lo, hi, nrows) of this rank's row block, or None for a frame
        that holds all its rows."""
        return self.vecs[0].block if self.vecs else None

    @property
    def ncols(self) -> int:
        return len(self.vecs)

    @property
    def device(self) -> torch.device:
        """The device of the on-device columns (the CPU for a frame of
        host columns alone)."""
        return next((v.device for v in self.vecs if v.device is not None),
                    torch.device("cpu"))

    @property
    def types(self) -> dict[str, str]:
        return {n: str(v.type) for n, v in zip(self.names, self.vecs)}

    @property
    def nbytes(self) -> int:
        """Summed resident bytes of the columns (tensors that exist,
        compressed payloads, host values); builds no view."""
        return sum(v.nbytes for v in self.vecs)

    def drop_device_views(self) -> int:
        """Let every compressed column's derived tensor go (the Cleaner's
        first tier); returns the bytes freed."""
        return sum(v.drop_device() for v in self.vecs)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    def vec(self, col: int | str) -> Vec:
        return self.vecs[self._index(col)]

    def _index(self, col: int | str) -> int:
        if isinstance(col, (int, np.integer)):
            return int(col)
        try:
            return self.names.index(col)
        except ValueError:
            raise KeyError(f"no column {col!r}; have {self.names}") from None

    def __getitem__(self, sel):
        """A column (by name or index) or a list of them as a new Frame, or
        the rows where a Vec is truthy (reference: ``AstRowSlice``)."""
        if isinstance(sel, (str, int, np.integer)):
            i = self._index(sel)
            return Frame([self.names[i]], [self.vecs[i]])
        if isinstance(sel, (list, tuple)):
            idxs = [self._index(c) for c in sel]
            return Frame([self.names[i] for i in idxs],
                         [self.vecs[i] for i in idxs])
        if isinstance(sel, Vec):
            return self.filter(sel)
        raise TypeError(f"unsupported selector {sel!r}")

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def add(self, name: str, vec: Vec) -> "Frame":
        """Append a column in place."""
        if self.vecs and (vec.nrows != self.local_nrows
                          or vec.block != self.block):
            raise ValueError("row count mismatch")
        if name in self.names:
            raise ValueError(f"duplicate column name: {name!r}")
        self.names.append(name)
        self.vecs.append(vec)
        return self

    def remove(self, col: int | str) -> Vec:
        """Take a column out in place and return it."""
        i = self._index(col)
        self.names.pop(i)
        return self.vecs.pop(i)

    def replace_vec(self, col: int | str, vec: Vec) -> "Frame":
        """Replace a column's Vec in place (impute, transforms)."""
        if self.vecs and (vec.nrows != self.local_nrows
                          or vec.block != self.block):
            raise ValueError("row count mismatch")
        self.vecs[self._index(col)] = vec
        return self

    def subframe(self, cols: Iterable[str]) -> "Frame":
        return self[list(cols)]

    def matrix(self, cols: Sequence[str] | None = None) -> torch.Tensor:
        """On-device columns stacked into a [nrows, k] float32 tensor
        (categorical codes as floats, NaN for missing)."""
        cols = list(cols) if cols is not None else [
            n for n, v in zip(self.names, self.vecs) if v.data is not None]
        arrs = []
        for c in cols:
            v = self.vec(c)
            if v.data is None:
                raise TypeError(f"column {c!r} of type {v.type} has no "
                                "device data")
            arrs.append(v.as_float())
        if not arrs:
            return torch.empty(self.nrows, 0, device=self.device)
        return torch.stack(arrs, dim=1)

    def row_mask(self) -> torch.Tensor:
        """Boolean mask of the logical rows this rank holds: all True, since
        the port's columns carry no padding (kept so row-weight code reads
        as in the reference)."""
        return torch.ones(self.local_nrows, dtype=torch.bool,
                          device=self.device)

    def _gathered(self) -> "Frame":
        """The whole of a row-blocked frame as an ordinary frame on this
        rank's device (host copies where the columns have them, every
        rank's block gathered where not: a collective)."""
        vecs = [Vec(torch.as_tensor(np.ascontiguousarray(v.to_numpy()))
                    .to(self.device), v.type, domain=v.domain)
                for v in self.vecs]
        return Frame(self.names, vecs, key=self.key)

    @staticmethod
    def _reblocked(whole: "Frame") -> "Frame":
        """An ordinary frame cut into row blocks again (its whole kept on
        the host)."""
        dev = whole.device
        vecs = []
        for v in whole.vecs:
            data, kw = upload_rows(v.data.cpu().numpy(), dev)
            vecs.append(Vec(data, v.type, domain=v.domain, **kw))
        return Frame(whole.names, vecs, key=whole.key)

    def head(self, n: int = 10):
        """The first ``n`` rows as a pandas DataFrame."""
        refuse_on_mesh("Frame.head")
        from h2o3_tpu_torch.rapids.munge import gather_rows
        idx = torch.arange(min(n, self.nrows), device=self.device)
        return gather_rows(self, idx).to_pandas()

    # -- munging (the rapids layer; h2o-py H2OFrame's methods) ---------------

    def sort(self, by, ascending=True) -> "Frame":
        from h2o3_tpu_torch.rapids import munge
        if self.block is not None:
            return Frame._reblocked(munge.sort(self._gathered(), by,
                                               ascending))
        return munge.sort(self, by, ascending)

    def group_by(self, by):
        refuse_on_mesh("Frame.group_by")
        from h2o3_tpu_torch.rapids import GroupBy
        return GroupBy(self, by)

    def merge(self, other: "Frame", by=None, all_x: bool = False,
              all_y: bool = False) -> "Frame":
        refuse_on_mesh("Frame.merge")
        from h2o3_tpu_torch.rapids import munge
        return munge.merge(self, other, by=by, all_x=all_x, all_y=all_y)

    def filter(self, mask) -> "Frame":
        refuse_on_mesh("Frame.filter")
        from h2o3_tpu_torch.rapids import munge
        return munge.filter_rows(self, mask)

    def rbind(self, *others: "Frame") -> "Frame":
        refuse_on_mesh("Frame.rbind")
        from h2o3_tpu_torch.rapids import munge
        return munge.rbind(self, *others)

    def cbind(self, *others: "Frame") -> "Frame":
        refuse_on_mesh("Frame.cbind")
        from h2o3_tpu_torch.rapids import munge
        return munge.cbind(self, *others)

    def split_frame(self, ratios=(0.75,), destination_frames=None,
                    seed: int = -1) -> list["Frame"]:
        from h2o3_tpu_torch.frame.utils import split_frame
        if self.block is not None:
            from h2o3_tpu_torch.parallel.distributed import common_seed
            parts = split_frame(self._gathered(), ratios, None,
                                common_seed(seed))
            parts = [Frame._reblocked(p) for p in parts]
            if destination_frames is not None:
                from h2o3_tpu_torch.utils.registry import DKV
                if len(destination_frames) != len(parts):
                    raise ValueError("need len(ratios)+1 destination_frames")
                for p, key in zip(parts, destination_frames):
                    p.key = key
                    DKV.put(key, p)
            return parts
        return split_frame(self, ratios, destination_frames, seed)

    def unique(self, cols=None) -> "Frame":
        refuse_on_mesh("Frame.unique")
        from h2o3_tpu_torch.rapids import munge
        return munge.unique(self, cols)

    def pivot(self, index: str, column: str, value: str,
              agg: str = "mean") -> "Frame":
        refuse_on_mesh("Frame.pivot")
        from h2o3_tpu_torch.rapids import munge
        return munge.pivot(self, index, column, value, agg)

    def melt(self, id_vars, value_vars=None, **kw) -> "Frame":
        refuse_on_mesh("Frame.melt")
        from h2o3_tpu_torch.rapids import munge
        return munge.melt(self, id_vars, value_vars, **kw)

    def quantile(self, probs=(0.001, 0.01, 0.1, 0.25, 0.333, 0.5, 0.667,
                              0.75, 0.9, 0.99, 0.999)) -> "Frame":
        refuse_on_mesh("Frame.quantile")
        from h2o3_tpu_torch.rapids import ops
        return ops.quantile(self, probs)

    def impute(self, column: str, method: str = "mean", by=None) -> "Frame":
        refuse_on_mesh("Frame.impute")
        from h2o3_tpu_torch.rapids import ops
        return ops.impute(self, column, method, by)

    def scale(self, center: bool = True, scale: bool = True) -> "Frame":
        refuse_on_mesh("Frame.scale")
        from h2o3_tpu_torch.rapids import ops
        return ops.scale(self, center, scale)

    def __len__(self) -> int:
        return self.nrows

    def __repr__(self) -> str:
        return f"Frame({self.nrows} rows x {self.ncols} cols: {self.names})"
