"""Frame utilities — the port of ``h2o3_tpu/frame/utils.py``: row splits,
CreateFrame, interactions, TF-IDF and rebalance.

Reference: h2o-py ``frame.split_frame`` (a uniform draw a row against the
cumulative ratios), ``hex/createframe/`` (CreateFrameV3), ``water/fvec/
CreateInteractions.java``, ``hex/tfidf/`` (``idf = log((N+1)/(df+1))``)
and ``water/fvec/RebalanceDataSet.java``. Draws and text processing run on
the host with the reference's numpy generators, so splits and generated
frames equal the reference's row for row; the results are uploaded to the
frame's device (or ``device``), and a split's parts are row gathers on it.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec, _guess_type
from h2o3_tpu_torch.rapids.munge import gather_rows
from h2o3_tpu_torch.utils.registry import DKV


def _device_of(frame: Frame, device) -> torch.device:
    """``device`` if given, else the frame's device, else the default (a
    frame of host columns alone)."""
    if device is not None or all(v.data is None for v in frame.vecs):
        return resolve_device(device)
    return frame.device


def split_frame(frame: Frame, ratios=(0.75,), destination_frames=None,
                seed: int = -1) -> list[Frame]:
    """``len(ratios) + 1`` frames of the rows whose uniform draw falls in
    each ratio's interval (h2o-py ``split_frame``); named parts go into
    the DKV."""
    ratios = list(ratios)
    if not ratios:
        raise ValueError("ratios may not be empty")
    if any(r <= 0 for r in ratios):
        raise ValueError("ratios must be > 0")
    if sum(ratios) >= 1.0:
        raise ValueError("ratios must add up to less than 1.0")
    if destination_frames is not None and \
            len(destination_frames) != len(ratios) + 1:
        raise ValueError("need len(ratios)+1 destination_frames")
    rng = np.random.default_rng(None if seed in (-1, None) else int(seed))
    u = rng.random(frame.nrows)
    bounds = np.cumsum([0.0] + ratios + [1.0])
    out = []
    for i in range(len(ratios) + 1):
        mask = ((u > bounds[i]) if i else (u >= 0)) & (u <= bounds[i + 1])
        part = gather_rows(frame, np.nonzero(mask)[0])
        if destination_frames is not None:
            part.key = destination_frames[i]
            DKV.put(part.key, part)
        out.append(part)
    return out


def create_frame(rows: int = 10000, cols: int = 10, randomize: bool = True,
                 value: float = 0.0, real_range: float = 100.0,
                 categorical_fraction: float = 0.2, factors: int = 100,
                 integer_fraction: float = 0.2, integer_range: int = 100,
                 binary_fraction: float = 0.1,
                 binary_ones_fraction: float = 0.02,
                 time_fraction: float = 0.0, string_fraction: float = 0.0,
                 missing_fraction: float = 0.01, has_response: bool = False,
                 response_factors: int = 2, positive_response: bool = False,
                 seed: int | None = None, key: str | None = None,
                 device: str | torch.device | None = None) -> Frame:
    """h2o-py ``h2o.create_frame`` (reference: CreateFrameV3's fields),
    drawn from ``np.random.default_rng(seed)`` in the reference's order."""
    dev = resolve_device(device)
    fracs = (categorical_fraction + integer_fraction + binary_fraction
             + time_fraction + string_fraction)
    if fracs > 1.0 + 1e-9:
        raise ValueError("column type fractions sum to > 1")
    rng = np.random.default_rng(seed)
    counts = {
        "cat": int(round(cols * categorical_fraction)),
        "int": int(round(cols * integer_fraction)),
        "bin": int(round(cols * binary_fraction)),
        "time": int(round(cols * time_fraction)),
        "str": int(round(cols * string_fraction)),
    }
    counts["real"] = max(0, cols - sum(counts.values()))
    num = lambda a, t=None: Vec.from_numpy(a, t, device=dev)  # noqa: E731

    names, vecs = [], []
    if has_response:
        names.append("response")
        if response_factors == 1:
            r = rng.uniform(0, real_range, rows) if positive_response \
                else rng.uniform(-real_range, real_range, rows)
            vecs.append(num(r.astype(np.float32)))
        else:
            dom = tuple(f"resp_{i}" for i in range(response_factors))
            codes = rng.integers(0, response_factors, rows)
            vecs.append(Vec.from_numpy(codes.astype(np.int32), VecType.CAT,
                                       domain=dom, device=dev))

    def miss(arr):
        if missing_fraction > 0 and randomize:
            m = rng.random(rows) < missing_fraction
            arr = arr.astype(np.float64)
            arr[m] = np.nan
        return arr

    idx = 0
    for kind, n in counts.items():
        for _ in range(n):
            idx += 1
            names.append(f"C{idx}")
            if not randomize:
                vecs.append(num(np.full(rows, value, np.float32)))
            elif kind == "real":
                vecs.append(num(miss(rng.uniform(-real_range, real_range,
                                                 rows)).astype(np.float32)))
            elif kind == "int":
                vecs.append(num(miss(rng.integers(
                    -integer_range, integer_range + 1, rows).astype(
                        np.float64)).astype(np.float32)))
            elif kind == "bin":
                vecs.append(num(miss((rng.random(rows) < binary_ones_fraction)
                                     .astype(np.float64)).astype(np.float32)))
            elif kind == "cat":
                dom = tuple(f"c{idx}.l{i}" for i in range(factors))
                codes = rng.integers(0, factors, rows).astype(np.int32)
                if missing_fraction > 0:
                    codes[rng.random(rows) < missing_fraction] = -1
                vecs.append(Vec.from_numpy(codes, VecType.CAT, domain=dom,
                                           device=dev))
            elif kind == "time":
                t = rng.integers(0, 2_000_000_000_000, rows).astype(
                    np.float64)
                vecs.append(num(miss(t), VecType.TIME))
            else:
                vecs.append(Vec.from_numpy(np.array(
                    [f"s{v:06d}" for v in rng.integers(0, 10**6, rows)],
                    dtype=object), VecType.STR))
    return Frame(names, vecs, key=key)


def interaction(frame: Frame, factors: list, pairwise: bool = False,
                max_factors: int = 100, min_occurrence: int = 1,
                destination_frame: str | None = None) -> Frame:
    """h2o-py ``h2o.interaction`` (reference: CreateInteractions.java): the
    combined levels of each group of categorical columns, ranked by
    frequency and cut to ``max_factors`` (the rest ``"other"``).
    ``factors``: column names (one interaction of all), a list of lists,
    or names with ``pairwise`` (every 2-way interaction)."""
    if factors and isinstance(factors[0], (list, tuple)):
        groups = [list(g) for g in factors]
    elif pairwise:
        groups = [[a, b] for i, a in enumerate(factors)
                  for b in factors[i + 1:]]
    else:
        groups = [list(factors)]
    dev = _device_of(frame, None)
    names, vecs = [], []
    for group in groups:
        if len(group) < 2:
            raise ValueError(f"interaction needs >= 2 columns, got {group}")
        labels = na = None
        for c in group:
            v = frame.vec(c)
            if not v.is_categorical:
                raise ValueError(
                    f"interaction column {c!r} must be categorical")
            part = v.labels().astype(object)
            pna = np.array([s is None for s in part], dtype=bool)
            part = np.where(pna, "", part).astype(object)
            labels = part if labels is None else labels + "_" + part
            na = pna if na is None else (na | pna)
        labels[na] = None
        present = labels[~na]
        vals, cnts = np.unique(present.astype(str), return_counts=True) \
            if len(present) else (np.array([], dtype=str), np.array([], int))
        keep = vals[cnts >= min_occurrence]
        kc = cnts[cnts >= min_occurrence]
        kept = list(keep[np.argsort(-kc, kind="stable")][:max_factors])
        overflow = len(keep) > max_factors or len(vals) > len(keep)
        dom = tuple(str(s) for s in kept) + (("other",) if overflow else ())
        lut = {lvl: i for i, lvl in enumerate(dom)}
        other = lut.get("other", -1)
        codes = np.array([lut.get(s, other) if s is not None else -1
                          for s in labels], np.int32)
        names.append("_".join(group))
        vecs.append(Vec.from_numpy(codes, VecType.CAT, domain=dom,
                                   device=dev))
    return Frame(names, vecs, key=destination_frame)


def tf_idf(frame: Frame, document_id_col: str, text_col: str,
           preprocess: bool = True, case_sensitive: bool = True,
           device: str | torch.device | None = None) -> Frame:
    """h2o-py ``tf_idf`` (reference: hex/tfidf): a row per (document,
    word), sorted by document then word, with TF, IDF and TF-IDF, ``idf =
    log((N+1)/(df+1))``; ``preprocess`` splits the text on whitespace."""
    dev = _device_of(frame, device)
    doc_v, txt_v = frame.vec(document_id_col), frame.vec(text_col)
    docs = doc_v.labels() if doc_v.domain is not None else doc_v.to_numpy()
    texts = txt_v.labels() if txt_v.domain is not None else txt_v.to_numpy()
    pairs: dict[tuple, int] = {}
    doc_words: dict[str, set] = {}
    for d, t in zip(docs, texts):
        if t is None or (isinstance(t, float) and np.isnan(t)):
            continue
        for w in (str(t).split() if preprocess else [str(t)]):
            if not case_sensitive:
                w = w.lower()
            pairs[(d, w)] = pairs.get((d, w), 0) + 1
            doc_words.setdefault(w, set()).add(d)
    docs_obj = np.asarray(docs, dtype=object)
    nan_doc = np.array([isinstance(v, (float, np.floating)) and np.isnan(v)
                        for v in docs_obj], dtype=bool)
    n_docs = len(set(docs_obj[~nan_doc]))
    rows = sorted(pairs.items(), key=lambda kv: (str(kv[0][0]), kv[0][1]))
    if doc_v.is_numeric:
        doc_vec = Vec.from_numpy(np.array([float(d) for (d, _), _ in rows],
                                          np.float32), device=dev)
    else:
        doc_vec = Vec.from_numpy(np.array([str(d) for (d, _), _ in rows],
                                          dtype=object), VecType.STR)
    tf = np.array([c for _, c in rows], np.float32)
    idf = np.array([np.log((n_docs + 1) / (len(doc_words[w]) + 1))
                    for (_, w), _ in rows], np.float32)
    stats = torch.as_tensor(np.stack([tf, idf, tf * idf])
                            if rows else np.zeros((3, 0), np.float32)).to(dev)
    return Frame(
        [document_id_col, text_col, "TF", "IDF", "TF_IDF"],
        [doc_vec,
         Vec.from_numpy(np.array([w for (_, w), _ in rows], dtype=object),
                        VecType.STR),
         *(Vec(stats[i], _guess_type(a))
           for i, a in enumerate((tf, idf, tf * idf)))])


def rebalance(frame: Frame, key: str | None = None) -> Frame:
    """A fresh copy of every column (reference: RebalanceDataSet re-chunks;
    the port's columns have one layout, so this copies them)."""
    vecs = []
    for v in frame.vecs:
        nv = Vec(None if v.data is None else v.data.clone(), v.type,
                 domain=v.domain, host_values=None if v.host_values is None
                 else v.host_values.copy(), time_offset=v.time_offset)
        vecs.append(nv)
    return Frame(list(frame.names), vecs, key=key)
