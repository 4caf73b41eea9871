"""Genmodel tooling: PrintMojo and the row-oriented easy-predict wrapper —
the port of ``h2o3_tpu/genmodel/tools.py``.

Reference: ``h2o-genmodel``'s ``tools/PrintMojo.java`` (render a MOJO's
trees as Graphviz dot / a readable listing) and
``easy/EasyPredictModelWrapper.java`` (score one ``RowData`` dict at a time
with named columns and string categoricals, returning a typed prediction).

    python -m h2o3_tpu_torch.genmodel.tools model.mojo --format dot > trees.dot
    python -m h2o3_tpu_torch.genmodel.tools model.mojo --format list \
        --device cpu

The MOJO loads on the card unless ``--device`` (``device=``) says
otherwise; the trees are read on the host.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["print_mojo", "EasyPredictModelWrapper"]


# ---------------------------------------------------------------------------
# PrintMojo


class _HostTree:
    """A tree's fields as host numpy arrays."""

    def __init__(self, t):
        for f in ("feat", "thresh_val", "na_left", "is_split", "leaf",
                  "left_mask"):
            v = getattr(t, f)
            setattr(self, f, v.cpu().numpy() if isinstance(v, torch.Tensor)
                    else v)


def _tree_iter(model):
    """(label, Tree) pairs across single-output and multinomial models."""
    out = model.output
    if out.get("trees_multi") is not None:
        dom = model.response_domain or []
        for k, trees in enumerate(out["trees_multi"]):
            for i, t in enumerate(trees):
                yield (f"class {dom[k] if k < len(dom) else k} tree {i}",
                       _HostTree(t))
    else:
        for i, t in enumerate(out.get("trees") or []):
            yield f"tree {i}", _HostTree(t)


def _node_label(t, i, x_cols, domains):
    feat = int(np.asarray(t.feat)[i])
    if feat < 0 or not bool(np.asarray(t.is_split)[i]):
        return f"leaf = {float(np.asarray(t.leaf)[i]):.5g}"
    name = x_cols[feat] if feat < len(x_cols) else f"f{feat}"
    if t.left_mask is not None and name in domains:
        mask = np.asarray(t.left_mask)[i]
        dom = domains[name]
        levels = [dom[b] for b in np.nonzero(mask)[0] if b < len(dom)]
        shown = ", ".join(levels[:4]) + ("…" if len(levels) > 4 else "")
        return f"{name} ∈ {{{shown}}}"
    return f"{name} < {float(np.asarray(t.thresh_val)[i]):.5g}"


def print_mojo(path_or_model, fmt: str = "dot", max_trees: int | None = None,
               out=None, device: str | torch.device | None = None) -> str:
    """Render a MOJO's (or live model's) trees (reference PrintMojo).

    ``fmt``: ``"dot"`` (Graphviz digraphs, one per tree) or ``"list"``
    (indented text). Returns the rendering; also writes to ``out`` if
    given. A MOJO's path loads onto ``device``.
    """
    model = path_or_model
    if isinstance(path_or_model, str):
        from h2o3_tpu_torch.genmodel.mojo import MojoModel
        model = MojoModel.load(path_or_model, device=device)._inner
    x_cols = model.output.get("x_cols", [])
    domains = model.output.get("feat_domains") or {}
    chunks: list[str] = []
    for n, (label, t) in enumerate(_tree_iter(model)):
        if max_trees is not None and n >= max_trees:
            break
        heap = len(np.asarray(t.feat))
        is_split = np.asarray(t.is_split)
        # nodes reachable from the root only
        reach = {0}
        for i in range(heap):
            if i in reach and bool(is_split[i]) and 2 * i + 2 < heap:
                reach.update((2 * i + 1, 2 * i + 2))
        if fmt == "dot":
            lines = [f'digraph "{label}" {{', "  node [shape=box];"]
            for i in sorted(reach):
                lines.append(f'  n{i} [label="{_node_label(t, i, x_cols, domains)}"];')
                if bool(is_split[i]) and 2 * i + 2 < heap:
                    na_l = bool(np.asarray(t.na_left)[i])
                    yes = "yes, NA" if na_l else "yes"
                    no = "no" if na_l else "no, NA"
                    lines.append(f'  n{i} -> n{2 * i + 1} [label="{yes}"];')
                    lines.append(f'  n{i} -> n{2 * i + 2} [label="{no}"];')
            lines.append("}")
            chunks.append("\n".join(lines))
        else:
            lines = [label]
            stack = [(0, 0)]
            while stack:
                i, depth = stack.pop()
                if i not in reach:
                    continue
                lines.append("  " * (depth + 1) + _node_label(t, i, x_cols,
                                                              domains))
                if bool(is_split[i]) and 2 * i + 2 < heap:
                    stack.append((2 * i + 2, depth + 1))
                    stack.append((2 * i + 1, depth + 1))
            chunks.append("\n".join(lines))
    text = "\n\n".join(chunks) + "\n"
    if out is not None:
        out.write(text)
    return text


# ---------------------------------------------------------------------------
# EasyPredictModelWrapper


class EasyPredictModelWrapper:
    """Row-oriented scoring over named columns (reference
    ``easy/EasyPredictModelWrapper.java``): feed one dict per row, strings
    for categoricals, missing keys = NA; get a typed prediction back."""

    def __init__(self, model, device: str | torch.device | None = None):
        from h2o3_tpu_torch.device import resolve_device
        self.model = model
        self.device = resolve_device(device)

    def _row_frame(self, rows: list[dict]):
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.frame.types import VecType
        from h2o3_tpu_torch.frame.vec import Vec
        dev = self.device
        cols, vecs = [], []
        domains = self.model.output.get("feat_domains") or {}
        for c in self.model.output.get("x_cols", []):
            cols.append(c)
            if c in domains:
                dom = tuple(domains[c])
                codes = np.array([dom.index(r[c]) if r.get(c) in dom else -1
                                  for r in rows], np.int32)
                vecs.append(Vec.from_numpy(codes, type=VecType.CAT,
                                           domain=dom, device=dev))
            else:
                vals = np.array([np.nan if r.get(c) is None
                                 else float(r[c]) for r in rows], np.float32)
                vecs.append(Vec.from_numpy(vals, device=dev))
        return Frame(cols, vecs)

    def predict(self, row: dict) -> dict:
        """One row in, one typed prediction out."""
        preds = self.model.predict(self._row_frame([row]))
        out: dict = {}
        if self.model.is_classifier:
            out["label"] = preds.vec("predict").labels()[0]
            out["class_probabilities"] = {
                d: float(preds.vec(f"p{d}").to_numpy()[0])
                for d in self.model.response_domain}
        else:
            out["value"] = float(preds.vec("predict").to_numpy()[0])
        return out

    def predict_batch(self, rows: list[dict]) -> list[dict]:
        preds = self.model.predict(self._row_frame(rows))
        n = len(rows)
        if self.model.is_classifier:
            labs = preds.vec("predict").labels()[:n]
            probs = {d: preds.vec(f"p{d}").to_numpy()[:n]
                     for d in self.model.response_domain}
            return [{"label": labs[i],
                     "class_probabilities": {d: float(p[i])
                                             for d, p in probs.items()}}
                    for i in range(n)]
        vals = preds.vec("predict").to_numpy()[:n]
        return [{"value": float(v)} for v in vals]


if __name__ == "__main__":
    import argparse
    import sys

    ap = argparse.ArgumentParser(description="PrintMojo")
    ap.add_argument("mojo")
    ap.add_argument("--format", choices=("dot", "list"), default="dot")
    ap.add_argument("--max-trees", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="where the MOJO loads (default: the CUDA card)")
    a = ap.parse_args()
    print_mojo(a.mojo, fmt=a.format, max_trees=a.max_trees, out=sys.stdout,
               device=a.device)
