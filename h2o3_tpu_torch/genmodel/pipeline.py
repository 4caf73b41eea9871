"""MOJO pipeline transform runtime — feature engineering that ships with a
scoring artifact and runs before the model scores — the port of
``h2o3_tpu/genmodel/pipeline.py``.

Reference: ``h2o-genmodel-extensions/mojo-pipeline/.../transformers/*.java``
(MathUnaryTransform, MathBinaryTransform, StringUnaryTransform,
StringGrepTransform, StringSplitTransform, StringPropertiesUnary/Binary,
TimeUnaryTransform, ToNumericConversion, ToStringConversion) and the
``MojoPipelineBuilder`` assembly (``hex/genmodel/MojoPipelineBuilder.java``).
The reference runs each transform as a per-row Java loop over MojoFrame
columns; here the numeric transforms are float32 torch operations on the
frame's device (the special functions, digamma, gamma, lgamma and
trigamma, go through scipy on the host, as in the JAX package), the time
transforms are :mod:`~h2o3_tpu_torch.rapids.timeops`', and the string
transforms run on the host values (string columns live on the host).

A ``MojoPipeline`` is an ordered list of ``Transform`` steps plus a final
model; ``save``/``load`` round-trip through a JSON spec and the model's
MOJO inside one zip, in the JAX package's format, so a pipeline saved by
either package loads in the other.
"""

from __future__ import annotations

import json
import re
import zipfile

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec, floor_divide

__all__ = ["Transform", "MojoPipeline", "MATH_UNARY", "MATH_BINARY",
           "STRING_UNARY"]

# -- op tables (names match the reference factories) -------------------------

MATH_UNARY = {
    "abs": torch.abs, "acos": torch.acos, "acosh": torch.acosh,
    "asin": torch.asin, "asinh": torch.asinh, "atan": torch.atan,
    "atanh": torch.atanh, "ceiling": torch.ceil, "cos": torch.cos,
    "cosh": torch.cosh, "cospi": lambda x: torch.cos(np.pi * x),
    "digamma": lambda x: _scipy_host(x, "digamma"),
    "exp": torch.exp, "expm1": torch.expm1, "floor": torch.floor,
    "gamma": lambda x: _scipy_host(x, "gamma"),
    "lgamma": lambda x: _scipy_host(x, "gammaln"),
    "log": torch.log, "log10": torch.log10, "log1p": torch.log1p,
    "log2": torch.log2, "round": torch.round, "sign": torch.sign,
    "signif": torch.round,                    # signif(x, digits) via params
    "sin": torch.sin, "sinh": torch.sinh,
    "sinpi": lambda x: torch.sin(np.pi * x),
    "sqrt": torch.sqrt, "tan": torch.tan, "tanh": torch.tanh,
    "tanpi": lambda x: torch.tan(np.pi * x),
    "trigamma": lambda x: _scipy_host(x, "polygamma1"),
    "trunc": torch.trunc, "none": lambda x: x,
}

MATH_BINARY = {
    "+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
    "%": torch.remainder, "^": torch.pow, "intDiv": floor_divide,
    "==": lambda a, b: (a == b).to(torch.float32),
    "!=": lambda a, b: (a != b).to(torch.float32),
    "<": lambda a, b: (a < b).to(torch.float32),
    "<=": lambda a, b: (a <= b).to(torch.float32),
    ">": lambda a, b: (a > b).to(torch.float32),
    ">=": lambda a, b: (a >= b).to(torch.float32),
    "min": torch.minimum, "max": torch.maximum,
}

STRING_UNARY = {
    "toupper": lambda s: s.upper(), "tolower": lambda s: s.lower(),
    "trim": lambda s: s.strip(), "lstrip": lambda s: s.lstrip(),
    "rstrip": lambda s: s.rstrip(),
}

STRING_PROPS = {
    "length": lambda s: float(len(s)),
    "num_words": lambda s: float(len(s.split())),
    "entropy": lambda s: _entropy(s),
}


def _entropy(s: str) -> float:
    if not s:
        return 0.0
    from collections import Counter
    n = len(s)
    return float(-sum((c / n) * np.log2(c / n)
                      for c in Counter(s).values()))


def _scipy_host(x: torch.Tensor, fn: str) -> torch.Tensor:
    """Special functions torch lacks or computes otherwise: float64 scipy
    on the host, back as float32 (rare pipeline ops)."""
    import scipy.special as sp
    a = x.cpu().numpy().astype(np.float64)
    f = (lambda v: sp.polygamma(1, v)) if fn == "polygamma1" \
        else getattr(sp, fn)
    return torch.as_tensor(f(a).astype(np.float32)).to(x.device)


TIME_UNARY = ("year", "month", "day", "hour", "minute", "second",
              "dayOfWeek", "week")


class Transform:
    """One pipeline step: op over input column(s) into an output column.

    kinds: math_unary / math_binary / string_unary / string_prop /
    string_grep / string_split / time_unary / to_numeric / to_string.
    """

    def __init__(self, kind: str, op: str, inputs: list[str], output: str,
                 params: dict | None = None):
        self.kind = kind
        self.op = op
        self.inputs = list(inputs)
        self.output = output
        self.params = dict(params or {})
        self._check()

    def _check(self) -> None:
        tables = {"math_unary": MATH_UNARY, "math_binary": MATH_BINARY,
                  "string_unary": STRING_UNARY, "string_prop": STRING_PROPS}
        if self.kind in tables and self.op not in tables[self.kind]:
            raise ValueError(f"unsupported {self.kind} op {self.op!r}; "
                             f"have {sorted(tables[self.kind])}")
        if self.kind == "time_unary" and self.op not in TIME_UNARY:
            raise ValueError(f"unsupported time op {self.op!r}")

    # -- application ---------------------------------------------------------

    def apply(self, frame: Frame) -> Frame:
        out = Frame(list(frame.names), list(frame.vecs))
        if self.kind == "math_unary":
            v = frame.vec(self.inputs[0])
            if self.op == "signif":
                digits = int(self.params.get("digits", 6))
                x = v.as_float()
                # guard 0: log10(0) -> -inf -> mag inf -> 0*inf = NaN
                ax = torch.where(x == 0, 1.0, torch.abs(x))
                mag = torch.pow(10.0, digits - 1 - torch.floor(torch.log10(ax)))
                y = torch.where(x == 0, 0.0, torch.round(x * mag) / mag)
            else:
                y = MATH_UNARY[self.op](v.as_float())
            vec = Vec.from_device(y.to(torch.float32), VecType.NUM)
        elif self.kind == "math_binary":
            a = frame.vec(self.inputs[0]).as_float()
            b = (frame.vec(self.inputs[1]).as_float()
                 if len(self.inputs) > 1 else
                 torch.tensor(np.float32(self.params["constant"]),
                              device=a.device))
            if self.params.get("reverse"):      # constant OP column
                a, b = b, a
            y = MATH_BINARY[self.op](a, b)
            vec = Vec.from_device(y.to(torch.float32), VecType.NUM)
        elif self.kind in ("string_unary", "string_prop", "string_grep",
                           "to_numeric", "to_string", "string_split"):
            vec = self._apply_string(frame)
        elif self.kind == "time_unary":
            from h2o3_tpu_torch.rapids import timeops
            fn = {"dayOfWeek": "day_of_week"}.get(self.op, self.op)
            vec = getattr(timeops, fn)(frame.vec(self.inputs[0]))
        else:
            raise ValueError(f"unknown transform kind {self.kind!r}")
        if self.kind == "string_split":
            # split emits N columns: output, output.1, ...
            for i, v in enumerate(vec):
                _set_col(out, self.output if i == 0 else
                         f"{self.output}.{i}", v)
        else:
            _set_col(out, self.output, vec)
        return out

    def _apply_string(self, frame: Frame):
        v = frame.vec(self.inputs[0])
        vals = (v.labels() if v.is_categorical else
                v.host_values[: frame.nrows] if v.type is VecType.STR else
                [None if np.isnan(x) else _numstr(x) for x in v.to_numpy()])
        if self.kind == "string_unary":
            f = STRING_UNARY[self.op]
            return Vec.from_numpy(np.array(
                [None if s is None else f(str(s)) for s in vals],
                dtype=object), type=VecType.STR)
        dev = frame.device
        if self.kind == "string_prop":
            f = STRING_PROPS[self.op]
            return Vec.from_numpy(np.float32(
                [np.nan if s is None else f(str(s)) for s in vals]),
                device=dev)
        if self.kind == "string_grep":
            pat = re.compile(self.params["regex"])
            inv = bool(self.params.get("invert"))
            return Vec.from_numpy(np.float32(
                [np.nan if s is None else
                 float(bool(pat.search(str(s))) != inv) for s in vals]),
                device=dev)
        if self.kind == "string_split":
            pat = self.params.get("pattern", r"\s+")
            parts = [([] if s is None else re.split(pat, str(s)))
                     for s in vals]
            width = max((len(p) for p in parts), default=1)
            cols = []
            for i in range(width):
                cols.append(Vec.from_numpy(np.array(
                    [p[i] if i < len(p) else None for p in parts],
                    dtype=object), type=VecType.STR))
            return cols
        if self.kind == "to_numeric":
            def conv(s):
                try:
                    return float(s)
                except (TypeError, ValueError):
                    return np.nan
            return Vec.from_numpy(np.float32([conv(s) for s in vals]),
                                  device=dev)
        # to_string
        return Vec.from_numpy(np.array(
            [None if s is None else str(s) for s in vals], dtype=object),
            type=VecType.STR)

    def spec(self) -> dict:
        return dict(kind=self.kind, op=self.op, inputs=self.inputs,
                    output=self.output, params=self.params)

    @staticmethod
    def from_spec(d: dict) -> "Transform":
        return Transform(d["kind"], d["op"], d["inputs"], d["output"],
                         d.get("params"))


def _numstr(x: float) -> str:
    return str(int(x)) if float(x).is_integer() else repr(float(x))


def _set_col(frame: Frame, name: str, vec) -> None:
    """Add-or-replace: in-place transforms (output == an existing column)
    are a normal reference-pipeline shape."""
    if name in frame.names:
        frame.replace_vec(name, vec)
    else:
        frame.add(name, vec)


class MojoPipeline:
    """Transforms + final model as ONE portable scoring artifact
    (reference: ``MojoPipelineBuilder`` assembling main + generated-column
    sub-mojos)."""

    def __init__(self, transforms: list[Transform], model=None):
        self.transforms = list(transforms)
        self.model = model

    def transform(self, frame: Frame) -> Frame:
        for t in self.transforms:
            frame = t.apply(frame)
        return frame

    def predict(self, frame: Frame) -> Frame:
        fr = self.transform(frame)
        if self.model is None:
            return fr
        return self.model.predict(fr)

    # -- artifact round-trip -------------------------------------------------

    def save(self, path: str) -> str:
        """Zip with pipeline.json (+ the model's own MOJO v2 when present)."""
        import os
        spec = dict(format="h2o3_tpu/mojo-pipeline", version=1,
                    transforms=[t.spec() for t in self.transforms])
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("pipeline.json", json.dumps(spec, indent=1))
            if self.model is not None:
                from h2o3_tpu_torch.genmodel.mojo import write_mojo
                tmp = path + ".model.tmp"
                write_mojo(self.model, tmp)
                z.write(tmp, "model.mojo")
                os.unlink(tmp)
        return path

    @staticmethod
    def load(path: str, device: str | torch.device | None = None
             ) -> "MojoPipeline":
        """Load a pipeline of either package; its model onto ``device``
        (the card unless asked)."""
        with zipfile.ZipFile(path) as z:
            spec = json.loads(z.read("pipeline.json"))
            if spec.get("format") != "h2o3_tpu/mojo-pipeline":
                raise ValueError(f"{path} is not a mojo-pipeline artifact")
            model = None
            if "model.mojo" in z.namelist():
                import os
                import tempfile
                from h2o3_tpu_torch.genmodel.mojo import MojoModel
                with tempfile.NamedTemporaryFile(suffix=".zip",
                                                 delete=False) as f:
                    f.write(z.read("model.mojo"))
                    tmp = f.name
                try:
                    model = MojoModel.load(tmp, device=device)
                finally:
                    os.unlink(tmp)
        return MojoPipeline([Transform.from_spec(t)
                             for t in spec["transforms"]], model)
