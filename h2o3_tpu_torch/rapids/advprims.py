"""``tokenize`` — the one function of ``h2o3_tpu/rapids/advprims.py`` this
slice ports (reference: ``AstTokenize``), the Word2Vec ingest format. The
rest of the reference's advanced primitives are not ported yet.
"""

from __future__ import annotations

import re

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec


def tokenize(frame: Frame, split: str) -> Frame:
    """One token a row, in a host string column ``token``: each string of
    each column (column by column) split on the regex ``split``, empty
    tokens dropped, and a missing row after every string (a missing string
    gives the missing row alone), which closes the document."""
    rx = re.compile(split)
    toks: list = []
    for v in frame.vecs:
        vals = v.labels() if v.is_categorical else v.host_values
        for s in vals:
            if s is not None:
                toks.extend(t for t in rx.split(str(s)) if t)
            toks.append(None)
    return Frame(["token"], [Vec(None, VecType.STR,
                                 host_values=np.array(toks, dtype=object))])
