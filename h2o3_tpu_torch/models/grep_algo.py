"""Grep — regex search over a text column as a model builder — the port of
``h2o3_tpu/models/grep_algo.py``.

Reference: ``hex/grep/Grep.java``: an MRTask over byte chunks running a
regex, whose output is the matches with their offsets. The port's string
columns live on the host, so the scan is one host pass, as in the
reference; the row and offset columns of the matches frame are uploaded to
the frame's device (or the default device for a frame of host columns),
and the model goes into the DKV.
"""

from __future__ import annotations

import re

import numpy as np

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key
from h2o3_tpu_torch.utils.registry import DKV


class GrepModel(Model):
    algo = "grep"

    def model_performance(self, frame: Frame):
        return None

    @property
    def matches(self) -> Frame:
        """A row per match: ``row`` (the row it was found in), ``match``
        (its text) and ``offset`` (its start in the string)."""
        return self.output["matches"]


class Grep(ModelBuilder):
    algo = "grep"
    unsupervised = True

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), regex=".*")

    def train(self, x=None, y=None, training_frame: Frame | None = None,
              device=None, **kw) -> GrepModel:
        """Search column ``x`` (a name, or a list whose first name is
        taken; the frame's first column by default)."""
        if training_frame is None:
            raise ValueError("training_frame is required")
        col = (x[0] if isinstance(x, (list, tuple)) else x) \
            or training_frame.names[0]
        dev = (resolve_device(device) if device is not None
               or all(v.data is None for v in training_frame.vecs)
               else training_frame.device)
        self.job = Job(f"grep on {col}")
        self.job.run(lambda j: self._grep(j, training_frame, col, dev))
        if self.job.status == Job.FAILED:
            raise self.job.exception
        self.model = self.job.result
        DKV.put(self.model.key, self.model)
        return self.model

    def _grep(self, job: Job, frame: Frame, col: str, dev) -> GrepModel:
        rx = re.compile(str(self.params["regex"]))
        v = frame.vec(col)
        if v.is_categorical:
            vals = v.labels()
        elif v.type is VecType.STR:
            vals = v.host_values
        else:
            raise ValueError("grep requires a string or categorical column")
        rows, matches, offsets = [], [], []
        for i, s in enumerate(vals):
            if s is None:
                continue
            for m in rx.finditer(s):
                rows.append(float(i))
                matches.append(m.group(0))
                offsets.append(float(m.start()))
        out = Frame(["row", "match", "offset"],
                    [Vec.from_numpy(np.asarray(rows, np.float32), device=dev),
                     Vec(None, VecType.STR,
                         host_values=np.array(matches, dtype=object)),
                     Vec.from_numpy(np.asarray(offsets, np.float32),
                                    device=dev)])
        job.update(1.0, f"{len(matches)} matches")
        return GrepModel(key=make_model_key(self.algo, self.model_id),
                         params=self.params, response_column=None,
                         response_domain=None, output=dict(matches=out))
