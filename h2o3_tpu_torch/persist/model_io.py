"""Binary model save and load — the port of ``h2o3_tpu/persist/model_io.py``.

Reference: ``hex/Model`` binary export through ``water/api/ModelsHandler``
(the whole model object serialised). The model's object graph (params,
DataInfo, output, metrics) is copied with every ``torch.Tensor`` turned
into host numpy (:func:`host_copy`) and pickled behind a magic line of the
port's own. A host array that was a tensor is a :class:`TensorArray`, so
:func:`load_model` knows which arrays go back onto the device; a
DeepLearning network (an ``nn.Module``) travels as its weights. One file,
whatever device the model was trained on.

A binary model of the JAX package pickles that package's classes: the port
refuses it by its magic line and points to the MOJO route
(:mod:`h2o3_tpu_torch.genmodel.mojo`), which both packages read. Saves
and loads count their file's bytes into ``h2o3_persist_write_bytes`` and
``h2o3_persist_read_bytes`` (``what="model"``).
"""

from __future__ import annotations

import copy
import os
import pickle

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.utils import telemetry as _tm

_MAGIC = b"h2o3_tpu_torch-model-v1\n"
#: the JAX package's binary models start with this line
_REFERENCE_MAGIC = b"h2o3_tpu-model-v1\n"


class TensorArray(np.ndarray):
    """A host copy of a ``torch.Tensor``: a numpy array that remembers it
    was a tensor (and whether an ``nn.Parameter``)."""

    parameter = False

    def __reduce__(self):
        return (_tensor_array, (np.asarray(self), self.parameter))


def _tensor_array(arr: np.ndarray, parameter: bool = False) -> TensorArray:
    out = np.asarray(arr).view(TensorArray)
    out.parameter = bool(parameter)
    return out


class HostMLP:
    """A DeepLearning network on the host: its weights ``W``, biases ``b``
    (as :class:`TensorArray`) and activation."""

    def __init__(self, W: list, b: list, act: str):
        self.W, self.b, self.act = W, b, act


def _to_host(obj, memo: dict, depth: int = 0):
    if depth > 16:
        return obj
    if id(obj) in memo:
        return memo[id(obj)]
    from h2o3_tpu_torch.models.deeplearning import MLP
    if isinstance(obj, torch.Tensor):
        out = _tensor_array(obj.detach().cpu().numpy().copy(),
                            isinstance(obj, torch.nn.Parameter))
    elif isinstance(obj, MLP):
        out = HostMLP([_to_host(w, memo, depth + 1) for w in obj.W],
                      [_to_host(b, memo, depth + 1) for b in obj.b], obj.act)
    elif isinstance(obj, dict):
        out = type(obj)() if type(obj) is not dict else {}
        memo[id(obj)] = out
        for k, v in obj.items():
            out[k] = _to_host(v, memo, depth + 1)
        return out
    elif isinstance(obj, (list, tuple)):
        items = [_to_host(v, memo, depth + 1) for v in obj]
        out = items if type(obj) is list else (
            type(obj)(*items) if hasattr(obj, "_fields") else type(obj)(items))
    elif hasattr(obj, "__dict__") and not isinstance(obj, type) \
            and not callable(obj):
        out = copy.copy(obj)
        memo[id(obj)] = out
        for k, v in vars(obj).items():
            setattr(out, k, _to_host(v, memo, depth + 1))
        return out
    else:
        return obj
    memo[id(obj)] = out
    return out


def host_copy(model):
    """A copy of ``model`` with every tensor turned into host numpy (a
    :class:`TensorArray`) — the one serialisable form shared by binary saves
    and MOJO payloads. The live model is not touched."""
    return _to_host(model, {})


def _to_device(obj, dev: torch.device, memo: dict, depth: int = 0):
    """The inverse of :func:`host_copy`, in place where it can be: every
    :class:`TensorArray` back to a tensor on ``dev``."""
    if depth > 16:
        return obj
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, TensorArray):
        t = torch.as_tensor(np.array(obj)).to(dev)
        out = torch.nn.Parameter(t, requires_grad=False) if obj.parameter \
            else t
    elif isinstance(obj, HostMLP):
        from h2o3_tpu_torch.models.deeplearning import MLP
        out = MLP([_to_device(w, dev, memo, depth + 1) for w in obj.W],
                  [_to_device(b, dev, memo, depth + 1) for b in obj.b],
                  obj.act)
        for prm in out.parameters():
            prm.requires_grad_(False)
    elif isinstance(obj, dict):
        memo[id(obj)] = obj
        for k, v in obj.items():
            obj[k] = _to_device(v, dev, memo, depth + 1)
        return obj
    elif isinstance(obj, list):
        memo[id(obj)] = obj
        obj[:] = [_to_device(v, dev, memo, depth + 1) for v in obj]
        return obj
    elif isinstance(obj, tuple):
        items = [_to_device(v, dev, memo, depth + 1) for v in obj]
        out = type(obj)(*items) if hasattr(obj, "_fields") else \
            type(obj)(items)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type) \
            and not callable(obj):
        memo[id(obj)] = obj
        for k, v in vars(obj).items():
            setattr(obj, k, _to_device(v, dev, memo, depth + 1))
        return obj
    else:
        return obj
    memo[id(obj)] = out
    return out


def to_device(obj, device: str | torch.device | None = None):
    """``obj`` (a :func:`host_copy`) with its arrays back on ``device``."""
    return _to_device(obj, resolve_device(device), {})


def save_model(model, path: str) -> str:
    """Write a binary model file; returns the path (h2o-py:
    ``h2o.save_model``). The live model's ``artifact_file_bytes`` is set
    to the file's size."""
    m = host_copy(model)
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        pickle.dump(m, fh, protocol=pickle.HIGHEST_PROTOCOL)
    model.artifact_file_bytes = os.path.getsize(path)
    _tm.PERSIST_WRITE_BYTES.labels(what="model").inc(
        model.artifact_file_bytes)
    return path


def load_model(path: str, device: str | torch.device | None = None):
    """Load a saved model onto ``device`` (the card unless asked) and put it
    into the port's DKV under its key (h2o-py: ``h2o.load_model``)."""
    dev = resolve_device(device)
    with open(path, "rb") as fh:
        head = fh.read(len(_MAGIC))
        if head != _MAGIC:
            if head.startswith(_REFERENCE_MAGIC):
                raise ValueError(
                    f"{path} is a binary model of the JAX package "
                    "(h2o3_tpu), which pickles that package's classes; "
                    "export it there with write_mojo (download_mojo) and "
                    "load the MOJO here with MojoModel.load or import_mojo")
            raise ValueError(f"{path} is not a saved model")
        m = pickle.load(fh)
    m = _to_device(m, dev, {})
    m.artifact_file_bytes = os.path.getsize(path)
    _tm.PERSIST_READ_BYTES.labels(what="model").inc(m.artifact_file_bytes)
    from h2o3_tpu_torch.utils.registry import DKV
    DKV.put(m.key, m)
    return m
