"""MOJO-style portable scoring artifacts — the port of
``h2o3_tpu/genmodel/mojo.py``, in the JAX package's format.

Reference: ``h2o-genmodel``'s MOJO, a zip of ``model.ini`` metadata and
binary payloads written by ``hex/genmodel/AbstractMojoWriter.java`` and read
by ``hex/genmodel/ModelMojoReader.java``. The artifact is the JAX
package's, member for member, so a MOJO either package writes loads and
scores in the other:

- ``model.ini`` — format and version, algorithm, model class, response
  and parameters (the same sections and keys);
- ``structure.json`` — the model's object tree, every array a
  ``{"$a": name}`` placeholder, with the markers ``$f`` (a non-finite
  float), ``$t`` (tuple), ``$d`` (dict), ``$tree``, ``$di`` and ``$model``
  and the JAX package's class and field names;
- ``arrays.npz`` — the named arrays, in the dtypes the JAX package writes.

A model's output is written in the JAX package's layout: a DeepLearning
network as ``params = {"W": [...], "b": [...]}``. The port adds one key the
JAX package's reader ignores, ``tensors``: the arrays that were tensors,
which the port's reader puts back on the device. A MOJO without it (the
JAX package's) is read through :mod:`h2o3_tpu_torch.convert`, as a model
carried across from the JAX package is.

Loading unpickles nothing: ``json`` and ``np.load(allow_pickle=False)``
only, so an artifact cannot run code. The model class comes from a
registry of the port's own ``Model`` subclasses by name, never from the
artifact. A v1 artifact (a pickle payload) is refused unless
``allow_legacy=True``.
"""

from __future__ import annotations

import configparser
import dataclasses
import io
import json
import zipfile

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device

MOJO_FORMAT = "h2o3_tpu_mojo"
MOJO_VERSION = "2.0"

_JSON_SCALARS = (bool, int, float, str, type(None))


# ---------------------------------------------------------------------------
# encode


class _Encoder:
    def __init__(self):
        self.arrays: dict[str, np.ndarray] = {}
        self.tensors: list[str] = []
        self._n = 0

    def _store(self, arr: np.ndarray) -> dict:
        from h2o3_tpu_torch.persist.model_io import TensorArray
        name = f"a{self._n}"
        self._n += 1
        if isinstance(arr, TensorArray):
            self.tensors.append(name)
        self.arrays[name] = np.asarray(arr)
        return {"$a": name}

    def encode(self, obj):
        from h2o3_tpu_torch.models.data_info import DataInfo
        from h2o3_tpu_torch.models.model_base import Model
        from h2o3_tpu_torch.models.tree import Tree

        if isinstance(obj, _JSON_SCALARS):
            if isinstance(obj, float) and not np.isfinite(obj):
                return {"$f": repr(obj)}
            return obj
        if isinstance(obj, (np.floating, np.integer, np.bool_)):
            return self.encode(obj.item())
        if isinstance(obj, np.ndarray):
            return self._store(obj)
        if isinstance(obj, Tree):
            return {"$tree": {f.name: self.encode(getattr(obj, f.name))
                              for f in dataclasses.fields(Tree)}}
        if isinstance(obj, DataInfo):
            return {"$di": {f.name: self.encode(getattr(obj, f.name))
                            for f in dataclasses.fields(DataInfo)}}
        if isinstance(obj, Model):
            return {"$model": _encode_model(obj, self)}
        if isinstance(obj, tuple):
            return {"$t": [self.encode(v) for v in obj]}
        if isinstance(obj, list):
            return [self.encode(v) for v in obj]
        if isinstance(obj, dict):
            return {"$d": {str(k): self.encode(v) for k, v in obj.items()}}
        raise TypeError(
            f"MOJO cannot serialize {type(obj).__name__}: the artifact is "
            "restricted to arrays + JSON so it loads without unpickling")


def _reference_output(model) -> dict:
    """The model's (host) output in the JAX package's layout: a
    DeepLearning network as its ``params`` of weights and biases."""
    out = dict(model.output)
    net = out.pop("net", None)
    if net is not None:
        out["params"] = {"W": list(net.W), "b": list(net.b)}
    return out


def _encode_model(model, enc: _Encoder) -> dict:
    """The scoring state of one model (metrics and cross-validation
    artifacts are training-session state, which the reference's MOJO
    leaves out too)."""
    params = {}
    for k, v in dict(model.params).items():
        try:
            params[k] = enc.encode(v)
        except TypeError:
            continue     # callables (custom metrics), frames: not portable
    return {
        "class": type(model).__name__,
        "algo": model.algo,
        "key": model.key,
        "response_column": enc.encode(model.response_column),
        "response_domain": enc.encode(model.response_domain),
        "params": params,
        "output": enc.encode(_reference_output(model)),
        "data_info": enc.encode(model.data_info),
        "preprocessors": [_encode_model(p, enc)
                          for p in getattr(model, "preprocessors", [])],
        "scoring_history": enc.encode(model.scoring_history),
    }


# ---------------------------------------------------------------------------
# decode


def _model_classes() -> dict[str, type]:
    """Every concrete Model subclass of the port by class name (the
    loader's registry; no class is ever named by the artifact itself)."""
    import h2o3_tpu_torch.convert  # noqa: F401 — imports every builder
    import h2o3_tpu_torch.genmodel.generic  # noqa: F401
    from h2o3_tpu_torch.models.model_base import Model

    out: dict[str, type] = {}
    stack = [Model]
    while stack:
        cls = stack.pop()
        for sub in cls.__subclasses__():
            out[sub.__name__] = sub
            stack.append(sub)
    return out


def _converters() -> dict:
    """Class name → the function of :mod:`h2o3_tpu_torch.convert` that
    builds the port's model from the JAX package's output, and the
    arguments it takes besides ``output``."""
    from h2o3_tpu_torch import convert as cv
    sup = ("response_column", "response_domain", "params")
    di_sup = ("data_info",) + sup
    return {
        "GBMModel": (cv.gbm_model, sup),
        "XGBoostModel": (cv.xgboost_model, sup),
        "DRFModel": (cv.drf_model, sup),
        "DecisionTreeModel": (cv.decision_tree_model, sup),
        "UpliftDRFModel": (cv.uplift_model, sup),
        "IsolationForestModel": (cv.isolation_forest_model, ("params",)),
        "ExtendedIsolationForestModel": (cv.extended_isolation_forest_model,
                                         ("params",)),
        "GLMModel": (cv.glm_model, di_sup),
        "DeepLearningModel": (cv.deeplearning_model, di_sup),
        "KMeansModel": (cv.kmeans_model, ("data_info", "params")),
        "PCAModel": (cv.pca_model, ("data_info", "params")),
        "SVDModel": (cv.svd_model, ("data_info", "params")),
        "GLRMModel": (cv.glrm_model, ("data_info", "params")),
        "NaiveBayesModel": (cv.naive_bayes_model, sup),
        "IsotonicRegressionModel": (cv.isotonic_model,
                                    ("response_column", "params")),
        "CoxPHModel": (cv.coxph_model,
                       ("data_info", "response_column", "params")),
        "HGLMModel": (cv.hglm_model,
                      ("data_info", "response_column", "params")),
        "PSVMModel": (cv.psvm_model, di_sup),
        "RuleFitModel": (cv.rulefit_model, sup),
        "TargetEncoderModel": (cv.target_encoder_model,
                               ("response_column", "params")),
        "Word2VecModel": (cv.word2vec_model, ("params",)),
    }


class _Decoder:
    """Builds the port's models from a structure: with ``tensors`` (a
    MOJO the port wrote) every such array onto ``device`` and the model
    whole; without (the JAX package's) through :mod:`~h2o3_tpu_torch.
    convert`."""

    def __init__(self, arrays, tensors, device: torch.device):
        self.arrays = arrays
        self.tensors = None if tensors is None else set(tensors)
        self.device = device
        self.classes = _model_classes()

    @property
    def ported(self) -> bool:
        return self.tensors is not None

    def decode(self, obj):
        from h2o3_tpu_torch.models.data_info import DataInfo
        from h2o3_tpu_torch.models.tree import Tree

        if isinstance(obj, _JSON_SCALARS):
            return obj
        if isinstance(obj, list):
            return [self.decode(v) for v in obj]
        if not isinstance(obj, dict):
            raise ValueError(f"corrupt structure node: {obj!r}")
        if "$a" in obj:
            arr = self.arrays[obj["$a"]]
            if self.ported and obj["$a"] in self.tensors:
                return torch.as_tensor(arr).to(self.device)
            return arr
        if "$f" in obj:
            return float(obj["$f"])
        if "$t" in obj:
            return tuple(self.decode(v) for v in obj["$t"])
        if "$d" in obj:
            return {k: self.decode(v) for k, v in obj["$d"].items()}
        if "$tree" in obj:
            fields = {k: self.decode(v) for k, v in obj["$tree"].items()}
            return Tree(**fields) if self.ported else fields
        if "$di" in obj:
            fields = {k: self.decode(v) for k, v in obj["$di"].items()}
            return DataInfo(**fields) if self.ported else fields
        if "$model" in obj:
            return self.decode_model(obj["$model"])
        raise ValueError(f"unknown structure marker in {list(obj)[:3]}")

    def decode_model(self, spec: dict):
        cls = self.classes.get(spec["class"])
        if cls is None:
            raise ValueError(f"artifact needs unknown model class "
                             f"{spec['class']!r}; the port has no such "
                             "model")
        fields = dict(
            params={k: self.decode(v) for k, v in spec["params"].items()},
            response_column=self.decode(spec["response_column"]),
            response_domain=self.decode(spec["response_domain"]),
            data_info=self.decode(spec["data_info"]))
        output = self.decode(spec["output"])
        m = (self._ported_model(cls, output, fields) if self.ported
             else self._carried_model(spec["class"], output, fields))
        m.key = spec["key"]
        m.scoring_history = self.decode(spec.get("scoring_history"))
        m.preprocessors = [self.decode_model(p)
                           for p in spec.get("preprocessors", [])]
        return m

    def _ported_model(self, cls, output: dict, fields: dict):
        """A model the port wrote, whole: its state as written, the
        DeepLearning network rebuilt from its weights."""
        params = output.get("params")
        if isinstance(params, dict) and "W" in params and "act" in output:
            from h2o3_tpu_torch.models.deeplearning import MLP
            output = {k: v for k, v in output.items() if k != "params"}
            net = MLP(list(params["W"]), list(params["b"]), output["act"])
            for prm in net.parameters():
                prm.requires_grad_(False)
            output["net"] = net
        m = cls.__new__(cls)        # no __init__: the state comes whole
        m.params = dict(fields["params"])
        m.response_column = fields["response_column"]
        m.response_domain = fields["response_domain"]
        m.data_info = fields["data_info"]
        m.output = output
        m.training_metrics = m.validation_metrics = None
        m.cross_validation_metrics = None
        m.cv_holdout_predictions = m.cv_holdout_mask = None
        m.cv_metrics_summary = None
        m.run_time_ms = 0
        return m

    def _carried_model(self, name: str, output: dict, fields: dict):
        """A model the JAX package wrote, through :mod:`~h2o3_tpu_torch.
        convert`."""
        if name == "StackedEnsembleModel":
            from h2o3_tpu_torch.convert import stacked_ensemble_model
            return stacked_ensemble_model(
                output, output["base_models"], output["metalearner"],
                fields["response_column"], fields["response_domain"],
                fields["params"], self.device)
        conv = _converters().get(name)
        if conv is None:
            raise ValueError(f"a {name} artifact of the JAX package is not "
                             "carried into the port")
        fn, args = conv
        return fn(output, *(fields[a] for a in args), device=self.device)


# ---------------------------------------------------------------------------
# public surface


def write_mojo(model, path: str) -> str:
    """Export a model as a portable artifact (h2o-py: ``download_mojo``)."""
    from h2o3_tpu_torch.persist.model_io import host_copy

    m = host_copy(model)
    enc = _Encoder()
    structure = _encode_model(m, enc)
    structure["tensors"] = enc.tensors

    ini = configparser.ConfigParser()
    ini["info"] = {
        "format": MOJO_FORMAT,
        "version": MOJO_VERSION,
        "algorithm": model.algo,
        "model_class": type(model).__name__,
        "model_key": model.key,
        "response_column": str(model.response_column),
        "n_classes": str(model.nclasses),
        "n_arrays": str(len(enc.arrays)),
    }
    ini["columns"] = {"response_domain":
                      json.dumps(list(model.response_domain or []))}
    ini["parameters"] = {k: json.dumps(v, default=str)
                         for k, v in dict(model.params).items()
                         if isinstance(v, (int, float, str, bool, type(None),
                                           list, tuple))}
    buf = io.StringIO()
    ini.write(buf)
    npz = io.BytesIO()
    np.savez_compressed(npz, **enc.arrays)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.ini", buf.getvalue())
        z.writestr("structure.json", json.dumps(structure))
        z.writestr("arrays.npz", npz.getvalue())
    return path


class MojoModel:
    """Standalone scorer over an imported artifact (reference:
    ``hex.genmodel.MojoModel``): the port's model, on the chosen device,
    with no DKV registration and no training state."""

    def __init__(self, inner, info: dict):
        self._inner = inner
        self.info = info
        self.algo = info.get("algorithm", inner.algo)

    @staticmethod
    def load(path: str, allow_legacy: bool = False,
             device: str | torch.device | None = None) -> "MojoModel":
        """Load a MOJO of either package onto ``device`` (the card unless
        asked)."""
        dev = resolve_device(device)
        with zipfile.ZipFile(path) as z:
            ini = configparser.ConfigParser()
            ini.read_string(z.read("model.ini").decode())
            if ini["info"].get("format") != MOJO_FORMAT:
                raise ValueError(f"{path} is not a {MOJO_FORMAT} artifact")
            if "payload.bin" in z.namelist():     # v1 pickle payload
                if not allow_legacy:
                    raise ValueError(
                        f"{path} is a v1 pickle-payload artifact; loading "
                        "executes arbitrary code. Re-export it with this "
                        "build, or pass allow_legacy=True if you trust the "
                        "source")
                import pickle

                from h2o3_tpu_torch.persist.model_io import to_device
                inner = to_device(pickle.loads(z.read("payload.bin")), dev)
                return MojoModel(inner, dict(ini["info"]))
            structure = json.loads(z.read("structure.json"))
            arrays = dict(np.load(io.BytesIO(z.read("arrays.npz")),
                                  allow_pickle=False))
        inner = _Decoder(arrays, structure.get("tensors"),
                         dev).decode_model(structure)
        return MojoModel(inner, dict(ini["info"]))

    def predict(self, frame):
        return self._inner.predict(frame)

    def _score_raw(self, frame):
        return self._inner._score_raw(frame)

    @property
    def nclasses(self) -> int:
        return int(self.info.get("n_classes", 0))

    def __repr__(self) -> str:
        return (f"MojoModel(algo={self.algo!r}, "
                f"key={self.info.get('model_key')!r})")
