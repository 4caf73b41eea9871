"""Isolation forest and extended isolation forest in the port
(h2o3_tpu_torch/models/isofor.py) against the JAX reference
(``h2o3_tpu/models/isofor.py``) on the same numpy-seeded frames.

Both packages grow their trees on the host from
``np.random.default_rng(seed)`` over the same float32 subsamples, so the
forests are held bit for bit. Scores within rtol 1e-6: axis-parallel trees
compare float32 values with float32 thresholds in both; the extended
trees' projections are float32 sums in both, in XLA's order in the
reference and feature by feature in the port, so a row on a hyperplane to
within float32 rounding could take the other side (none does on these
frames). ``ModelBuilder``
trains them with ``y=None``.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models import isofor as jiso
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import isofor as piso


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


def iso_cols(n=3000, F=6, seed=61):
    """Normal rows with a few far outliers, some values missing, and a
    categorical column."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[:30] *= 6.0
    X[rng.random((n, F)) < 0.03] = np.nan
    cols = {f"x{i}": X[:, i] for i in range(F)}
    cols["c"] = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)]
    return cols


@pytest.fixture(scope="module")
def frames():
    cols = iso_cols()
    return cols, JFrame.from_arrays(cols), Frame.from_arrays(cols)


def _rtol(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("params", [dict(ntrees=12, seed=3),
                                    dict(ntrees=6, sample_size=100,
                                         max_depth=5, seed=-1)])
def test_isolation_forest_equals_reference(frames, params):
    cols, jf, pf = frames
    jm = jiso.IsolationForest(**params).train(training_frame=jf)
    pm = piso.IsolationForest(**params).train(training_frame=pf)
    assert pm.training_metrics is None and pm.output["x_cols"] == \
        jm.output["x_cols"]
    for jt, pt in zip(jm.output["trees"], pm.output["trees"]):
        for k in ("feat", "thresh_bin", "thresh_val", "na_left", "is_split",
                  "leaf"):
            a, b = np.asarray(getattr(jt, k)), getattr(pt, k).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("min_path_length", "max_path_length"):
        assert pm.output[k] == jm.output[k]
    n = pf.nrows
    jp, pp = jm.predict(jf), pm.predict(pf)
    assert pp.names == ["predict", "mean_length"]
    for c in pp.names:
        _rtol(pp.vec(c).to_numpy(), jp.vec(c).to_numpy()[:n])
    # the outliers score as the most anomalous
    assert pp.vec("predict").to_numpy()[:30].mean() > \
        pp.vec("predict").to_numpy()[30:].mean() + 0.2


@pytest.mark.parametrize("ext", [0, 3, 6])
def test_extended_isolation_forest_equals_reference(frames, ext):
    cols, jf, pf = frames
    params = dict(ntrees=15, sample_size=128, extension_level=ext, seed=5)
    jm = jiso.ExtendedIsolationForest(**params).train(training_frame=jf)
    pm = piso.ExtendedIsolationForest(**params).train(training_frame=pf)
    for k in ("normals", "offsets", "is_split", "leaf"):
        a, b = np.asarray(jm.output[k]), pm.output[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert pm.output["cn"] == jm.output["cn"]
    n = pf.nrows
    jp, pp = jm.predict(jf), pm.predict(pf)
    assert pp.names == ["anomaly_score", "mean_length"]
    for c in pp.names:
        _rtol(pp.vec(c).to_numpy(), jp.vec(c).to_numpy()[:n])


def test_rows_chunked_score_alike(frames, monkeypatch):
    _, _, pf = frames
    pm = piso.ExtendedIsolationForest(ntrees=5, sample_size=64,
                                      extension_level=2).train(
        training_frame=pf)
    whole = pm.predict(pf).vec("mean_length").to_numpy()
    monkeypatch.setattr(piso, "_CHUNK_ENTRIES", 7 * 300)
    np.testing.assert_array_equal(pm.predict(pf).vec("mean_length")
                                  .to_numpy(), whole)


def test_the_fit_copies_only_the_subsamples(frames, monkeypatch):
    """The fit copies to the host the drawn rows of each tree, and nothing
    else of the frame."""
    _, _, pf = frames
    copied = []
    real = piso._IsoForBase._subsample

    def counting(X, valid, size, rng):
        out = real(X, valid, size, rng)
        copied.append(out.shape)
        return out

    monkeypatch.setattr(piso._IsoForBase, "_subsample",
                        staticmethod(counting))
    piso.IsolationForest(ntrees=4, sample_size=50).train(training_frame=pf)
    assert copied == [(50, 7)] * 4


def test_weights_and_refusals(frames):
    cols, jf, pf = frames
    n = pf.nrows
    w = np.ones(n, np.float32)
    w[::3] = 0.0
    wcols = dict(cols, w=w)
    params = dict(ntrees=5, seed=9, weights_column="w")
    jm = jiso.IsolationForest(**params).train(
        training_frame=JFrame.from_arrays(wcols))
    pm = piso.IsolationForest(**params).train(
        training_frame=Frame.from_arrays(wcols))
    for jt, pt in zip(jm.output["trees"], pm.output["trees"]):
        assert np.array_equal(np.asarray(jt.thresh_val), pt.thresh_val.numpy())
    assert pm.output["min_path_length"] == jm.output["min_path_length"]
    with pytest.raises(ValueError, match="extension_level"):
        piso.ExtendedIsolationForest(extension_level=7).train(
            training_frame=pf)
    with pytest.raises(ValueError, match="unknown parameters"):
        piso.ExtendedIsolationForest(max_depth=4)
    with pytest.raises(ValueError, match="categorical response"):
        piso.IsolationForest(ntrees=2).train(y="c", training_frame=pf)


def test_reference_forests_score_through_convert(frames):
    cols, jf, pf = frames
    n = pf.nrows
    jm = jiso.IsolationForest(ntrees=8, seed=4).train(training_frame=jf)
    o = dict(jm.output, trees=[
        {k: np.asarray(getattr(t, k)) for k in
         ("feat", "thresh_bin", "thresh_val", "na_left", "is_split", "leaf")}
        for t in jm.output["trees"]])
    cm = convert.isolation_forest_model(o, device="cpu")
    for c in ("predict", "mean_length"):
        _rtol(cm.predict(pf).vec(c).to_numpy(),
              jm.predict(jf).vec(c).to_numpy()[:n])
    je = jiso.ExtendedIsolationForest(ntrees=8, extension_level=2,
                                      seed=4).train(training_frame=jf)
    ce = convert.extended_isolation_forest_model(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in je.output.items()}, device="cpu")
    for c in ("anomaly_score", "mean_length"):
        _rtol(ce.predict(pf).vec(c).to_numpy(),
              je.predict(jf).vec(c).to_numpy()[:n])
