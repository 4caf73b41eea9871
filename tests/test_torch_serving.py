"""The port's scoring tier (``h2o3_tpu_torch/serving/``) on the CPU: the
scenarios of ``tests/test_serving.py`` run on the port, and carried models
scored through both packages' ``ScoringService``.

- Batched results equal the port's own ``Model.predict`` bit for bit,
  also across ``MAX_BUCKET`` slicing and under 16 concurrent threads; the
  second same-shape request captures nothing (cache hit counter); a budget
  below both models evicts the cold one and keeps serving the hot one,
  503 + retry under contention, never an OOM.
- A GBM and a binomial GLM trained by the JAX package and carried into the
  port with ``convert`` score the same JSON rows through both
  ``ScoringService`` instances within rtol 1e-5 / atol 1e-6, with the same labels.
- On the CPU every scorer is ``"eager"``: the device is the CPU, and the
  cache's stats count it (a graph is captured on the card only:
  ``tests/test_torch_serving_card.py``).
"""

import threading

import numpy as np
import pytest
import torch
from test_torch_carry import carry

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.models.gbm import GBM as JGBM
from h2o3_tpu.models.glm import GLM as JGLM
from h2o3_tpu.serving import SCORING as JSCORING
from h2o3_tpu.utils.registry import DKV as JDKV
from h2o3_tpu_torch import set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.serving import (SCORING, NotServable, ServiceUnavailable,
                                    bucket_for, serving_schema)
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8 cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _reset_scoring():
    SCORING.reset()
    SCORING.budget_bytes = None
    yield
    SCORING.reset()
    SCORING.budget_bytes = None
    DKV.clear()


@pytest.fixture
def frame(rng):
    n = 400
    X = rng.normal(size=(n, 3)).astype(np.float32)
    cols = {f"x{i}": X[:, i] for i in range(3)}
    cols["c"] = np.array(["a" if v > 0 else "b" for v in X[:, 2]],
                         dtype=object)
    cols["y"] = np.where(X[:, 0] - X[:, 1] > 0, "yes", "no")
    fr = Frame.from_arrays(cols, key="serve_frame")
    DKV.put("serve_frame", fr)
    return fr


@pytest.fixture
def gbm(frame):
    from h2o3_tpu_torch.models.gbm import GBM
    return GBM(ntrees=4, max_depth=3, seed=7,
               model_id="serve_gbm").train(y="y", training_frame=frame)


@pytest.fixture
def glm(frame):
    from h2o3_tpu_torch.models.glm import GLM
    return GLM(family="binomial", lambda_=1e-4,
               model_id="serve_glm").train(y="y", training_frame=frame)


def _rows(frame, n, start=0):
    names = [c for c in frame.names if c != "y"]
    pdf = frame[names].to_pandas().iloc[start:start + n]
    return [{k: (v if isinstance(v, str) else float(v))
             for k, v in rec.items()}
            for rec in pdf.to_dict(orient="records")]


class TestSchemaAndBuckets:
    def test_bucket_for_powers_of_two(self):
        assert bucket_for(1) == 8 and bucket_for(8) == 8
        assert bucket_for(9) == 16 and bucket_for(100) == 128
        from h2o3_tpu_torch.serving.scorer import MAX_BUCKET
        assert bucket_for(10 ** 9) == MAX_BUCKET

    def test_schema_tree_and_datainfo_paths(self, gbm, glm):
        st = serving_schema(gbm)
        assert st.cat_cols == ["c"] and set(st.num_cols) == {"x0", "x1", "x2"}
        sg = serving_schema(glm)
        assert sg.cat_cols == ["c"] and sg.domains["c"] == ("a", "b")

    def test_frame_is_not_servable(self, frame):
        with pytest.raises((NotServable, KeyError)):
            SCORING.score("serve_frame", [{"x0": 1.0}])

    def test_rows_as_lists_need_all_columns(self, gbm):
        schema = serving_schema(gbm)
        with pytest.raises(ValueError, match="lack model columns"):
            schema.adapt_rows([[1.0, 2.0]], columns=["x0", "x1"])


class TestBitIdentical:
    def test_batched_equals_predict(self, frame, gbm, glm):
        """/3/Score results must be bit-identical to the frame path."""
        rows = _rows(frame, 17)
        names = [c for c in frame.names if c != "y"]
        sub = Frame(names, [frame.vec(c) for c in names])
        for model in (gbm, glm):
            out = SCORING.score(model.key, rows)["predictions"]
            pred = model.predict(sub)
            got_p = np.asarray(out["pyes"], dtype=np.float32)
            want_p = np.asarray(pred.vec("pyes").to_numpy())[:17]
            assert np.array_equal(got_p, want_p), model.algo
            want_lbl = [str(v) for v in pred.vec("predict").labels()[:17]]
            assert out["predict"] == want_lbl

    def test_second_same_shape_request_hits_cache(self, frame, gbm):
        rows = _rows(frame, 5)
        SCORING.score(gbm.key, rows)
        stats0 = SCORING.cache.stats()
        assert stats0["misses"] >= 1
        SCORING.score(gbm.key, _rows(frame, 5, start=50))
        stats1 = SCORING.cache.stats()
        assert stats1["misses"] == stats0["misses"], \
            "second same-signature request must capture nothing"
        assert stats1["hits"] == stats0["hits"] + 1

    def test_cpu_scorers_are_eager_and_counted(self, frame, gbm, glm):
        """On the CPU nothing is captured: every scorer reads "eager"
        because its device is the CPU, with no capture error, and the
        stats count them."""
        for m in (gbm, glm):
            SCORING.score(m.key, _rows(frame, 3))
        st = SCORING.stats()
        assert st["cache"]["eager"] == 2 and st["cache"]["graph"] == 0
        for key in (gbm.key, glm.key):
            (row,) = st["modes"][key]
            assert row == {"bucket": 8, "mode": "eager", "capture_s": 0.0,
                           "error": None}

    def test_oversized_request_slices_through_max_bucket(self, frame, gbm,
                                                         monkeypatch):
        import h2o3_tpu_torch.serving.batcher as batcher_mod
        monkeypatch.setattr(batcher_mod, "MAX_BUCKET", 16)
        rows = _rows(frame, 40)
        out = SCORING.score(gbm.key, rows)
        assert len(out["predictions"]["predict"]) == 40
        names = [c for c in frame.names if c != "y"]
        pred = gbm.predict(Frame(names, [frame.vec(c) for c in names]))
        want = np.asarray(pred.vec("pyes").to_numpy())[:40]
        assert np.array_equal(
            np.asarray(out["predictions"]["pyes"], np.float32), want)

    def test_missing_and_unseen_values_score(self, frame, gbm):
        out = SCORING.score(gbm.key, [
            {"x0": 1.0, "x1": None, "x2": 0.5, "c": "a"},
            {"x0": 0.0, "x1": 2.0, "x2": -1.0, "c": "NEVER_SEEN"},
            {"x1": 1.0},
        ])
        assert len(out["predictions"]["predict"]) == 3

    def test_out_of_range_enum_code_treated_as_na(self, gbm):
        """A raw code past the domain is an UNSEEN value → NA, identical to
        an unknown label — never silently clamped to a training level."""
        schema = serving_schema(gbm)
        _num, cat = schema.adapt_rows([{"c": 7}, {"c": -5}, {"c": 1},
                                       {"c": "NOPE"}])
        assert cat[:, 0].tolist() == [-1, -1, 1, -1]

    def test_mixed_row_kinds_are_400_not_500(self, frame, gbm):
        with pytest.raises(ValueError, match="malformed"):
            SCORING.score(gbm.key, [{"x0": 1.0}, [1.0, 2.0, 3.0, 0]])

    def test_timed_out_request_withdraws_from_queue(self, frame, gbm,
                                                    monkeypatch):
        """A caller that gave up must not leave its rows behind to be
        dispatched anyway (overload amplification)."""
        import h2o3_tpu_torch.serving.batcher as bm
        monkeypatch.setattr(bm, "SCORE_TIMEOUT_S", 0.05)
        entry = SCORING._admit(gbm.key)
        entry.batcher._window = 0.5          # hold the batch open (10x the wait)
        try:
            with pytest.raises(ServiceUnavailable):
                SCORING.score(gbm.key, _rows(frame, 2))
            with entry.batcher._cond:
                assert entry.batcher._queue == []
        finally:
            entry.batcher._window = bm.window_s_from_env()
        monkeypatch.setattr(bm, "SCORE_TIMEOUT_S", 30.0)
        assert SCORING.score(gbm.key, _rows(frame, 2))["rows"] == 2


class TestConcurrency:
    def test_thread_pool_coalesces_and_slices_correctly(self, frame, gbm):
        """16 concurrent clients: every reply is that client's own rows
        (sliced out of shared batches) and at least one dispatch carried
        more than one request."""
        SCORING.score(gbm.key, _rows(frame, 4))           # warm the bucket
        nthreads, per = 16, 4
        outs: list = [None] * nthreads
        errs: list = []
        ready = threading.Barrier(nthreads)

        def work(i):
            try:
                ready.wait()
                outs[i] = SCORING.score(gbm.key, _rows(frame, per, start=i * per))
            except Exception as e:   # noqa: BLE001 — collected for the assert
                errs.append(e)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        names = [c for c in frame.names if c != "y"]
        pred = gbm.predict(Frame(names, [frame.vec(c) for c in names]))
        all_p = np.asarray(pred.vec("pyes").to_numpy())
        for i, out in enumerate(outs):
            got = np.asarray(out["predictions"]["pyes"], np.float32)
            assert np.array_equal(got, all_p[i * per:(i + 1) * per]), i
        assert max(o["batch_requests"] for o in outs) > 1, \
            "no dispatch coalesced concurrent requests"

    def test_stress_more_threads_than_cores(self, frame, gbm, glm):
        """32 threads, a short switch interval: every reply is its own
        rows bit for bit, and the counters no lost update may break hold
        (one latency sample a request in each model's ring, one cache
        lookup a dispatched bucket)."""
        import sys
        names = [c for c in frame.names if c != "y"]
        sub = Frame(names, [frame.vec(c) for c in names])
        want = {m.key: m.predict(sub).vec("pyes").to_numpy()
                for m in (gbm, glm)}
        errs, bad = [], []

        def work(i):
            try:
                for j in range(4):
                    m = (gbm, glm)[(i + j) % 2]
                    start = (7 * i + 3 * j) % 380
                    out = SCORING.score(m.key, _rows(frame, 3, start=start))
                    got = np.asarray(out["predictions"]["pyes"], np.float32)
                    if not np.array_equal(got, want[m.key][start:start + 3]):
                        bad.append((i, j))
            except Exception as e:   # noqa: BLE001 — asserted below
                errs.append(e)

        prev = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(prev)
        assert not any(t.is_alive() for t in threads)
        assert not errs and not bad, (errs[:2], bad[:5])
        st = SCORING.stats()
        assert sum(r["slo"]["samples"] for r in st["resident"]) == 128
        assert st["cache"]["hits"] + st["cache"]["misses"] >= 2

    def test_multi_model_residency_serves_both(self, frame, gbm, glm):
        rows = _rows(frame, 3)
        outs = {}

        def work(key):
            outs[key] = SCORING.score(key, rows)

        threads = [threading.Thread(target=work, args=(k,))
                   for k in (gbm.key, glm.key, gbm.key, glm.key)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert set(outs) == {gbm.key, glm.key}
        resident = {r["model"] for r in SCORING.stats()["resident"]}
        assert resident == {gbm.key, glm.key}


class TestResidency:
    def test_forced_low_watermark_evicts_cold_keeps_hot(self, frame, gbm,
                                                        glm):
        """Budget below both artifacts: the cold model is LRU-evicted, the
        hot one keeps serving, and nothing OOMs."""
        rows = _rows(frame, 4)
        SCORING.score(glm.key, rows)
        glm_bytes = SCORING.stats()["resident"][0]["bytes"]
        from h2o3_tpu_torch.utils.memory import value_kind_bytes
        gbm_bytes = value_kind_bytes(gbm)[1]
        SCORING.budget_bytes = max(glm_bytes, gbm_bytes) + 64   # fits one
        SCORING.score(gbm.key, rows)                  # admits gbm, evicts glm
        st = SCORING.stats()
        assert [r["model"] for r in st["resident"]] == [gbm.key]
        assert st["evictions"] == 1
        # hot model keeps serving after the eviction
        assert len(SCORING.score(gbm.key, rows)["predictions"]["predict"]) == 4
        # the evicted model re-admits (evicting the other right back)
        assert len(SCORING.score(glm.key, rows)["predictions"]["predict"]) == 4

    def test_model_bigger_than_budget_is_terminal_400(self, frame, gbm):
        SCORING.budget_bytes = 16            # can never fit: 400, not a
        with pytest.raises(NotServable):     # 503 a retrier loops on forever
            SCORING.score(gbm.key, _rows(frame, 2))

    def test_contention_returns_503_retry_not_oom(self, frame, gbm, glm):
        from h2o3_tpu_torch.utils.memory import value_kind_bytes
        rows = _rows(frame, 2)
        SCORING.score(glm.key, rows)                    # glm resident
        glm_entry = SCORING._resident[glm.key]
        gbm_bytes = value_kind_bytes(gbm)[1]
        SCORING.budget_bytes = gbm_bytes + 64           # gbm fits ALONE
        with glm_entry.batcher._cond:
            glm_entry.batcher._dispatching = True       # glm is mid-batch
        try:
            with pytest.raises(ServiceUnavailable) as ei:
                SCORING.score(gbm.key, rows)            # can't evict busy glm
            assert ei.value.retry_after_ms > 0
        finally:
            with glm_entry.batcher._cond:
                glm_entry.batcher._dispatching = False
        SCORING.score(gbm.key, rows)                    # idle glm evicts now

    def test_infeasible_admission_evicts_nothing(self, frame, gbm, glm):
        """When eviction can never make room, the 503 must not destroy the
        working residents' warm signatures on the way out."""
        from h2o3_tpu_torch.utils.memory import value_kind_bytes
        rows = _rows(frame, 2)
        SCORING.score(glm.key, rows)
        glm_entry = SCORING._resident[glm.key]
        with glm_entry.batcher._cond:
            glm_entry.batcher._dispatching = True       # busy: not evictable
        gbm_bytes = value_kind_bytes(gbm)[1]
        SCORING.budget_bytes = gbm_bytes + 64           # glm + gbm never fit
        try:
            with pytest.raises(ServiceUnavailable):
                SCORING.score(gbm.key, rows)
            assert [r["model"] for r in SCORING.stats()["resident"]] \
                == [glm.key], "infeasible admission must evict nothing"
        finally:
            with glm_entry.batcher._cond:
                glm_entry.batcher._dispatching = False

    def test_eviction_drops_compiled_signatures(self, frame, gbm):
        SCORING.score(gbm.key, _rows(frame, 4))
        assert SCORING.cache.stats()["signatures"] == 1
        assert SCORING.evict(gbm.key) is True
        assert SCORING.cache.stats()["signatures"] == 0

    def test_eviction_race_retries_transparently(self, frame, gbm):
        """A request that finds its batcher stopped (eviction won the race
        between admit and submit) must re-admit and succeed — never a
        client-visible server error."""
        entry = SCORING._admit(gbm.key)
        entry.batcher.stop()                 # simulate the racing eviction
        out = SCORING.score(gbm.key, _rows(frame, 3))
        assert len(out["predictions"]["predict"]) == 3

    def test_stale_resident_refreshes_after_reput(self, frame, gbm):
        rows = _rows(frame, 3)
        first = SCORING.score(gbm.key, rows)["predictions"]["pyes"]
        from h2o3_tpu_torch.models.gbm import GBM
        retrained = GBM(ntrees=1, max_depth=2, seed=1,
                        model_id=gbm.key).train(y="y", training_frame=frame)
        out = SCORING.score(gbm.key, rows)["predictions"]["pyes"]
        pred = retrained.predict(frame)
        want = np.asarray(pred.vec("pyes").to_numpy())[:3]
        assert np.array_equal(np.asarray(out, np.float32), want)
        assert first != out


class TestRestSurface:
    @pytest.fixture
    def server(self):
        from h2o3_tpu_torch.api import H2OServer
        s = H2OServer(port=0).start()
        yield s
        s.stop()

    @pytest.fixture
    def client(self, server):
        from h2o3_tpu_torch.api import H2OClient
        return H2OClient(server.url)

    def test_rest_score_stress(self, frame, gbm, client):
        """Thread-pool clients on the real endpoint: correct slices, a
        connected root→batch→dispatch trace, metrics recorded."""
        rows = _rows(frame, 4)
        client.score(gbm.key, rows)                   # warm
        nthreads = 8
        outs: list = [None] * nthreads
        errs: list = []

        def work(i):
            try:
                outs[i] = client.score(gbm.key, _rows(frame, 4, start=4 * i))
            except Exception as e:   # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        names = [c for c in frame.names if c != "y"]
        pred = gbm.predict(Frame(names, [frame.vec(c) for c in names]))
        all_p = np.asarray(pred.vec("pyes").to_numpy())
        for i, out in enumerate(outs):
            got = np.asarray(out["predictions"]["pyes"], np.float32)
            assert np.array_equal(got, all_p[4 * i:4 * (i + 1)]), i
        # a solo request is its batch's leader: its trace carries the
        # root -> score:batch -> score:dispatch tree (followers only ride)
        client.score(gbm.key, rows)
        trace = client.trace(client.last_trace_id)
        kinds = {sp["kind"] for sp in trace["spans"]}
        assert "serving" in kinds and "dispatch" in kinds
        snap = {m["name"]: m for m in client.metrics()
                if m["name"].startswith("h2o3_score") and not m["labels"]}
        assert snap["h2o3_score_batch_size_count"]["value"] >= 1

    def test_rest_503_and_stats(self, frame, gbm, glm, client):
        SCORING.budget_bytes = 16          # bigger-than-budget → terminal 400
        with pytest.raises(RuntimeError, match="400"):
            client.score(gbm.key, _rows(frame, 2))
        SCORING.budget_bytes = None
        client.score(glm.key, _rows(frame, 2))          # glm resident...
        glm_entry = SCORING._resident[glm.key]
        from h2o3_tpu_torch.utils.memory import value_kind_bytes
        SCORING.budget_bytes = value_kind_bytes(gbm)[1] + 64
        with glm_entry.batcher._cond:
            glm_entry.batcher._dispatching = True       # ...and mid-batch
        try:
            with pytest.raises(RuntimeError, match="503"):
                client.score(gbm.key, _rows(frame, 2))  # contention → 503
        finally:
            with glm_entry.batcher._cond:
                glm_entry.batcher._dispatching = False
            SCORING.evict(glm.key)
        SCORING.budget_bytes = None
        client.score(gbm.key, _rows(frame, 2))
        st = client.serving()
        assert st["resident"][0]["model"] == gbm.key
        assert st["cache"]["misses"] >= 1
        assert client.serving_evict(gbm.key) is True
        assert client.serving()["resident"] == []

    def test_rest_unknown_model_404_bad_rows_400(self, client, frame, gbm):
        with pytest.raises(RuntimeError, match="404"):
            client.score("no_such_model", [{"x0": 1.0}])
        with pytest.raises(RuntimeError, match="400"):
            client.request("POST", f"/3/Score/{gbm.key}", {"rows": []})
        with pytest.raises(RuntimeError, match="400"):
            client.request("POST", f"/3/Score/{gbm.key}",
                           {"rows": '[{"x0":'})   # malformed JSON → 400
        with pytest.raises(RuntimeError, match="400"):
            client.score(gbm.key, [{"x0": {"nested": 1}}])   # bad cell → 400


# -- the two packages' ScoringServices on carried models ----------------------

N_CARRY = 256


@pytest.fixture(scope="module")
def carried():
    """A GBM and a binomial GLM trained by the JAX package on the same
    seeded rows, carried into the port; both packages' DKVs hold them
    under the same keys, and the rows to score (with missing values)."""
    rng = np.random.default_rng(17)
    X = rng.normal(size=(N_CARRY, 3)).astype(np.float32)
    X[::11, 1] = np.nan
    c = np.where(X[:, 2] > 0.3, "a", np.where(X[:, 2] < -0.3, "b", "z"))
    y = np.where(X[:, 0] - X[:, 1] + 0.5 * (c == "a") > 0, "yes", "no")
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
            "c": c.astype(object), "y": y}
    jf = JFrame.from_arrays(cols)
    jg = JGBM(ntrees=4, max_depth=3, seed=7, model_id="carry_gbm").train(
        y="y", training_frame=jf)
    jl = JGLM(family="binomial", lambda_=1e-4, model_id="carry_glm").train(
        y="y", training_frame=jf)
    rows = [{"x0": float(X[i, 0]),
             "x1": None if np.isnan(X[i, 1]) else float(X[i, 1]),
             "x2": float(X[i, 2]), "c": str(c[i])} for i in range(40)]
    rows[3]["c"] = "NEVER_SEEN"
    return jf, {"carry_gbm": jg, "carry_glm": jl}, rows


@pytest.mark.parametrize("key", ["carry_gbm", "carry_glm"])
def test_carried_models_score_alike_through_both_services(carried, key):
    jf, jmodels, rows = carried
    jm = jmodels[key]
    pm = carry(jm, N_CARRY)
    JDKV.put(key, jm)
    DKV.put(key, pm)
    JSCORING.reset()
    try:
        want = JSCORING.score(key, rows)
        got = SCORING.score(key, rows)
    finally:
        JSCORING.reset()
        JDKV.remove(key)
    assert set(got["predictions"]) == set(want["predictions"])
    assert got["predictions"]["predict"] == want["predictions"]["predict"]
    for col in ("pno", "pyes"):
        np.testing.assert_allclose(got["predictions"][col],
                                   want["predictions"][col],
                                   rtol=1e-5, atol=1e-6)
    assert got["rows"] == want["rows"] == len(rows)
    # and the port's batched rows are its own predict's, bit for bit
    names = ["x0", "x1", "x2", "c"]
    pf = Frame.from_arrays({n: np.array([r[n] if r[n] is not None
                                         else np.nan for r in rows],
                                        dtype=object if n == "c"
                                        else np.float32) for n in names})
    pred = pm.predict(pf)
    assert np.array_equal(np.float32(got["predictions"]["pyes"]),
                          pred.vec("pyes").to_numpy())


def test_schemas_of_carried_models_match_the_references(carried):
    from h2o3_tpu.serving import serving_schema as jschema
    _, jmodels, _ = carried
    for jm in jmodels.values():
        pm = carry(jm, N_CARRY)
        a, b = serving_schema(pm), jschema(jm)
        assert (a.names, a.cat_cols, a.num_cols) == \
            (b.names, b.cat_cols, b.num_cols)
        assert {k: tuple(v) for k, v in a.domains.items()} == \
            {k: tuple(v) for k, v in b.domains.items()}
        assert a.to_dict() == b.to_dict()
        na, ca = a.adapt_rows([{"x0": 1.5, "c": "b"}, {"x2": "2"}])
        nb, cb = b.adapt_rows([{"x0": 1.5, "c": "b"}, {"x2": "2"}])
        assert np.array_equal(na, nb, equal_nan=True)
        assert np.array_equal(ca, cb)
