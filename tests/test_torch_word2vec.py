"""Word2Vec in the port (``h2o3_tpu_torch/models/word2vec.py``) against the
JAX package's (``h2o3_tpu/models/word2vec.py``), on toy corpora of a few
hundred tokens:

- ``word_pairs`` gives the pairs the reference's ``_fit_words`` builds, in
  its order (recorded from its epoch function with one minibatch of every
  pair, and its permutation undone), with and without subsampling; the
  draws after the host pass (the vectors' seed, each epoch's permutation)
  are the reference's too;
- ``_huffman_paths`` equal;
- one HSM epoch and one SGNS epoch from the same initial matrices, with
  the reference's negatives (re-drawn here from its key splits), within
  rtol 1e-4 plus atol 1e-6 (float32 sums in another order);
- whole fits with the reference's initial matrix and negatives injected,
  within rtol 1e-3 plus atol 1e-5 after two epochs;
- a JAX model converted (``convert.word2vec_model``): ``find_synonyms``,
  ``transform`` (NONE, AVERAGE, a trailing missing row) and ``to_frame``
  alike; ``pre_trained`` import and its errors;
- the reference's topic test (tests/test_survival_text.py:121) over three
  seeds of the port's own random streams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as JFrame
from h2o3_tpu.frame.types import VecType as JType
from h2o3_tpu.models import word2vec as jw
from h2o3_tpu_torch import convert, set_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.models import word2vec as pw
from h2o3_tpu_torch.utils.registry import DKV
from jax_reference import _jax_compile_cache  # noqa: F401

TOPICS = [["cat", "dog", "pet", "fur", "paw"],
          ["car", "bus", "road", "wheel", "fuel"],
          ["ünï", "cödé", "tëxt"]]


@pytest.fixture(autouse=True, scope="module")
def _cpu_port():
    """The port on the CPU, torch on 2 threads (6 test workers share 8
    cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    set_device("cpu")
    yield
    set_device(None)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clear_port_dkv():
    yield
    DKV.clear()


def corpus(n_sent=60, seed=0, rare=True, lead_na=False):
    """Tokens of ``n_sent`` sentences of 2-8 words of one topic each, a
    missing row after each (and some doubled), a few rare words."""
    rng = np.random.default_rng(seed)
    toks = [None] if lead_na else []
    for s in range(n_sent):
        t = TOPICS[rng.integers(0, len(TOPICS))]
        toks += [t[rng.integers(0, len(t))]
                 for _ in range(rng.integers(2, 9))]
        if rare and s % 7 == 0:
            toks.append(f"rare{s}")
        toks.append(None)
        if s % 11 == 0:
            toks.append(None)
    return np.array(toks, dtype=object)


def frames(toks):
    return (JFrame.from_arrays({"w": toks}, types={"w": JType.STR}),
            Frame.from_arrays({"w": toks}, types={"w": VecType.STR}))


class _Recording:
    """A numpy Generator that records its permutations."""

    def __init__(self, g):
        self.g, self.perms, self.ints = g, [], []

    def random(self, *a):
        return self.g.random(*a)

    def integers(self, *a, **kw):
        v = self.g.integers(*a, **kw)
        self.ints.append(int(v))
        return v

    def permutation(self, n):
        p = self.g.permutation(n)
        self.perms.append(p)
        return p


def reference_pairs(monkeypatch, toks, params):
    """The reference's (centers, contexts) in build order, its recorded
    generator, and its vocabulary: one minibatch of every pair, recorded
    from its epoch function with the permutation undone."""
    rec = {}
    real = np.random.default_rng

    def rng(seed):
        rec["rng"] = _Recording(real(seed))
        return rec["rng"]

    def sgns(Wc, Wx, cb, xb, *a, **kw):
        rec.setdefault("batches", []).append((np.asarray(cb),
                                              np.asarray(xb)))
        return Wc, Wx

    monkeypatch.setattr(jw.np.random, "default_rng", rng)
    monkeypatch.setattr(jw, "_sgns_epoch", sgns)
    jf, _ = frames(toks)
    m = jw.Word2Vec(**params, mini_batch_size=10**9).train(training_frame=jf)
    monkeypatch.undo()
    perm = rec["rng"].perms[0]
    cb, xb = rec["batches"][0]
    centers = np.empty(len(perm), np.int32)
    contexts = np.empty(len(perm), np.int32)
    centers[perm], contexts[perm] = cb.ravel(), xb.ravel()
    return centers, contexts, rec["rng"], m.output["vocab"]


PAIR_CASES = [dict(window_size=2, min_word_freq=2, sent_sample_rate=0.0),
              dict(window_size=3, min_word_freq=1, sent_sample_rate=0.05),
              dict(window_size=5, min_word_freq=3, sent_sample_rate=1e-3,
                   seed=9),
              dict(window_size=1, min_word_freq=2, sent_sample_rate=0.2,
                   seed=0)]


@pytest.mark.parametrize("params", PAIR_CASES,
                         ids=["no_sampling", "sampling", "wide", "seed0"])
def test_word_pairs_equal_the_references(monkeypatch, params):
    toks = corpus(lead_na=params["window_size"] == 3)
    p = dict(params, vec_size=4, epochs=2)
    jc, jx, jrng, jvocab = reference_pairs(monkeypatch, toks, p)
    rng = pw.word_rng(dict(pw.Word2Vec.defaults(), **p))
    c, x, vocab, counts = pw.word_pairs(
        toks, dict(pw.Word2Vec.defaults(), **p), rng)
    assert vocab == jvocab
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(x, jx)
    words = [t for t in toks if t is not None]
    assert counts.tolist() == [words.count(w) for w in vocab]
    # the generator continues as the reference's: the vectors' seed, then
    # one permutation an epoch
    assert int(rng.integers(0, 2**31)) == jrng.ints[0]
    np.testing.assert_array_equal(rng.permutation(len(c)), jrng.perms[0])


def test_word_pairs_refusals():
    p = dict(pw.Word2Vec.defaults(), min_word_freq=100)
    with pytest.raises(ValueError, match="min_word_freq"):
        pw.word_pairs(corpus(), p)
    with pytest.raises(ValueError, match="no training pairs"):
        pw.word_pairs(np.array(["a", None, "b", None], dtype=object),
                      dict(pw.Word2Vec.defaults(), min_word_freq=1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_huffman_paths_equal(seed):
    freqs = np.random.default_rng(seed).integers(1, 50, 37).astype(float)
    for a, b in zip(jw._huffman_paths(freqs), pw._huffman_paths(freqs)):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == a.dtype


def _epoch_inputs(seed=3, V=23, D=8, nb=6, B=16):
    rng = np.random.default_rng(seed)
    Wc = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
    W2 = (rng.normal(size=(V, D)) * 0.05).astype(np.float32)
    cb = rng.integers(0, V, (nb, B)).astype(np.int32)
    xb = rng.integers(0, V, (nb, B)).astype(np.int32)
    counts = rng.integers(1, 40, V).astype(np.float64)
    return Wc, W2, cb, xb, counts


def test_one_hsm_epoch_equals_reference():
    """rtol 1e-4, atol 1e-6: the same updates, float32 sums in another
    order."""
    Wc, W2, cb, xb, counts = _epoch_inputs()
    hn, hc, hm = jw._huffman_paths(counts)
    Wn = W2[:len(counts) - 1]
    jWc, jWn = jw._hsm_epoch(jnp.asarray(Wc), jnp.asarray(Wn),
                             jnp.asarray(cb), jnp.asarray(xb),
                             jnp.asarray(hn), jnp.asarray(hc),
                             jnp.asarray(hm), jnp.float32(0.05))
    pWc, pWn = torch.tensor(Wc), torch.tensor(Wn)
    pw._hsm_epoch(pWc, pWn, torch.tensor(cb), torch.tensor(xb),
                  torch.tensor(hn), torch.tensor(hc), torch.tensor(hm),
                  float(np.float32(0.05)))
    np.testing.assert_allclose(pWc.numpy(), np.asarray(jWc), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(pWn.numpy(), np.asarray(jWn), rtol=1e-4,
                               atol=1e-6)
    assert not np.allclose(pWc.numpy(), Wc)


def reference_negatives(key, noise_cdf, nb: int, B: int, n_neg: int):
    """The negatives the reference's ``_sgns_epoch`` draws from ``key``:
    a split a step, a uniform draw looked up in the noise CDF."""
    out = []
    for _ in range(nb):
        key, nk = jax.random.split(key)
        u = jax.random.uniform(nk, (B, n_neg))
        out.append(np.asarray(jnp.searchsorted(noise_cdf, u)))
    return np.stack(out).astype(np.int64)


def test_sgns_epoch_with_injected_negatives_equals_reference():
    """One epoch from the same matrices with the reference's negatives:
    rtol 1e-4, atol 1e-6."""
    Wc, Wx, cb, xb, counts = _epoch_inputs(seed=4)
    f = counts ** 0.75
    cdf = jnp.asarray(np.cumsum(f / f.sum()), jnp.float32)
    key = jax.random.PRNGKey(17)
    jWc, jWx = jw._sgns_epoch(jnp.asarray(Wc), jnp.asarray(Wx),
                              jnp.asarray(cb), jnp.asarray(xb), cdf, key,
                              jnp.float32(0.05), 3)
    neg = reference_negatives(key, cdf, cb.shape[0], cb.shape[1], 3)
    pWc, pWx = torch.tensor(Wc), torch.tensor(Wx)
    pw._sgns_epoch(pWc, pWx, torch.tensor(cb), torch.tensor(xb),
                   torch.tensor(np.asarray(cdf)), None,
                   float(np.float32(0.05)), 3, negatives=torch.tensor(neg))
    np.testing.assert_allclose(pWc.numpy(), np.asarray(jWc), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(pWx.numpy(), np.asarray(jWx), rtol=1e-4,
                               atol=1e-6)


def test_negatives_past_the_vocabulary_update_nothing():
    """An id past the vocabulary (a draw above the last cumulative sum)
    reads the last word and adds nothing, as the reference's clamped
    gather and dropped scatter."""
    Wc, Wx, cb, xb, counts = _epoch_inputs(seed=5, nb=1)
    V = Wc.shape[0]
    cdf = torch.tensor(np.cumsum(counts / counts.sum()), dtype=torch.float32)
    neg = torch.full((1, cb.shape[1], 2), V)
    a = [torch.tensor(Wc), torch.tensor(Wx)]
    pw._sgns_epoch(*a, torch.tensor(cb), torch.tensor(xb), cdf, None, 0.05,
                   2, negatives=neg)
    b = [torch.tensor(Wc), torch.tensor(Wx)]
    pw._sgns_epoch(*b, torch.tensor(cb), torch.tensor(xb), cdf, None, 0.05,
                   2, negatives=torch.full_like(neg, V - 1))
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert not torch.equal(a[1], b[1])   # b's last row took negative updates
    keep = torch.arange(V) != V - 1
    torch.testing.assert_close(a[1][keep], b[1][keep], rtol=0, atol=0)


def inject_reference_streams(monkeypatch):
    """The port's initial vectors and negatives drawn as the reference
    draws them, from the seed the port's generator carries."""
    state = {}

    def init(V, D, gen):
        key = jax.random.PRNGKey(gen.initial_seed())
        state["key"] = key
        return torch.tensor(np.asarray(
            (jax.random.uniform(key, (V, D), jnp.float32) - 0.5) / D))

    def draws(noise_cdf, nb, B, n_neg, gen):
        state["key"], ek = jax.random.split(state["key"])
        cdf = jnp.asarray(noise_cdf.cpu().numpy())
        return torch.tensor(reference_negatives(ek, cdf, nb, B, n_neg))

    monkeypatch.setattr(pw, "_init_vectors", init)
    monkeypatch.setattr(pw, "_negative_draws", draws)


@pytest.mark.parametrize("objective", ["sgns", "hsm"])
def test_whole_fit_with_injected_streams_equals_reference(monkeypatch,
                                                           objective):
    """Two epochs at B = 32: vectors within rtol 1e-3 plus atol 1e-5."""
    toks = corpus(n_sent=50, seed=6)
    p = dict(vec_size=8, window_size=2, min_word_freq=2, epochs=2,
             mini_batch_size=32, sent_sample_rate=0.0, seed=3,
             objective=objective, negative_samples=3)
    jf, pf = frames(toks)
    jm = jw.Word2Vec(**p).train(training_frame=jf)
    inject_reference_streams(monkeypatch)
    builder = pw.Word2Vec(**p)
    pm = builder.train(training_frame=pf)
    assert pm.output["vocab"] == jm.output["vocab"]
    assert pm.output["n_pairs"] == jm.output["n_pairs"]
    np.testing.assert_allclose(pm.output["vectors"].numpy(),
                               np.asarray(jm.output["vectors"]), rtol=1e-3,
                               atol=1e-5)
    assert DKV.get(pm.key) is pm
    assert builder.job.progress == 1.0
    assert builder.job.progress_msg == "epoch 2/2"


@pytest.fixture(scope="module")
def trained():
    """A JAX model of the toy corpus and its conversion."""
    toks = corpus(n_sent=80, seed=8)
    jf, pf = frames(toks)
    jm = jw.Word2Vec(vec_size=6, min_word_freq=2, epochs=3, window_size=2,
                     seed=5).train(training_frame=jf)
    out = dict(jm.output)
    out["vectors"] = np.asarray(out["vectors"])
    pm = convert.word2vec_model(out, params=jm.params, device="cpu")
    return toks, jf, pf, jm, pm


def test_converted_model_keeps_vectors_and_counters(trained):
    _, _, _, jm, pm = trained
    np.testing.assert_array_equal(pm.output["vectors"].numpy(),
                                  np.asarray(jm.output["vectors"]))
    for k in ("vocab", "word_index", "vec_size", "epochs_run", "n_pairs"):
        assert pm.output[k] == jm.output[k], k


@pytest.mark.parametrize("word", ["cat", "road", "cödé", "absent"])
def test_find_synonyms_equal_reference(trained, word):
    """The same neighbours in the same order, similarities at rtol 1e-5."""
    *_, jm, pm = trained
    js, ps = jm.find_synonyms(word, 5), pm.find_synonyms(word, 5)
    assert list(ps) == list(js)
    np.testing.assert_allclose(list(ps.values()), list(js.values()),
                               rtol=1e-5)


@pytest.mark.parametrize("method", ["NONE", "AVERAGE", "average"])
@pytest.mark.parametrize("trailing", [True, False])
def test_transform_equals_reference(trained, method, trailing):
    """NONE: a row a token (NaN for missing and unknown words); AVERAGE: a
    row a sequence (no extra row for a trailing missing row); float32
    exactly (the averages are float64 sums of float32 vectors)."""
    toks, _, _, jm, pm = trained
    toks = np.array(list(toks) + ["zzz", "cat", "zzz"]
                    + ([None] if trailing else []), dtype=object)
    jf, pf = frames(toks)
    jt, pt = jm.transform(jf, method), pm.transform(pf, method)
    assert pt.names == jt.names and pt.nrows == jt.nrows
    for n in jt.names:
        np.testing.assert_array_equal(pt.vec(n).to_numpy(),
                                      np.asarray(jt.vec(n).to_numpy())[
                                          :jt.nrows])


def test_to_frame_equals_reference(trained):
    *_, jm, pm = trained
    jt, pt = jm.to_frame(), pm.to_frame()
    assert pt.names == jt.names and pt.types == jt.types
    assert list(pt.vec("Word").labels()) == \
        list(jt.vec("Word").labels()[:jt.nrows])
    for n in jt.names[1:]:
        np.testing.assert_array_equal(pt.vec(n).to_numpy(),
                                      np.asarray(jt.vec(n).to_numpy())[
                                          :jt.nrows])


def test_pre_trained_import_and_errors(trained):
    """A word table (STR or categorical words) imports as a model whose
    vectors are the table's; the reference's refusals, by message."""
    *_, jm, pm = trained
    W = pm.output["vectors"].numpy()
    cols = {"w": np.array(pm.output["vocab"], dtype=object)}
    cols.update({f"v{i}": W[:, i] for i in range(W.shape[1])})
    for t in (VecType.STR, VecType.CAT):
        fr = Frame.from_arrays(cols, types={"w": t})
        DKV.put("table", fr)
        m = pw.Word2Vec(pre_trained="table").train()
        np.testing.assert_array_equal(m.output["vectors"].numpy(), W)
        assert m.params["vec_size"] == W.shape[1]
        assert m.find_synonyms("cat", 3) == pm.find_synonyms("cat", 3)
    fr = Frame.from_arrays(cols, types={"w": VecType.STR})
    with pytest.raises(ValueError, match="vec_size=3 specified"):
        pw.Word2Vec(pre_trained=fr, vec_size=3).train()
    with pytest.raises(ValueError, match=">= 2 columns"):
        pw.Word2Vec(pre_trained=Frame.from_arrays(
            {"w": cols["w"]}, types={"w": VecType.STR})).train()
    with pytest.raises(ValueError, match="column 0"):
        pw.Word2Vec(pre_trained=Frame.from_arrays(
            {"n": W[:, 0], "v": W[:, 1]})).train()
    bad = dict(cols, v0=np.array(["x"] * len(W), dtype=object))
    with pytest.raises(ValueError, match="non-numeric"):
        pw.Word2Vec(pre_trained=Frame.from_arrays(
            bad, types={"w": VecType.STR})).train()
    with pytest.raises(ValueError, match="string column"):
        pw.Word2Vec().train(training_frame=Frame.from_arrays(
            {"n": W[:, 0]}))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_topics_are_learned(seed):
    """The reference's topic test (tests/test_survival_text.py:121) on the
    port's own streams: the synonyms of "cat" are its topic's words."""
    rng = np.random.default_rng(42)
    topics = TOPICS[:2]
    words = []
    for _ in range(300):
        t = topics[rng.integers(0, 2)]
        words += [t[rng.integers(0, len(t))]
                  for _ in range(rng.integers(4, 9))] + [None]
    pf = Frame.from_arrays({"words": np.array(words, dtype=object)},
                           types={"words": VecType.STR})
    m = pw.Word2Vec(vec_size=16, min_word_freq=2, epochs=25, window_size=3,
                    seed=seed).train(training_frame=pf)
    syn = m.find_synonyms("cat", 3)
    assert len(syn) == 3 and set(syn) <= {"dog", "pet", "fur", "paw"}
