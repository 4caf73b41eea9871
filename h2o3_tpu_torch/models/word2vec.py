"""Word2Vec — word embeddings from a tokenized text column — the port of
``h2o3_tpu/models/word2vec.py``.

Reference: ``hex/word2vec/Word2Vec.java`` (skip-gram, hierarchical softmax;
``WordCountTask`` builds the vocabulary) and h2o-py's
``H2OWord2vecEstimator`` (train on a string column, ``find_synonyms``,
``transform(aggregate_method="AVERAGE")``).

The host pass (:func:`word_pairs`) builds the vocabulary, subsamples
frequent words and lists the (center, context) pairs of every window, as
the reference's Python loop does, in numpy: the same pairs in the same
order from the same ``np.random.default_rng`` draws (one ``random()`` a
token in the vocabulary, in corpus order; then one ``integers`` draw,
which seeds the vectors, and one ``permutation`` an epoch). An epoch is a
host loop of minibatch steps on the device: for each step a gather of the
center and context rows, a batched dot product and ``index_add_`` of the
updates (duplicates summed, as the reference's scatter-add does). The
default objective is skip-gram with negative sampling (:func:`_sgns_epoch`;
the negatives of an epoch drawn from a ``torch.Generator`` seeded from the
builder's seed, or injected); ``objective="hsm"`` is the reference's
hierarchical softmax over Huffman paths padded to one length
(:func:`_hsm_epoch`). The vectors' initial values come from the same
generator (:func:`_init_vectors`), so the port's vectors are its own, not
JAX's: tests inject the reference's initial matrix and negatives.
"""

from __future__ import annotations

import math
import time
from collections import Counter

import numpy as np
import torch

from h2o3_tpu_torch.device import resolve_device
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.types import VecType
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models.job import Job
from h2o3_tpu_torch.models.model_base import Model, ModelBuilder, make_model_key
from h2o3_tpu_torch.utils.registry import DKV


def _is_na(t) -> bool:
    return t is None or (isinstance(t, float) and math.isnan(t))


def word_rng(params: dict) -> np.random.Generator:
    """The host generator of a fit (seed -1, or 0, takes the reference's
    7919)."""
    seed = int(params.get("seed") or -1)
    return np.random.default_rng(seed if seed >= 0 else 7919)


def word_pairs(tokens, params: dict, rng: np.random.Generator | None = None):
    """The host pass of a fit: ``(centers, contexts, vocab, counts)``.

    ``tokens``: one token a row, a missing row closing each sentence.
    ``vocab`` holds the words of at least ``min_word_freq`` occurrences,
    sorted; ``counts`` their occurrences. Each token in the vocabulary is
    kept with probability ``min(1, (sqrt(c / (s T)) + 1) s T / c)`` (``c``
    its word's count, ``T`` the vocabulary's, ``s`` ``sent_sample_rate``;
    1 at s = 0, one draw a token all the same), and each kept token pairs
    with the kept tokens within ``window_size`` of it in its sentence, in
    the reference's order (center by center, contexts left to right)."""
    rng = word_rng(params) if rng is None else rng
    tokens = np.asarray(tokens, dtype=object)
    na = np.fromiter((_is_na(t) for t in tokens), bool, len(tokens))
    words = [str(t) for t in tokens[~na]]
    counter = Counter(words)
    minf = int(params["min_word_freq"])
    vocab = sorted(w for w, c in counter.items() if c >= minf)
    if not vocab:
        raise ValueError(f"no words reach min_word_freq={minf}")
    index = {w: i for i, w in enumerate(vocab)}
    counts = np.array([counter[w] for w in vocab], np.int64)
    ids = np.fromiter((index.get(w, -1) for w in words), np.int64,
                      len(words))
    # sentence of each non-missing token: missing rows before it
    sent = np.cumsum(na)[~na]
    inv = ids >= 0
    ids, sent = ids[inv], sent[inv]
    samp = float(params["sent_sample_rate"])
    if samp > 0:
        st = samp * float(counts.sum())
        c = counts.astype(np.float64)
        keep_p = np.minimum(1.0, (np.sqrt(c / st) + 1) * st / c)
    else:
        keep_p = np.ones(len(vocab))
    keep = rng.random(len(ids)) < keep_p[ids]
    kid, ksent = ids[keep], sent[keep]
    win = int(params["window_size"])
    offs = np.r_[np.arange(-win, 0), np.arange(1, win + 1)]
    pos = np.arange(len(kid))[:, None] + offs[None, :]
    ok = (pos >= 0) & (pos < len(kid))
    pos = np.clip(pos, 0, max(len(kid) - 1, 0))
    ok &= ksent[pos] == ksent[:, None]
    centers = np.broadcast_to(kid[:, None], pos.shape)[ok].astype(np.int32)
    contexts = kid[pos][ok].astype(np.int32)
    if not len(centers):
        raise ValueError("no training pairs (corpus too small for the "
                         "window)")
    return centers, contexts, vocab, counts


def _huffman_paths(freqs: np.ndarray):
    """Huffman tree over the vocabulary (reference
    ``buildHuffmanBinaryTree``): per word the inner-node path and binary
    code, padded to the tree's depth so an HSM step has one shape.
    Returns (nodes [V, L] int32, codes [V, L] f32, mask [V, L] f32)."""
    import heapq

    V = len(freqs)
    heap = [(float(f), i) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    parent = np.full(2 * V - 1, -1, np.int64)
    bit = np.zeros(2 * V - 1, np.int8)
    nxt = V
    while len(heap) > 1:
        f1, a = heapq.heappop(heap)
        f2, b = heapq.heappop(heap)
        parent[a], parent[b] = nxt, nxt
        bit[b] = 1
        heapq.heappush(heap, (f1 + f2, nxt))
        nxt += 1
    paths, codes = [], []
    for w in range(V):
        p, c, n = [], [], w
        while parent[n] >= 0:
            p.append(parent[n] - V)       # inner-node id in [0, V-1)
            c.append(float(bit[n]))
            n = parent[n]
        paths.append(p[::-1])
        codes.append(c[::-1])
    L = max(len(p) for p in paths)
    nodes = np.zeros((V, L), np.int32)
    code = np.zeros((V, L), np.float32)
    mask = np.zeros((V, L), np.float32)
    for w in range(V):
        k = len(paths[w])
        nodes[w, :k] = paths[w]
        code[w, :k] = codes[w]
        mask[w, :k] = 1.0
    return nodes, code, mask


def _init_vectors(V: int, D: int, gen: torch.Generator) -> torch.Tensor:
    """The word vectors' initial values, uniform in [-0.5, 0.5) / D."""
    return (torch.rand((V, D), generator=gen, device=gen.device) - 0.5) / D


def _negative_draws(noise_cdf: torch.Tensor, nb: int, B: int, n_neg: int,
                    gen: torch.Generator) -> torch.Tensor:
    """An epoch's negatives [nb, B, n_neg]: uniform draws looked up in the
    noise distribution's cumulative sums."""
    u = torch.rand((nb, B, n_neg), generator=gen, device=noise_cdf.device)
    return torch.searchsorted(noise_cdf, u)


def _sgns_epoch(Wc, Wx, centers, contexts, noise_cdf, gen, lr: float,
                n_neg: int, negatives=None):
    """One epoch of skip-gram negative-sampling SGD, in place.

    Wc, Wx: [V, D] center and context vectors; centers, contexts: [nb, B]
    pair minibatches; noise_cdf: [V] cumulative unigram^0.75 distribution.
    ``negatives`` ([nb, B, n_neg] word ids) replaces the epoch's draws from
    ``gen``. An id past the vocabulary (a draw above the last cumulative
    sum) reads the last word and updates nothing, as the reference's
    clamped gather and dropped scatter do."""
    nb, B = centers.shape
    V, D = Wc.shape
    if negatives is None:
        negatives = _negative_draws(noise_cdf, nb, B, n_neg, gen)
    negatives = negatives.to(Wc.device, torch.long)
    # (one fetch an epoch) draws past the vocabulary are rare: masked only
    # where there are any
    inside = ((negatives < V).to(Wc.dtype)[..., None]
              if bool((negatives >= V).any()) else None)
    negatives = negatives.clamp(max=V - 1)
    centers = centers.to(Wc.device, torch.long)
    contexts = contexts.to(Wc.device, torch.long)
    for i in range(nb):
        c, x, neg = centers[i], contexts[i], negatives[i]
        vc, ux, un = Wc[c], Wx[x], Wx[neg]          # [B, D], [B, n, D]
        s_pos = torch.sigmoid((vc * ux).sum(1))
        s_neg = torch.sigmoid(torch.bmm(un, vc[:, :, None])[..., 0])
        g_pos = (s_pos - 1.0)[:, None]               # d/ds of -log sigmoid
        d_vc = g_pos * ux + torch.bmm(s_neg[:, None, :], un)[:, 0]
        d_ux = g_pos * vc
        d_un = s_neg[..., None] * vc[:, None, :]
        if inside is not None:
            d_un = d_un * inside[i]
        Wc.index_add_(0, c, d_vc, alpha=-lr)
        Wx.index_add_(0, x, d_ux, alpha=-lr)
        Wx.index_add_(0, neg.reshape(-1), d_un.reshape(-1, D), alpha=-lr)
    return Wc, Wx


def _hsm_epoch(Wc, Wn, centers, contexts, nodes, codes, mask, lr: float):
    """One epoch of skip-gram hierarchical-softmax SGD, in place
    (reference ``WordVectorTrainer.java:114-168``): each (center, context)
    pair updates the context word's Huffman path (padded to length L,
    masked). Wc: [V, D] word vectors; Wn: [V-1, D] inner-node vectors."""
    nb, B = centers.shape
    D = Wc.shape[1]
    centers = centers.to(Wc.device, torch.long)
    contexts = contexts.to(Wc.device, torch.long)
    nodes = nodes.to(Wc.device, torch.long)
    for i in range(nb):
        c, x = centers[i], contexts[i]
        pn, pc, pm = nodes[x], codes[x], mask[x]    # [B, L]
        vc, un = Wc[c], Wn[pn]                      # [B, D], [B, L, D]
        s = torch.sigmoid(torch.bmm(un, vc[:, :, None])[..., 0])
        g = (s - pc) * pm                           # d/dθ of -log p(code)
        d_vc = torch.bmm(g[:, None, :], un)[:, 0]
        d_un = g[..., None] * vc[:, None, :]
        Wc.index_add_(0, c, d_vc, alpha=-lr)
        Wn.index_add_(0, pn.reshape(-1), d_un.reshape(-1, D), alpha=-lr)
    return Wc, Wn


def epoch_batches(centers: np.ndarray, contexts: np.ndarray, B: int,
                  rng: np.random.Generator, device):
    """An epoch's minibatches [nb, B] of the pairs in the order of one
    ``rng.permutation`` (the remainder past nb * B is left out), on
    ``device``."""
    perm = rng.permutation(len(centers))
    nb = len(centers) // B
    cb = torch.as_tensor(centers[perm][:nb * B].reshape(nb, B)).to(device)
    xb = torch.as_tensor(contexts[perm][:nb * B].reshape(nb, B)).to(device)
    return cb, xb


class Word2VecModel(Model):
    algo = "word2vec"

    def find_synonyms(self, word: str, count: int = 20) -> dict[str, float]:
        """The ``count`` words nearest to ``word`` by cosine similarity
        (reference: /3/Word2VecSynonyms); an unknown word has none."""
        idx = self.output["word_index"]
        if word not in idx:
            return {}
        W, i, vocab = self.output["vectors"], idx[word], self.output["vocab"]
        v = W[i]
        sims = ((W @ v) / (torch.linalg.norm(W, dim=1) * torch.linalg.norm(v)
                           + 1e-12)).cpu().numpy()
        out = {}
        for j in np.argsort(-sims):
            if j == i:
                continue
            out[vocab[j]] = float(sims[j])
            if len(out) >= count:
                break
        return out

    def transform(self, frame: Frame, aggregate_method: str = "NONE") -> Frame:
        """The words of the frame's first column as vectors (NaN outside the
        vocabulary), a row each; ``AVERAGE``: a row per sequence of
        non-missing rows, the mean of its words' vectors (NaN without one),
        a trailing missing row adding none (reference:
        ``Word2VecModel.transform`` ``AggregateMethod``)."""
        W, idx = self.output["vectors"], self.output["word_index"]
        D = W.shape[1]
        words = frame.vecs[0].host_values
        na = np.fromiter((_is_na(t) for t in words), bool, len(words))
        # each token's word id, -1 outside the vocabulary
        ids = np.fromiter((-1 if m else idx.get(str(t), -1)
                           for t, m in zip(words, na)), np.int64, len(words))
        if str(aggregate_method).upper() == "AVERAGE":
            start = ~na & np.r_[True, na[:-1]]
            doc = np.cumsum(start) - 1
            ndocs = int(start.sum())
            use = ~na & (ids >= 0)
            d_ids = torch.as_tensor(doc[use]).to(W.device)
            w_ids = torch.as_tensor(ids[use]).to(W.device)
            acc = torch.zeros((ndocs, D), dtype=torch.float64,
                              device=W.device)
            acc.index_add_(0, d_ids, W[w_ids].double())
            cnt = torch.zeros(ndocs, dtype=torch.float64, device=W.device)
            cnt.index_add_(0, d_ids, torch.ones_like(d_ids,
                                                     dtype=torch.float64))
            M = torch.where(cnt[:, None] > 0, acc / cnt[:, None].clamp(min=1),
                            torch.nan).float()
        else:
            t_ids = torch.as_tensor(ids).to(W.device)
            M = torch.where((t_ids >= 0)[:, None], W[t_ids.clamp(min=0)],
                            torch.nan)
        MT = M.T.contiguous()
        return Frame([f"C{i + 1}" for i in range(D)],
                     [Vec(MT[i], VecType.NUM) for i in range(D)])

    def to_frame(self) -> Frame:
        """The word and vector table (reference: Word2VecModel.toFrame):
        ``Word`` (categorical, as the reference's frame guesses it) and
        ``V1``..``VD``."""
        W = self.output["vectors"]
        host = W.cpu().numpy()
        cols = {"Word": np.array(self.output["vocab"], dtype=object)}
        for i in range(host.shape[1]):
            cols[f"V{i + 1}"] = host[:, i]
        return Frame.from_arrays(cols, device=W.device)

    def _score_raw(self, frame: Frame):
        raise NotImplementedError("use transform() or find_synonyms()")

    def model_performance(self, frame: Frame):
        return None


class Word2Vec(ModelBuilder):
    """h2o-py surface: ``H2OWord2vecEstimator`` (train on one string
    column of tokens)."""

    algo = "word2vec"
    unsupervised = True

    @classmethod
    def defaults(cls) -> dict:
        return dict(super().defaults(), vec_size=100, window_size=5,
                    min_word_freq=5, init_learning_rate=0.025,
                    sent_sample_rate=1e-3, epochs=5, negative_samples=5,
                    mini_batch_size=1024, word_model="SkipGram",
                    # "sgns" (skip-gram, negative sampling) or "hsm" (the
                    # reference's hierarchical softmax)
                    objective="sgns",
                    # a frame (or DKV key) of words and their vectors:
                    # column 0 the words, columns 1..D the components
                    pre_trained=None)

    def train(self, x=None, y=None, training_frame: Frame | None = None,
              device=None, **kw) -> Word2VecModel:
        """Train on the frame's first string column (or import
        ``pre_trained``) on ``device``; the model goes into the DKV."""
        dev = resolve_device(device)
        pre = self.params.get("pre_trained")
        if pre is not None:
            self.job = Job("word2vec-import")
            self.job.run(lambda job: self._from_pretrained(pre, dev))
        else:
            if training_frame is None:
                raise ValueError("training_frame is required")
            str_cols = [c for c in training_frame.names
                        if training_frame.vec(c).type is VecType.STR]
            if not str_cols:
                raise ValueError("Word2Vec requires a string column of "
                                 "tokens")
            tokens = training_frame.vec(str_cols[0]).host_values
            self.job = Job("word2vec")
            self.job.run(lambda job: self._fit_words(job, tokens, dev))
        if self.job.status == Job.FAILED:
            raise self.job.exception
        self.model = self.job.result
        DKV.put(self.model.key, self.model)
        return self.model

    def _from_pretrained(self, pre, dev) -> Word2VecModel:
        """An external embedding table as a model (reference
        ``Word2Vec.fromPretrainedModel``, ``Word2Vec.java:112-145``): column
        0 the words (STR, or categorical labels), the rest numeric
        components; ``vec_size`` is taken from the table (a vec_size other
        than the default 100 must match it)."""
        fr = pre if isinstance(pre, Frame) else DKV.get(str(pre))
        if fr is None or fr.ncols < 2:
            raise ValueError("pre_trained frame needs >= 2 columns "
                             "(words + vector components)")
        wv = fr.vecs[0]
        if wv.type is not VecType.STR and not wv.is_categorical:
            raise ValueError("pre_trained column 0 must be the STR words "
                             f"column, got {wv.type}")
        bad = [n for n, v in zip(fr.names[1:], fr.vecs[1:])
               if not v.is_numeric]
        if bad:
            raise ValueError(f"non-numeric vector components: {bad}")
        want = int(self.params.get("vec_size") or 0)
        if want not in (0, 100, fr.ncols - 1):
            raise ValueError(
                f"pre-trained frame has {fr.ncols - 1} components, "
                f"vec_size={want} specified")
        self.params["vec_size"] = fr.ncols - 1
        vocab = [str(w) for w in (wv.labels() if wv.is_categorical
                                  else wv.host_values)]
        W = torch.stack([v.data.to(dev, torch.float32) for v in fr.vecs[1:]],
                        dim=1)
        return Word2VecModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=None, response_domain=None,
            output=dict(vectors=W, vocab=vocab,
                        word_index={w: i for i, w in enumerate(vocab)},
                        vec_size=W.shape[1], epochs_run=0, n_pairs=0,
                        pre_trained=True))

    def _fit_words(self, job: Job, tokens, dev) -> Word2VecModel:
        p = self.params
        t0 = time.perf_counter()
        rng = word_rng(p)
        centers, contexts, vocab, counts = word_pairs(tokens, p, rng)
        # the host pass's pairs, kept on the builder (not the model)
        self.pairs = (centers, contexts, counts)
        V, D = len(vocab), int(p["vec_size"])
        B = min(int(p["mini_batch_size"]), len(centers))
        # the reference seeds its vector key with this draw
        gen = torch.Generator(device=dev).manual_seed(
            int(rng.integers(0, 2**31)))
        Wc = _init_vectors(V, D, gen).to(dev, torch.float32).contiguous()
        objective = str(p.get("objective", "sgns")).lower()
        if objective not in ("sgns", "hsm"):
            raise ValueError(f"objective={objective!r}: sgns or hsm")
        freq = counts.astype(np.float64)
        if objective == "hsm":
            hn, hc, hm = (torch.as_tensor(a).to(dev)
                          for a in _huffman_paths(freq))
            Wn = torch.zeros((max(V - 1, 1), D), device=dev)
        else:
            f = freq ** 0.75
            noise_cdf = torch.as_tensor(np.cumsum(f / f.sum()),
                                        dtype=torch.float32).to(dev)
            Wx = torch.zeros((V, D), device=dev)
        host_s = time.perf_counter() - t0
        lr = float(p["init_learning_rate"])
        n_epochs = max(int(p["epochs"]), 1)
        for ep in range(n_epochs):
            cb, xb = epoch_batches(centers, contexts, B, rng, dev)
            # linear decay an epoch (reference: alpha annealing), held at
            # 1e-4 / lr of the rate
            lr_e = lr * max(1.0 - ep / n_epochs, 1e-4 / lr if lr > 0 else 0.0)
            lr_e = float(np.float32(lr_e))
            if objective == "hsm":
                _hsm_epoch(Wc, Wn, cb, xb, hn, hc, hm, lr_e)
            else:
                _sgns_epoch(Wc, Wx, cb, xb, noise_cdf, gen, lr_e,
                            int(p["negative_samples"]))
            job.update((ep + 1) / n_epochs, f"epoch {ep + 1}/{n_epochs}")
        return Word2VecModel(
            key=make_model_key(self.algo, self.model_id), params=self.params,
            response_column=None, response_domain=None,
            output=dict(vectors=Wc, vocab=vocab,
                        word_index={w: i for i, w in enumerate(vocab)},
                        vec_size=D, epochs_run=n_epochs,
                        n_pairs=len(centers), n_tokens=int(len(tokens)),
                        host_pass_seconds=host_s))
