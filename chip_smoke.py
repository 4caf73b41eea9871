#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``h2o3_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. the card's name and power limit, the torch and CUDA versions, the build
   of every CUDA kernel from ``h2o3_tpu_torch/csrc`` (timed), and the fixed
   kernel's machine code: native integer shared atomics (ATOMS.ADD), no
   compare-and-swap loop, 64-bit reductions for its flushes;
2. the histogram kernels held against their plain PyTorch version on the
   card at small shapes (one with every row in node 0, one with inputs
   that start off their vector alignment), at 2^14 nodes, at 257 int16
   bins, at the main path's 11M x 28 shapes (one with 11,000,003 rows), at
   the XGBoost level-0 shape (257 int16 bins) and a deep DRF level (1024
   nodes); the global kernel forced through the plan at DRF's 1024 and
   4096 nodes (11M x 28), at 2^14 nodes (1M rows), at 16 and 64 nodes of
   257 int16 bins, at 4099 rows and on offset views; then class batches
   (K = 3, w shared and per class, at small shapes, at 1024 nodes on the
   global kernel and at the 11M x 28 multinomial level-0 shape), the
   plan's own kernel at every DRF level, and a K = 1 batch against the 2-D
   call; then the fixed-point kernel forced at 257 int16 bins with 1 and
   2 nodes (small and 11M x 28), 1025 bins, 65 int8 bins at 11M x 28 in
   the layouts of levels 0, 5 and 6, the last fixed level of each bin
   count at 1.5M rows (where the plan raises qbits), K = 3 (w shared and
   per class), rows not a multiple of four, offset views, every row in one
   bin at the largest quantised value, w in [0, 1e3] and non-finite
   stats: two launches bit for bit equal, equal bit for bit to its plain
   emulation, within the tolerance of the plain version and of float64
   sums, and within its stated bound of float64 sums;
3. small models trained on the CPU (plain path) and on the card (kernels),
   which must agree on every split, on the training metric and on the
   margins: a 100k-row binomial GBM, multinomial GBM (K = 3) and XGBoost
   (256 bins), sampling off, and XGBoost at 4.5M rows (1 tree, depth 4),
   whose levels run the fixed kernel at 15 bits a value; then a 200k-row
   GBM of depth 12, whose levels of 32 to 1024 nodes run the global
   kernel, held to the metric and to the first tree's leaves on the rows
   it routes through splits alike (near-ties flip with the order of the
   sums; it prints how many heap nodes and rows agree), and trained twice
   more on the card as witnesses of what the order of the sums alone
   moves: the same plan again, and the fixed kernel at every level;
4. the main path at full width: binomial GBM on the 11M x 28 HIGGS-shaped
   frame (64 bins, depth 6, 20 trees, learn rate 0.1) trained once to warm
   up and once timed, then scored — the kernels must launch exactly as the
   plan says (120 launches, all of the fixed kernel) in the timed training
   — and once more under torch.profiler for the device's busy share and
   its costliest kernels;
5. the kernel timed at each level's shape of the main path, beside the
   first kernel's time (from PERF.md), its plain version, one
   ``index_add_`` call computing the same function, its memory bound, the
   global kernel forced, and two measurement instances of the fixed
   kernel: with its atomic adds and flushes compiled out (staging,
   quantising, listing and reading the bins) and with only its tile loads
   and stores, with the launch plan of each level;
6. the three further paths on phase 4's frame, each warmed up, timed
   (launches counted by kernel and held to the plan's), profiled and
   scored (the scored metric must equal the training one): XGBoost as
   bench.py's bench_xgboost (10 trees, depth 6, 256 bins, eta 0.3; 60
   launches: the fixed kernel at levels 0-4, the global kernel at 5),
   multinomial GBM on a 3-class label drawn from the same X (K = 3, 64
   bins, depth 6, 20 rounds; 120 launches of the fixed kernel, one per
   level for all three classes) and DRF at its defaults (50 trees, depth
   14, 64 bins, sample_rate 0.632, mtries 5; 700 launches: the fixed
   kernel at levels 0-6, the global kernel at 7-13); then the kernel
   timed at each path's level shapes as in phase 5 (multinomial and
   XGBoost levels 0-5, every DRF level from 1 to 4096 nodes), with the
   other kernel's time at each level, the first kernel's times at
   XGBoost's levels 0-2 (printed only), the global kernel's update bound,
   and the fixed kernel's two launches (scale reduction, histogram) split
   by torch.profiler;
7. the categorical path: a 10M-row airlines-shaped GBM (see
   :func:`phase_airlines`);
8. GLM (no kernel of its own: the Gram is ``torch.matmul`` at full
   float32, the solve ``torch.linalg``): (a) bench.py's bench_glm (1M x 12
   binomial, lambda 1e-4) on the CPU and on the card (iterations equal,
   coefficients within the CPU tests' tolerances, AUC within 1e-4), timed
   warm, repeated bit for bit, bit for bit with TF32 allowed, its host
   syncs counted by source line (torch's sync debug mode) and profiled;
   (b) the airlines logistic GLM at full width on phase 7's frames (P =
   668 one-hot and standardised columns, alpha 0.5, lambda 1e-5), with
   the scored metric equal to the training one, and the Gram, the
   expansion and the Cholesky timed apart, the Gram beside its 2RP^2
   bound at the card's float32 peak; (c) multinomial GLM (K = 3) on phase
   4's frame with phase 6's label, and the CPU against the card on its
   first 200k rows; (d) lambda search on (a)'s frame (alpha 0.5, 30
   lambdas) with its host syncs per lambda; (e) the CPU against the card
   at 200k rows for the other families, non_negative, beta_constraints,
   an offset, interactions, p-values, ordinal and the sparse path.

9. the rest of the tree family, each path warmed up, timed, profiled and
   scored, its launches counted by kernel and held to the plan's: (a) the
   uplift levels' kernel shapes against the plain version (14M x 12, 65
   int8 bins, K = 8 trees each with its own w: level 0 against float64
   sums, node totals at 32 nodes; two launches bit for bit) and timed at
   each level; (b) the decision tree at its defaults on
   phase 4's frame (depth 10: fixed kernel at levels 0-6, global at 7-9);
   (c) uplift DRF at the JAX package's defaults on a frame shaped as the
   Criteo Uplift Prediction Dataset v2.1 (13,979,592 x 12, 85% treated,
   visit about 4.7%; 7 batches of 8 trees), with the CPU against the card
   on one batch grown from the same weights (splits alike but at the CPU's
   exact ties) and on a whole 100k-row model (AUUC within 1e-3 of it); (d)
   DART (bench_xgboost's settings, rate_drop 0.1, skip_drop 0.5, 50
   rounds), its dropping rounds printed, and a 200k-row CPU-against-card
   fit alike at every split but ties; (e) varimp (the CPU's, from the same
   trees) and TreeSHAP of the main path's model on 1M rows (rows sum to
   the margin; 10k rows against the CPU at rtol 1e-9), timed with its
   device ops; (f) calibration (Platt and isotonic) from a 1M-row frame,
   cal_p1 within 1e-6 of the CPU's; (g) the isolation forest and the
   extended one (extension 0 and 27) fitted and scored on phase 4's
   frame, the bytes a fit copies to the host counted, and 200k-row fits
   (the extended ones' 50k) equal bit for bit to the CPU's;
10. DeepLearning and the dense unsupervised builders (no kernel of their
   own: torch operations), each timed after a warm run under
   torch.profiler (DeepLearning's: one epoch of its first 10,000 rows), with its throughput, device idle share, costliest ops
   and host syncs, and each held to the CPU on a head of its frame at the
   CPU tests' tolerances: (a)-(d) DeepLearning on bench.py's bench_dl
   frame (60,000 x 784, labels 0-9): bench_dl itself (hidden [50, 50], B
   128, 3 epochs), H2O's defaults (hidden [200, 200], B 32, 1 epoch),
   MaxoutWithDropout with momentum SGD and Nesterov, and the autoencoder
   (hidden [50], Tanh, 3 epochs) with its anomaly scores; one host sync
   inside a fit; CPU against card on 2,000 rows, one epoch, streams drawn
   on the host; (e) KMeans on phase 4's frame (k 10, Furthest, 10
   iterations) and estimate_k on its first 1M rows; (f) PCA (k 10,
   DEMEAN) and SVD (nv 10), the Gram timed beside its FLOP bound; (g)
   GLRM's exact path (k 10) on phase 4's frame and its proximal path
   (Categorical on the six enum columns, k 10, 50 iterations) on 1M rows
   of phase 7's airlines frame; (h) NaiveBayes on phase 7's 10M-row
   airlines frame.
11. the builders on GBM and GLM and the standalone solvers (no kernel of
   their own; RuleFit's and the infogram's GBMs launch the histogram
   kernels, held to the plan's count), each timed after a warm run under
   torch.profiler (for maxr and the infogram, a like part of the fit: 20
   of its GLMs, one of its GBMs) with its throughput, idle share, host
   syncs and peak memory, and held to the CPU on a head (2,000-200,000 rows) at the CPU
   tests' tolerances: (a) ModelSelection maxr to 3 of 20 predictors (1,350
   GLM fits) and ANOVAGLM on 1M rows; (b) a binomial GAM (cr, thin plate,
   I-spline) on phase 4's frame; (c) RuleFit at the JAX package's defaults
   and (d) the core infogram (1 + 28 GBM surrogates) on phase 4's frame;
   (e) IsotonicRegression on 1M rows; (f) CoxPH with Efron ties on 1M x 10
   (3,650 integer times) and its concordance; (g) HGLM with a random
   intercept and slope over 1,000 groups of 1M rows; (h) PSVM at its
   defaults on the first 100k rows of phase 4's frame.
12. cross-validation, the TargetEncoder, the explanations, the Aggregator
   and the scikit-learn surface (no kernel of their own; the GBMs launch
   the histogram kernels, held to the plan's count), each timed after a
   warm run under the sync counter with its peak memory, profiled on a
   like part (one fold, ten trees, one partial dependence, one chunk of
   the sweep) and held to the CPU on a head (10k-50k rows): (a)
   bench_gbm with 5-fold CV and kept out-of-fold predictions (6 fits,
   720 fixed-kernel launches and 120 node totals), its main model bit
   for bit a GBM trained without CV; (b) the TargetEncoder at H2O-3's
   documented settings (KFold, blending, noise 0.15) on Origin, Dest and
   UniqueCarrier of phase 7's frame, then phase 7's GBM on the encodings;
   (c) ``explain`` of the CV GBM and a binomial GLM on 1M rows, with
   permutation importance and ICE, the scorings counted; (d) the
   Aggregator at H2O-3's 5,000 exemplars on 1M rows; (e) the scikit-learn
   GBM classifier on 1M rows as numpy, ``predict_proba`` bit for bit the
   GBM's ``predict``.
13. the DKV and orchestration (no kernel of their own; every GBM and
   XGBoost they build launches the histogram kernels, held to the plan of
   the grown trees): (a) AutoML as H2O-3's AutoML docs' Python example
   (``max_models=20, seed=1``, cut to 10 models; nfolds 5, parallelism 2)
   on the first 1M rows of phase 4's frame: GLM, three XGBoosts, five
   GBMs and the lr-annealed GBM (60 fits) and two ensembles, 12
   leaderboard rows; timed once with its host syncs, peak memory and each
   step's seconds, profiled on one fold of one step, the leader's CV AUC
   that of its kept out-of-fold predictions, and on the first 5k rows
   the CPU's AutoML against the card's; (b) AutoML's GBM grid
   (RandomDiscrete, 6 models) at parallelism 1 and 2, both timed, the
   same model ids, the models whose every level runs the fixed kernel bit
   for bit; (c) AutoML with target encoding and the lr-annealed step on
   the first 1M rows of phase 7's frame, its tree models scoring through
   the encoder; (d) a GBM per carrier (``train_segments``, 22 segments)
   on those rows, every model in the DKV, and on 20k rows the CPU's
   segment models (5 trees) alike at every split but the CPU's exact
   ties; (e) the
   kernels timed at 13a's level shapes.

The line before the last is the ``kernels`` JSON object (the main path's
object, one per further path with its ``path``, one for the global kernel
at the DRF levels it takes and one for the fixed kernel at the XGBoost
levels it takes); the last line is
``{"ok": true, "device": {...}}``; phase 8's numbers are the ``glm`` JSON
line, phase 9's the ``tree_family`` line, phase 10's the
``dl_unsupervised`` line, phase 11's the ``builders`` line, phase
12's the ``cv_explain`` line and phase 13's the ``orchestration`` line
before the ``kernels`` line. Without a CUDA
card the script exits non-zero and prints no result. It imports nothing
of JAX or ``h2o3_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM published peaks (NVIDIA data sheet): device memory rate and the
#: float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the main path: bench.py's bench_gbm configuration
ROWS, NFEAT, NTREES, DEPTH, NBINS = 11_000_000, 28, 20, 6, 64
# the XGBoost path: bench.py's bench_xgboost configuration
XGB_TREES, XGB_BINS = 10, 256
# the DRF path at DRF's defaults (50 trees, depth 14, mtries sqrt(28))
DRF_TREES, DRF_DEPTH, DRF_MTRIES = 50, 14, 5
#: phase 3's XGBoost at a size where the fixed kernel keeps 15 bits a value
QBITS15_ROWS, QBITS15_DEPTH = 4_500_000, 4
#: its trees (cut from 2: ROADMAP.md "Reduced checks")
QBITS15_TREES = 1
#: 16-byte float reductions into global memory per second at random
#: addresses of a 3 MB array (bench/global_red_rates.cu on an NVIDIA H100
#: 80GB HBM3 at 700.00 W): what bounds the global kernel's updates
RED_V4_PER_S = 8.966e10

#: the first kernel's ms per launch at levels 0-5 of the main path (one
#: feature per block, shared atomics; PERF.md section 6, NVIDIA H100 80GB
#: HBM3 at 700.00 W), for comparison
FIRST_KERNEL_MS = (3.570, 3.223, 3.221, 3.208, 3.207, 3.201)
#: that kernel's ms per launch at XGBoost's levels 0-2 (257 int16 bins;
#: PERF.md section 6, the same card), where the fixed kernel replaced it
ATOMIC_KERNEL_MS = (2.6527, 2.4376, 2.4218)


def higgs_arrays(rows: int, seed: int = 11) -> dict:
    """The HIGGS-shaped frame's columns: bench.py's ``_higgs_frame``
    generator (seed 11, 28 normal columns, the same logit, labels s/b)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, NFEAT)).astype(np.float32)
    logit = X[:, :4] @ np.array([1.2, -0.8, 0.5, 0.3], np.float32) \
        + 0.2 * X[:, 4] * X[:, 5]
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int32)
    cols = {f"x{i}": X[:, i] for i in range(NFEAT)}
    cols["y"] = np.where(y == 1, "s", "b")
    return cols


def hist_inputs(R: int, F: int, n_bins_tot: int, n_nodes: int, dtype,
                gen: torch.Generator, node=None, skew: int = 0) -> tuple:
    """Random histogram inputs on the card: bins in [0, n_bins_tot), nodes
    in [-1, n_nodes) unless given, g normal, h in [0.1, 1.1), w ones. With
    ``skew`` each tensor is a contiguous view that starts ``skew`` elements
    into its buffer, off the kernel's vector alignment."""
    dev = torch.device("cuda")

    def at_skew(t):
        buf = torch.empty(t.numel() + skew, dtype=t.dtype, device=dev)
        view = buf[skew:].view(t.shape)
        view.copy_(t)
        return view

    binned_T = torch.randint(0, n_bins_tot, (F, R), generator=gen,
                             device=dev).to(dtype)
    if node is None:
        node = torch.randint(-1, n_nodes, (R,), generator=gen, device=dev,
                             dtype=torch.int32)
    g = torch.randn(R, generator=gen, device=dev)
    h = torch.rand(R, generator=gen, device=dev) + 0.1
    w = torch.ones(R, device=dev)
    out = binned_T, node, g, h, w
    return tuple(map(at_skew, out)) if skew else out


def level_nodes(R: int, level: int, gen: torch.Generator) -> tuple:
    """Node ids of one main-path level: at level 0 all rows sit in node 0;
    at level d >= 1 rows spread evenly over 2^d children and only the rows
    of each parent's histogrammed child are active (the sibling comes by
    subtraction), so 2^(d-1) nodes hold about half the rows."""
    dev = torch.device("cuda")
    if level == 0:
        return 1, torch.zeros(R, dtype=torch.int32, device=dev)
    child = torch.randint(0, 2 ** level, (R,), generator=gen, device=dev,
                          dtype=torch.int32)
    return 2 ** (level - 1), torch.where(child % 2 == 0, child // 2, -1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def phase_env() -> dict:
    """Phase 1: card, versions, kernel build."""
    card = card_name()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    from h2o3_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_info['seconds']:.2f} s) "
          f"-> {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    return dict(card=card)


def sass_check() -> dict:
    """The fixed kernel's machine code (``cuobjdump -sass`` of the built
    library), at both bin widths: its shared-memory updates must be native
    integer atomics (ATOMS.ADD), with no compare-and-swap loop (ATOMS.CAS
    or CAST), and its flushes 64-bit fire-and-forget global reductions
    (REDG ... .64); prints the count of each and fails otherwise."""
    from pathlib import Path

    from h2o3_tpu_torch.ops import _build
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", _build.build_info["path"]],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        # the counting instances (mode 0, "Li0E" in the mangled name); the
        # measurement instances add nothing
        if "fixed_hist_kernel" not in name or "Li0E" not in name:
            continue
        ops = [line.split("*/", 1)[-1].strip() for line in fn.splitlines()
               if "/*" in line and "*/" in line]
        # the opcode: the first word that is not a predicate (@P0)
        ops = [next((t for t in op.split() if not t.startswith("@")), "")
               for op in ops]
        c = dict(atoms_add=sum(o.startswith("ATOMS.ADD") for o in ops),
                 atoms_cas=sum(o.startswith("ATOMS.CAS") or "CAST" in o
                               for o in ops),
                 red_64=sum(o.startswith("REDG") and ".64" in o
                            for o in ops))
        counts[name] = c
        kinds = sorted({o for o in ops if "ATOM" in o or "RED" in o})
        print(f"sass {name[-40:]}: {c} {kinds}")
    if len(counts) != 2 or any(c["atoms_cas"] or not c["atoms_add"]
                         or not c["red_64"] for c in counts.values()):
        raise AssertionError(f"fixed kernel's updates are not native integer "
                             f"atomics: {counts}")
    return counts


def batch_inputs(R: int, F: int, n_bins_tot: int, n_nodes: int, dtype,
                 gen: torch.Generator, K: int, w_per_class: bool) -> tuple:
    """:func:`hist_inputs` for a batch of K classes: node [K, R] in
    [-1, n_nodes), g and h [K, R], w [K, R] (random in [0.5, 1.5)) or one
    shared [R] row of ones."""
    dev = torch.device("cuda")
    binned_T = torch.randint(0, n_bins_tot, (F, R), generator=gen,
                             device=dev).to(dtype)
    node = torch.randint(-1, n_nodes, (K, R), generator=gen, device=dev,
                         dtype=torch.int32)
    g = torch.randn((K, R), generator=gen, device=dev)
    h = torch.rand((K, R), generator=gen, device=dev) + 0.1
    w = (torch.rand((K, R), generator=gen, device=dev) + 0.5 if w_per_class
         else torch.ones(R, device=dev))
    return binned_T, node, g, h, w


def check_hist(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Hold a kernel result to the plain version's: within rtol 1e-5 plus
    1e-5 x max|hist|, since atomics add in another order than the plain
    version's index_add_ and the only difference is float32 rounding of
    long sums. Returns the largest absolute difference."""
    torch.cuda.synchronize()
    err = (got - want).abs()
    scale = float(want.abs().max())
    max_abs = float(err.max())
    rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool((err <= 1e-5 * scale + 1e-5 * want.abs()).all())
    print(f"hist {what}: max abs err {max_abs:.3e} max rel err {rel:.3e} "
          f"max|hist| {scale:.4g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees at {what}")
    return max_abs


def check_call(args: tuple, N: int, Bt: int, what: str,
               kernel: str | None = None) -> tuple:
    """One kernel call held against the plain version: the plan's own
    kernel through ``level_histograms``, or ``kernel`` forced through the
    plan. Returns the kernel that ran and the max abs err."""
    from h2o3_tpu_torch.ops import hist
    node = args[1]
    K = node.shape[0] if node.dim() == 2 else 1
    used = hist.launch_plan(args[0], N, Bt, kernel, K)["kernel"]
    got = (hist._launch(*args, N, Bt, kernel) if kernel
           else hist.level_histograms(*args, N, Bt))
    err = check_hist(got, hist.level_histograms_plain(*args, N, Bt),
                     f"{what} [{used}]")
    return used, err


def check_fixed(args: tuple, N: int, Bt: int, what: str,
                against_plain: bool = True) -> dict:
    """The fixed kernel forced at one shape: two launches bit for bit equal,
    equal bit for bit to its plain-PyTorch emulation at the plan's qbits
    (``level_histograms_fixed_plain``), within the tolerance of
    :func:`check_hist` of the plain version and of float64 sums, and within
    its stated bound of float64 sums: n x max|x_s| x 2^-qbits (n the
    entry's rows) plus float32 rounding of the result. Returns the max abs
    err against the plain version and the largest ratio of the error
    against float64 sums to that bound. Without ``against_plain`` (skewed
    stats, whose float32 index_add_ drifts past the check by itself) the
    plain version is left out and the max abs err is against float64
    sums."""
    from h2o3_tpu_torch.ops import hist
    binned_T, node, g, h, w = args
    K = node.shape[0] if node.dim() == 2 else 1
    p = hist.launch_plan(binned_T, N, Bt, "fixed", K)
    got = hist._launch(*args, N, Bt, "fixed")
    again = hist._launch(*args, N, Bt, "fixed")
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    del again
    emu = hist.level_histograms_fixed_plain(*args, N, Bt, p["qbits"])
    as_emu = torch.equal(got.view(torch.int32), emu.view(torch.int32))
    del emu
    err = (check_hist(got, hist.level_histograms_plain(*args, N, Bt),
                      f"{what} [fixed]") if against_plain else None)
    exact = hist.level_histograms_plain(binned_T, node, g.double(),
                                        h.double(), w.double(), N, Bt)
    err64 = check_hist(got, exact, f"{what} [fixed] against float64 sums")
    if err is None:
        err = err64
    ones = torch.ones_like(w if w.dim() == 2 else g)
    rows = hist.level_histograms_plain(binned_T, node, ones, ones, ones, N,
                                       Bt).double()
    exps, bad = hist.fixed_exponents(node, g, h, w, N, p["qbits"])
    # half a step of each stat, 2^(E_s - qbits - 1) <= max|x_s| 2^-qbits
    step = torch.tensor([2.0 ** (-e - 1) for e in exps],
                        dtype=torch.float64, device="cuda")
    quant = rows * step
    bound = quant + 2.0 ** -24 * (exact.abs() + quant)
    ratio = float(((got.double() - exact).abs() / bound.clamp_min(1e-300))
                  .max())
    print(f"  fixed {what}: qbits {p['qbits']} (rows between flushes "
          f"{p['flush_rows']}, x 2^qbits = {p['flush_rows'] << p['qbits']} "
          f"< 2^31), two launches bit-identical {same}, equal to the "
          f"emulation {as_emu}, error against float64 sums at most "
          f"{ratio:.3f} of the stated bound")
    if not (same and as_emu and ratio <= 1.0):
        raise AssertionError(f"fixed kernel at {what}")
    return dict(err=err, bound_ratio=ratio)


def phase_fixed_checks() -> dict:
    """Phase 2's checks of the fixed-point kernel (forced through the plan):
    257 int16 bins at 1 and 2 nodes, at 11M x 28 and small; 1025 bins; K =
    3 with w shared and per class; rows not a multiple of four and offset
    views; 65 int8 bins at 11M x 28 in the layouts of the main path's and
    DRF's levels 0, 5 and 6 (1, 16 and 32 nodes); the last fixed level of
    each bin count at 1.5M rows, where entries hold a few hundred rows and
    the plan raises qbits; every row in one bin with g at its largest |q|
    (the overflow bound's edge); w in [0, 1e3]; a NaN and an infinity in
    the stats. Returns the largest max abs err and bound ratio."""
    from h2o3_tpu_torch.ops import hist
    gen = torch.Generator(device="cuda").manual_seed(17)
    B = XGB_BINS + 1
    i16 = torch.int16
    out = dict(err=0.0, bound_ratio=0.0)

    def note(r):
        for k in out:
            out[k] = max(out[k], r[k])

    for R, F, Bt, N, skew in ((4096, 7, B, 1, 0), (4096, 7, B, 2, 0),
                              (4099, 5, B, 1, 1), (4099, 5, B, 2, 1),
                              (ROWS, NFEAT, B, 1, 0), (ROWS, NFEAT, B, 2, 0),
                              (ROWS + 3, NFEAT, B, 1, 0),
                              (200_000, NFEAT, 1025, 2, 0),
                              (ROWS, NFEAT, 1025, 1, 0)):
        note(check_fixed(hist_inputs(R, F, Bt, N, i16, gen, skew=skew), N,
                         Bt, f"R={R} F={F} Bt={Bt} N={N} int16"
                         + (" offset views" if skew else "")))
    # level layouts: level d >= 1 holds half the rows in 2^(d-1) nodes
    for R, Bt, dt, level in ((ROWS, NBINS + 1, torch.int8, 0),
                             (ROWS, NBINS + 1, torch.int8, 5),
                             (ROWS, NBINS + 1, torch.int8, 6),
                             (1_500_000, NBINS + 1, torch.int8, 6),
                             (1_500_000, 129, i16, 5),
                             (1_500_000, B, i16, 4),
                             (1_500_000, 1025, i16, 2)):
        N, node = level_nodes(R, level, gen)
        note(check_fixed(hist_inputs(R, NFEAT, Bt, N, dt, gen, node=node), N,
                         Bt, f"R={R} F={NFEAT} Bt={Bt} N={N} "
                         f"{str(dt)[6:]}, level {level} layout"))
        del node
    for R, K, wk in ((4096, 3, False), (4099, 3, True), (ROWS, 3, True)):
        note(check_fixed(batch_inputs(R, NFEAT, B, 2, i16, gen, K, wk), 2, B,
                         f"R={R} F={NFEAT} Bt={B} N=2 K={K} w "
                         f"{'per class' if wk else 'shared'}"))
    # every row in bin 0 of node 0 with g just below 1: each value is
    # quantised to 2^qbits, so each block's int32 entry reaches its bound
    dev = torch.device("cuda")
    binned_T = torch.zeros((NFEAT, ROWS), dtype=i16, device=dev)
    node = torch.zeros(ROWS, dtype=torch.int32, device=dev)
    g = torch.full((ROWS,), float(np.nextafter(np.float32(1), 0)),
                   device=dev)
    ones = torch.ones(ROWS, device=dev)
    note(check_fixed((binned_T, node, g, ones, ones), 1, B,
                     f"R={ROWS} F={NFEAT} Bt={B} N=1 every row in one bin, "
                     "|q| = 2^qbits"))
    del binned_T, node, g, ones
    binned_T, node, g, h, _ = hist_inputs(ROWS, NFEAT, B, 1, i16, gen)
    w = torch.rand(ROWS, generator=gen, device=dev) * 1e3
    note(check_fixed((binned_T, node, g, h, w), 1, B,
                     f"R={ROWS} F={NFEAT} Bt={B} N=1 w in [0, 1e3]"))
    del binned_T, node, g, h, w
    # non-finite stats: NaN in g, infinity in h
    binned_T, node, g, h, w = hist_inputs(4096, 7, B, 2, i16, gen)
    act = int((node >= 0).nonzero()[0])
    g[act], h[act] = float("nan"), float("inf")
    got = hist._launch(binned_T, node, g, h, w, 2, B, "fixed")
    torch.cuda.synchronize()
    nonfinite = (bool(torch.isnan(got[..., :2]).all())
                 and bool(torch.isfinite(got[..., 2]).all()))
    print(f"  fixed NaN in g, inf in h: g and h non-finite throughout, w "
          f"finite: {nonfinite}")
    if not nonfinite:
        raise AssertionError("fixed kernel hides a non-finite stat")
    torch.cuda.empty_cache()
    return out


def phase_kernel_checks() -> dict:
    """Phase 2: kernel against the plain version, 2-D calls and class
    batches, every kernel of the plan (the global kernel also forced
    through the plan) and the plan's own choice at every DRF level; returns
    the max abs err of each path's shapes and of the global kernel's."""
    from h2o3_tpu_torch.ops.hist import (launch_plan, level_histograms,
                                         level_histograms_plain)
    gen = torch.Generator(device="cuda").manual_seed(7)
    Bt = NBINS + 1
    G = "global"
    shapes = [  # (R, F, bins incl. NA, N, dtype, what, path, kernel)
        (4096, 7, 17, 8, torch.int16, "", "binomial", None),
        (2048, 3, 257, 128, torch.int16, "", "xgboost_257", None),
        (4099, 5, Bt, 1, torch.int8, "node0", "binomial", None),  # one node
        (4099, 5, Bt, 4, torch.int8, "skew", "binomial", None),   # unaligned
        (4099, 5, Bt, 4, torch.int16, "skew", "binomial", None),
        (1 << 20, 4, Bt, 1 << 14, torch.int8, "", "drf_depth14", None),
        (ROWS, NFEAT, Bt, 1, torch.int8, "", "binomial", None),
        # rows not a multiple of 4
        (ROWS + 3, NFEAT, Bt, 1, torch.int8, "", "binomial", None),
        (ROWS, NFEAT, Bt, 2, torch.int8, "", "binomial", None),
        (ROWS, NFEAT, Bt, 16, torch.int8, "", "binomial", None),
        # the XGBoost level-0 shape (fixed kernel) and a deep DRF level
        (ROWS, NFEAT, XGB_BINS + 1, 1, torch.int16, "", "xgboost_257", None),
        (ROWS, NFEAT, Bt, 1024, torch.int8, "", "drf_depth14", None),
        # the global kernel forced through the plan: DRF's deepest levels,
        # 2^14 nodes, 257 int16 bins, rows not a multiple of four, and
        # offset views (bins, node, g, h and w off their alignment)
        (ROWS, NFEAT, Bt, 1024, torch.int8, "", G, G),
        (ROWS, NFEAT, Bt, 4096, torch.int8, "", G, G),
        (1_000_000, NFEAT, Bt, 1 << 14, torch.int8, "", G, G),
        (ROWS, NFEAT, XGB_BINS + 1, 16, torch.int16, "", G, G),
        (ROWS, NFEAT, XGB_BINS + 1, 64, torch.int16, "", G, G),
        (4099, 5, Bt, 64, torch.int8, "", G, G),
        (4099, 5, Bt, 64, torch.int8, "skew", G, G),
        (1 << 20, NFEAT, XGB_BINS + 1, 64, torch.int16, "skew", G, G),
    ]
    worst: dict[str, float] = {}

    def note(path: str, used: str, err: float) -> None:
        worst[path] = max(worst.get(path, 0.0), err)
        if used == G:
            worst[G] = max(worst.get(G, 0.0), err)

    for R, F, Bt_, N, dt, what, path, kernel in shapes:
        node = (torch.zeros(R, dtype=torch.int32, device="cuda")
                if what == "node0" else None)
        args = hist_inputs(R, F, Bt_, N, dt, gen, node=node,
                           skew=1 if what == "skew" else 0)
        shape = f"R={R} F={F} Bt={Bt_} N={N} {str(dt)[6:]} {what}".strip()
        note(path, *check_call(args, N, Bt_, shape, kernel))
        del args
    # class batches (K = 3): w shared and per class, the fixed kernel with
    # rows a multiple of four and not, the global kernel
    # (planned at 128 nodes of 257 bins, forced at 1024 nodes of 65), and
    # the multinomial level-0 shape at full width
    batches = [  # (R, F, bins incl. NA, N, dtype, K, w per class, kernel)
        (4096, 7, 17, 8, torch.int16, 3, False, None),
        (4096, 7, 17, 8, torch.int16, 3, True, None),
        (4099, 5, Bt, 4, torch.int8, 3, True, None),
        (4096, 7, 257, 1, torch.int16, 3, True, None),
        (2048, 3, 257, 128, torch.int16, 3, True, None),
        (4099, 5, Bt, 1024, torch.int8, 3, True, G),
        (ROWS, NFEAT, Bt, 1024, torch.int8, 3, False, G),
        (ROWS, NFEAT, Bt, 1024, torch.int8, 3, True, G),
        (ROWS, NFEAT, Bt, 1, torch.int8, 3, False, None),
    ]
    for R, F, Bt_, N, dt, K, wk, kernel in batches:
        args = batch_inputs(R, F, Bt_, N, dt, gen, K, wk)
        shape = (f"R={R} F={F} Bt={Bt_} N={N} {str(dt)[6:]} K={K} "
                 f"w {'per class' if wk else 'shared'}")
        note("multinomial_k3", *check_call(args, N, Bt_, shape, kernel))
        del args
    # the plan's own kernel at every DRF level (11M x 28, 65 bins): level d
    # >= 1 holds half the rows in 2^(d-1) nodes; level 0 every row in node
    # 0, so that each entry sums about 170k rows and the plain version's own
    # float32 rounding nears the tolerance: there the kernel is held to
    # float64 sums, with the plain version's distance from them beside it
    binned_T, _, g, h, w = hist_inputs(ROWS, NFEAT, Bt, 1, torch.int8, gen)
    for level in range(1, DRF_DEPTH):
        N, node = level_nodes(ROWS, level, gen)
        note("drf_depth14", *check_call(
            (binned_T, node, g, h, w), N, Bt,
            f"DRF level {level} R={ROWS} F={NFEAT} Bt={Bt} N={N} int8"))
        del node
    _, node = level_nodes(ROWS, 0, gen)
    stats = torch.stack([g, h, w], 1).double()
    exact = torch.stack([torch.zeros((Bt, 3), dtype=torch.float64,
                                     device="cuda").index_add_(
        0, binned_T[f].long(), stats) for f in range(NFEAT)])
    what = f"DRF level 0 R={ROWS} F={NFEAT} Bt={Bt} N=1 int8"
    plain = level_histograms_plain(binned_T, node, g, h, w, 1, Bt)
    print(f"{what}: plain version against float64 sums: max abs err "
          f"{float((plain - exact).abs().max()):.3e}")
    note("drf_depth14", launch_plan(binned_T, 1, Bt)["kernel"], check_hist(
        level_histograms(binned_T, node, g, h, w, 1, Bt), exact,
        f"{what} against float64 sums"))
    del plain
    del binned_T, node, g, h, w, stats, exact
    # a K = 1 batch against the 2-D call: both launch the same kernel, held
    # to the same tolerance
    binned_T, node, g, h, w = hist_inputs(ROWS, NFEAT, Bt, 2, torch.int8, gen)
    two_d = level_histograms(binned_T, node, g, h, w, 2, Bt)
    one = level_histograms(binned_T, node[None], g[None], h[None], w, 2, Bt)
    if tuple(one.shape) != (1,) + tuple(two_d.shape):
        raise AssertionError(f"K = 1 batch has shape {tuple(one.shape)}")
    check_hist(one[0], two_d, f"R={ROWS} F={NFEAT} Bt={Bt} N=2 int8 K=1 "
               "batch against the 2-D call")
    worst["binomial"] = max(worst["binomial"], check_hist(
        two_d, level_histograms_plain(binned_T, node, g, h, w, 2, Bt),
        f"R={ROWS} F={NFEAT} Bt={Bt} N=2 int8 2-D call"))
    del binned_T, node, g, h, w, two_d, one
    torch.cuda.empty_cache()
    return worst


def phase_kernel_times() -> dict:
    """Phase 5: the kernel at each main-path level's shape."""
    from h2o3_tpu_torch.ops.hist import (_launch, hist_bytes, hist_flops,
                                         launch_plan, level_histograms,
                                         level_histograms_loads_only,
                                         level_histograms_plain)
    gen = torch.Generator(device="cuda").manual_seed(5)
    Bt = NBINS + 1
    binned_T, _, g, h, w = hist_inputs(ROWS, NFEAT, Bt, 1, torch.int8, gen)
    stats = torch.stack([g, h, w], 1)
    rows = []
    for level in range(DEPTH):
        N, node = level_nodes(ROWS, level, gen)
        active = int((node >= 0).sum())
        calls = dict(level_histograms.kernel_launches)
        ms = cuda_ms(lambda: level_histograms(binned_T, node, g, h, w, N, Bt),
                     reps=20)
        loads_ms = cuda_ms(lambda: level_histograms_loads_only(
            binned_T, node, g, h, w, N, Bt), reps=20)
        global_ms = cuda_ms(lambda: _launch(binned_T, node, g, h, w, N, Bt,
                                            "global"), reps=20)
        staging_ms = cuda_ms(lambda: level_histograms_loads_only(
            binned_T, node, g, h, w, N, Bt, scan=False), reps=20)
        plan = launch_plan(binned_T, N, Bt)
        plain_ms = cuda_ms(lambda: level_histograms_plain(
            binned_T, node, g, h, w, N, Bt), reps=3, warmup=1)
        # the yardstick: one index_add_ of the [F*R, 3] stats of the active
        # rows onto flattened (feature, node, bin) ids, built beforehand
        act = (node >= 0).repeat(NFEAT)
        ids = (torch.arange(NFEAT, device="cuda")[:, None] * (N * Bt)
               + node.long()[None, :] * Bt + binned_T.long()).reshape(-1)[act]
        src = stats.repeat(NFEAT, 1)[act]
        library_ms = cuda_ms(lambda: torch.zeros(
            (NFEAT * N * Bt, 3), device="cuda").index_add_(0, ids, src),
            reps=5, warmup=1)
        del ids, src, act
        # timing launches are not counted
        level_histograms.kernel_launches = calls
        nbytes = hist_bytes(ROWS, NFEAT, N, Bt, 1)
        flops = hist_flops(active, NFEAT)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / F32_FLOPS_PER_S else "operations")
        row = dict(level=level, N=N, active_rows=active, ms=ms,
                   global_ms=global_ms, updates_out_ms=loads_ms,
                   staging_only_ms=staging_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / ms, gbps=nbytes / ms / 1e6,
                   bytes=nbytes, flops=flops)
        print(f"hist level {level} N={N} active={active}: kernel {ms:.4f} ms "
              f"(first kernel {FIRST_KERNEL_MS[level]:.3f} ms), "
              f"{100 * bound_ms / ms:.1f}% of bound {bound_ms:.4f} ms "
              f"({bound_by}, {nbytes / 1e6:.1f} MB), "
              f"{nbytes / ms / 1e6:.1f} GB/s; its updates out "
              f"{loads_ms:.4f} ms, staging only {staging_ms:.4f} ms; "
              f"global kernel {global_ms:.4f} ms; "
              f"plain {plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms; plan "
              f"{plan['kernel']} Fb={plan['features_per_group']} "
              f"groups={plan['groups']} Nb={plan['nodes_per_block']} "
              f"node_blocks={plan['node_blocks']} smem={plan['smem_bytes']} B "
              f"blocks={plan['blocks']} qbits={plan['qbits']}")
        rows.append(row)
        del node
    torch.cuda.empty_cache()
    return dict(levels=rows)


def profile_training(train, timed_s: float) -> dict:
    """One more training under torch.profiler (device activity only): the
    device busy time, as a share of the unprofiled timed run's wall time
    (the profiler's own host cost inflates the profiled wall), and the
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    share = busy_ms / (timed_s * 1e3)
    print(f"profiled training: device busy {busy_ms:.1f} ms in "
          f"{sum(n for _, _, n in kernels)} device ops = {100 * share:.1f}% "
          f"of the timed run's {timed_s * 1e3:.1f} ms (idle "
          f"{100 * (1 - share):.1f}%)")
    for name, ms, n in kernels[:8]:
        print(f"  {ms:9.2f} ms {n:6d}x  {name[:90]}")
    return dict(busy_ms=busy_ms, busy_share=share)


def multi_codes(x0, x1, x2, rng: np.random.Generator):
    """3-class labels drawn from a softmax of three linear scores: the
    argmax of [0.9 x0, -0.7 x1, 0.8 x2] plus Gumbel noise from ``rng``
    (tests/test_orchestration.py's _multi_frame pattern with noise). Takes
    numpy columns or tensors on the card; returns int32 codes alike."""
    noise = rng.gumbel(size=(len(x0), 3)).astype(np.float32)
    if isinstance(x0, np.ndarray):
        s = np.stack([0.9 * x0, -0.7 * x1, 0.8 * x2], 1) + noise
        return s.argmax(1).astype(np.int32)
    s = torch.stack([0.9 * x0, -0.7 * x1, 0.8 * x2], 1) \
        + torch.from_numpy(noise).to(x0.device)
    return s.argmax(1).to(torch.int32)


def _margins(model, frame):
    """[rows] or [rows, K] margins of a GBM: f0 plus the scaled tree sums."""
    out = model.output
    if out["distribution"] == "multinomial":
        return out["f0_multi"][None, :] + \
            out["learn_rate"] * model._tree_raw_sum_per_class(frame)
    return out["f0"] + out["learn_rate"] * model._tree_raw_sum(frame)


def _tree_sets(model) -> list:
    out = model.output
    return out["trees_multi"] if "trees_multi" in out else [out["trees"]]


def _routed_alike(a, b, X: torch.Tensor, keys: tuple) -> tuple:
    """The heap index of the leaf each row reaches in tree ``a`` and [rows]
    True where its path runs only through heap nodes whose split
    (``keys``) is the same in tree ``b``: there both route the row alike,
    to the same leaf."""
    alike = torch.stack([getattr(a, k).cpu() == getattr(b, k).cpu()
                         for k in keys]).all(0)
    depth = int(np.log2(alike.numel() + 1)) - 1
    for d in range(1, depth + 1):   # a node is alike if its parent is
        i = torch.arange(2 ** d - 1, 2 ** (d + 1) - 1)
        alike[i] &= alike[(i - 1) // 2]
    feat, tv = a.feat.cpu(), a.thresh_val.cpu()
    na_l, is_sp = a.na_left.cpu(), a.is_split.cpu()
    idx = torch.zeros(X.shape[0], dtype=torch.long)
    for _ in range(depth):   # the raw-value walk of tree.predict_raw
        x = X.gather(1, feat[idx].clamp_min(0).long()[:, None])[:, 0]
        left = torch.where(torch.isnan(x), na_l[idx], x < tv[idx])
        idx = torch.where(is_sp[idx], idx * 2 + torch.where(left, 1, 2), idx)
    return idx, alike[idx]


SPLIT_KEYS = ("feat", "thresh_bin", "na_left", "is_split")


def _split_agreement(ma, mb) -> tuple:
    """Heap nodes whose split (feature, threshold, NA side, split or not)
    is the same in two models' trees, trees split alike throughout, and
    their totals."""
    pairs = [(a, b) for sa, sb in zip(_tree_sets(ma), _tree_sets(mb))
             for a, b in zip(sa, sb)]
    alike = [torch.stack([getattr(a, k).cpu() == getattr(b, k).cpu()
                          for k in SPLIT_KEYS]).all(0) for a, b in pairs]
    return (sum(int(x.sum()) for x in alike), sum(x.numel() for x in alike),
            sum(bool(x.all()) for x in alike), len(pairs))


@contextlib.contextmanager
def plan_taking(kernel: str):
    """The plan taking ``kernel`` at every level of every bin count, for a
    witness run."""
    from h2o3_tpu_torch.ops import hist
    saved = hist._KERNEL_SWITCH
    hist._KERNEL_SWITCH = {b: (kernel, hist._GLOBAL_MAX_NODES + 1)
                           for b in saved}
    hist._kernel_plan.cache_clear()
    hist._plan.cache_clear()
    try:
        yield
    finally:
        hist._KERNEL_SWITCH = saved
        hist._kernel_plan.cache_clear()
        hist._plan.cache_clear()


def cross_device(what: str, cols: dict, make, metric: str,
                 exact_splits: bool = True) -> dict:
    """One small model trained on the CPU (plain path) and on the card
    (kernels): the training ``metric`` within 1e-4 and the margins within
    atol 1e-4 (float32 sums in another order), and, with ``exact_splits``,
    every split equal. A deep tree's nodes take their histograms by
    repeated sibling subtraction, which carries the rounding of root-sized
    sums, so a near-tie between splits may flip with the order of the sums
    and move the rows under it, and every later tree sees those rows'
    gradients change. Without ``exact_splits`` the margins are therefore
    held on the first tree: its leaf values within 1e-4 on the rows it
    routes through splits alike on both devices; the script prints how many
    heap nodes and rows agree in each tree. It then trains two witnesses of
    what the order of the sums alone does, on the card: the same plan
    again (the global kernel's reductions land in another order from run
    to run) and the fixed kernel at every level (integer sums: the same
    bits every run, none of them the CPU's), and prints how many heap
    nodes and first-tree rows agree between each pair of runs. Returns the
    kernels' launches on the card."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.tree import HEAP_FIELDS
    from h2o3_tpu_torch.ops.hist import level_histograms
    runs = [("cpu", "cpu", None), ("cuda", "cuda", None)]
    if not exact_splits:
        runs += [("cuda again", "cuda", None),
                 ("cuda, fixed at every level", "cuda", "fixed")]
    models, margins = {}, {}
    for name, dev, kernel in runs:
        fr = Frame.from_arrays(cols, device=dev)
        t0 = time.perf_counter()
        level_histograms.kernel_launches = dict.fromkeys(
            level_histograms.kernel_launches, 0)
        with plan_taking(kernel) if kernel else contextlib.nullcontext():
            models[name] = make().train(x=[f"x{i}" for i in range(NFEAT)],
                                        y="y", training_frame=fr)
        margins[name] = _margins(models[name], fr).cpu()
        print(f"cross-device {what} on {name}: "
              f"{time.perf_counter() - t0:.2f} s, {metric} "
              f"{getattr(models[name].training_metrics, metric):.6f}, "
              f"kernel launches {level_histograms.kernel_launches}")
        if name == "cuda":
            launches = dict(level_histograms.kernel_launches)
    pairs = [(a, b) for sa, sb in zip(_tree_sets(models["cpu"]),
                                      _tree_sets(models["cuda"]))
             for a, b in zip(sa, sb)]
    same_heaps = sum(all(torch.equal(getattr(a, k).cpu(), getattr(b, k).cpu())
                         for k in HEAP_FIELDS) for a, b in pairs)
    d_metric = abs(getattr(models["cpu"].training_metrics, metric)
                   - getattr(models["cuda"].training_metrics, metric))
    d_margin = float((margins["cpu"] - margins["cuda"]).abs().max())
    entries, total, n_split, _ = _split_agreement(models["cpu"],
                                                  models["cuda"])
    print(f"cross-device {what}: {same_heaps}/{len(pairs)} trees with "
          f"identical heap arrays, {n_split}/{len(pairs)} with identical "
          f"splits, {entries}/{total} heap nodes with the same split, "
          f"|d{metric}| {d_metric:.2e}, max |dmargin| {d_margin:.2e}; "
          f"kernel launches on the card {launches}")
    if exact_splits:
        ok = n_split == len(pairs) and torch.allclose(
            margins["cpu"], margins["cuda"], atol=1e-4)
    else:
        X = torch.from_numpy(np.stack([cols[f"x{i}"] for i in range(NFEAT)],
                                      1))
        for t, (a, b) in enumerate(pairs):
            idx, rows = _routed_alike(a, b, X, SPLIT_KEYS)
            d_leaf = float((a.leaf.cpu()[idx] - b.leaf.cpu()[idx])[rows]
                           .abs().max())
            print(f"cross-device {what}, tree {t}: {int(rows.sum())}/"
                  f"{rows.numel()} rows routed through splits alike, max "
                  f"|dleaf| there {d_leaf:.2e}")
            if t == 0:
                ok = d_leaf < 1e-4
        names = [name for name, _, _ in runs]
        for i, x in enumerate(names):
            for y in names[i + 1:]:
                entries, total, _, _ = _split_agreement(models[x], models[y])
                rows = _routed_alike(_tree_sets(models[x])[0][0],
                                     _tree_sets(models[y])[0][0], X,
                                     SPLIT_KEYS)[1]
                print(f"split order witness, {what}, {x} vs {y}: "
                      f"{total - entries}/{total} heap nodes split "
                      f"differently, {rows.numel() - int(rows.sum())}/"
                      f"{rows.numel()} rows routed differently in tree 0, "
                      f"max |dmargin| "
                      f"{float((margins[x] - margins[y]).abs().max()):.2e}")
    if not ok or d_metric >= 1e-4:
        raise AssertionError(f"card and CPU {what} disagree")
    return launches


def phase_cross_device() -> None:
    """Phase 3: small binomial GBM, multinomial GBM (K = 3) and XGBoost
    (256 bins) on the CPU and on the card, sampling off; XGBoost at 4.5M
    rows, where the fixed kernel keeps 15 bits a value at levels 0-3; then
    a deep GBM (depth 12, levels of up to 1024 nodes) whose deep levels run
    the global kernel on the card."""
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.models.xgboost import XGBoost
    cols = higgs_arrays(100_000)
    cross_device("GBM 100k x 28", cols, lambda: GBM(
        ntrees=5, max_depth=6, nbins=64, learn_rate=0.1, seed=42), "auc")
    codes = multi_codes(cols["x0"], cols["x1"], cols["x2"],
                        np.random.default_rng(12))
    multi = dict(cols, y=np.array(["c0", "c1", "c2"])[codes])
    cross_device("multinomial GBM 100k x 28, K = 3", multi, lambda: GBM(
        ntrees=5, max_depth=6, nbins=64, learn_rate=0.1, seed=42), "logloss")
    cross_device("XGBoost 100k x 28, 256 bins", cols, lambda: XGBoost(
        ntrees=5, max_depth=6, max_bin=XGB_BINS, eta=0.3, seed=42), "auc")
    # where the fixed kernel keeps 15 bits a value, as on the main paths: a
    # block walks more than 128 tiles between two flushes (R > 132 x 128 x
    # 256 at one node) and its entries hold over 2048 rows each
    from h2o3_tpu_torch.ops.hist import launch_plan
    shape = torch.empty((NFEAT, QBITS15_ROWS), dtype=torch.int16,
                        device="meta")
    qbits = [launch_plan(shape, max(1, 2 ** (d - 1)), XGB_BINS + 1)["qbits"]
             for d in range(QBITS15_DEPTH)]
    print(f"XGBoost {QBITS15_ROWS} x {NFEAT}: the fixed kernel's qbits by "
          f"level {qbits}")
    if min(qbits) != 15:
        raise AssertionError(f"no level at 15 bits: {qbits}")
    cross_device(f"XGBoost {QBITS15_ROWS} x 28, 256 bins, depth "
                 f"{QBITS15_DEPTH}", higgs_arrays(QBITS15_ROWS),
                 lambda: XGBoost(ntrees=QBITS15_TREES,
                                 max_depth=QBITS15_DEPTH,
                                 max_bin=XGB_BINS, eta=0.3, seed=42), "auc")
    deep = cross_device("GBM 200k x 28, depth 12", higgs_arrays(200_000),
                        lambda: GBM(ntrees=3, max_depth=12, nbins=NBINS,
                                    learn_rate=0.1, seed=42), "auc",
                        exact_splits=False)
    if deep["global"] == 0:
        raise AssertionError("the deep GBM never launched the global kernel")


def split_witness(runs: int = 30, rows: int = 100_000, ntrees: int = 5,
                  depth: int = 6, kernels=(None, "fixed", "global")) -> dict:
    """How often the card's XGBoost (phase 3's: 256 bins, eta 0.3, seed 42)
    splits a heap node otherwise than the CPU's: one CPU training, then
    ``runs`` card trainings for each of ``kernels`` (None: the plan; a
    name: that kernel at every level), each held to the CPU's splits.
    Prints and returns, for each, the runs that differ and the (tree, heap
    node) pairs that did. Not part of :func:`main`; run it after
    :func:`phase_env`, e.g. ``python3 -c "import chip_smoke as s;
    s.phase_env(); s.split_witness()"``."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.xgboost import XGBoost
    cols = higgs_arrays(rows)
    x = [f"x{i}" for i in range(NFEAT)]

    def train(dev):
        return XGBoost(ntrees=ntrees, max_depth=depth, max_bin=XGB_BINS,
                       eta=0.3, seed=42).train(
            x=x, y="y", training_frame=Frame.from_arrays(cols, device=dev))

    cpu = train("cpu")
    out = {}
    for kernel in kernels:
        differ, nodes = 0, {}
        for _ in range(runs):
            with plan_taking(kernel) if kernel else contextlib.nullcontext():
                card = train("cuda")
            flips = []
            for t, (a, b) in enumerate(zip(_tree_sets(cpu)[0],
                                           _tree_sets(card)[0])):
                alike = torch.stack([getattr(a, k).cpu() == getattr(b, k).cpu()
                                     for k in SPLIT_KEYS]).all(0)
                flips += [(t, int(i)) for i in (~alike).nonzero()[:, 0]]
            differ += bool(flips)
            for f in flips[:1]:   # the first node that differs, per run
                nodes[f] = nodes.get(f, 0) + 1
        name = kernel or "plan"
        out[name] = dict(runs=runs, differ=differ,
                         first_nodes={f"{t}:{i}": n
                                      for (t, i), n in nodes.items()})
        print(f"split witness, XGBoost {rows} x {NFEAT}, {ntrees} trees "
              f"depth {depth}, {name}: {differ}/{runs} card runs split "
              f"otherwise than the CPU; first differing (tree, heap node): "
              f"{out[name]['first_nodes']}")
    return out


def build_frame():
    """The 11M x 28 HIGGS-shaped frame on the card, built once for phases
    4 and 6."""
    from h2o3_tpu_torch.frame.frame import Frame
    t0 = time.perf_counter()
    cols = higgs_arrays(ROWS)
    fr = Frame.from_arrays(cols)
    del cols
    torch.cuda.synchronize()
    print(f"frame {ROWS} x {NFEAT} on the card: "
          f"{time.perf_counter() - t0:.2f} s")
    return fr


def planned_launches(ntrees: int, depth: int, Bt: int, bin_bytes: int,
                     K: int = 1) -> dict:
    """Launches of each kernel that a training of ``ntrees`` trees (rounds)
    of ``depth`` levels makes: one per level, of the kernel the plan takes
    at the level's node count (1 at levels 0 and 1, 2^(d-1) at level d)."""
    from h2o3_tpu_torch.ops.hist import _kernel_plan, level_histograms
    out = dict.fromkeys(level_histograms.kernel_launches, 0)
    for d in range(depth):
        out[_kernel_plan(NFEAT, max(1, 2 ** (d - 1)), Bt, bin_bytes, None,
                         K)["kernel"]] += ntrees
    return out


def reset_launches() -> None:
    """Every kernel launch count to 0."""
    from h2o3_tpu_torch.ops.hist import level_histograms
    level_histograms.kernel_launches = dict.fromkeys(
        level_histograms.kernel_launches, 0)


def run_path(what: str, train, warm, fr, ntrees: int, expected: dict,
             metrics, kernels: tuple, expected_totals: int | None = None,
             pred_check=None) -> dict:
    """Train once to warm up (``warm``: fewer trees at the same shapes) and
    once timed, with the kernels' launches counted from 0 and held to
    ``expected`` (launches by kernel), each of ``kernels`` at least once,
    and the node totals to ``expected_totals`` (default: one a tree);
    then score the frame and hold the scored metrics to the training ones.
    ``metrics`` names the metrics, each with its tolerance;
    ``pred_check(pred)`` checks the predictions (default: probabilities
    of every row)."""
    from h2o3_tpu_torch.ops.hist import (launch_count, level_histograms,
                                         node_totals)
    t0 = time.perf_counter()
    warm()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    node_totals.launches = 0
    t0 = time.perf_counter()
    model = train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_count()
    by_kernel = dict(level_histograms.kernel_launches)
    totals = node_totals.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    pred = model.predict(fr)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    scored = model.model_performance(fr)
    trained = {m: getattr(model.training_metrics, m) for m in metrics}
    shown = ", ".join(f"training {m} {v:.6f} scored "
                      f"{getattr(scored, m):.6f}" for m, v in trained.items())
    rows = fr.nrows
    print(f"{what}: warm-up {warm_s:.2f} s, timed {seconds:.3f} s, "
          f"{rows * ntrees / seconds:.4g} rows*trees/s, kernel launches "
          f"{launches} {by_kernel}, node totals {totals}, peak device memory "
          f"{peak:.2f} GiB; {shown}; scoring {score_s:.3f} s")
    prof = profile_training(train, seconds)
    want_totals = ntrees if expected_totals is None else expected_totals
    if by_kernel != expected or launches != sum(expected.values()) \
            or not all(by_kernel[k] for k in kernels) \
            or totals != want_totals:
        raise AssertionError(f"{what}: kernels launched {by_kernel}, "
                             f"expected {expected}, each of {kernels}; "
                             f"node totals {totals}, expected {want_totals}")
    for m, tol in metrics.items():
        if not np.isfinite(trained[m]) or \
                abs(getattr(scored, m) - trained[m]) >= tol:
            raise AssertionError(f"{what}: scored {m} {getattr(scored, m)} "
                                 f"vs training {trained[m]}")
    if pred_check is not None:
        pred_check(pred)
    else:
        probs = torch.stack([v.data for v in pred.vecs[1:]], 1)
        if probs.shape[0] != rows or not bool(torch.isfinite(probs).all()) \
                or not torch.allclose(probs.sum(1),
                                      torch.ones_like(probs[:, 0]),
                                      atol=1e-4):
            raise AssertionError(f"{what}: scores are not probabilities")
    return dict(seconds=seconds, launches=launches, by_kernel=by_kernel,
                node_totals=totals, score_s=score_s,
                rows_trees_per_s=rows * ntrees / seconds,
                peak_gib=peak, **trained, **prof)


def phase_new_paths(fr) -> dict:
    """Phase 6: XGBoost, multinomial GBM and DRF at full width on phase 4's
    frame, each warmed up, timed and scored."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.types import VecType
    from h2o3_tpu_torch.frame.vec import Vec
    from h2o3_tpu_torch.models.gbm import DRF, GBM
    from h2o3_tpu_torch.models.xgboost import XGBoost
    x = [f"x{i}" for i in range(NFEAT)]
    out = {}

    def xgb(n):
        return lambda: XGBoost(ntrees=n, max_depth=DEPTH, max_bin=XGB_BINS,
                               eta=0.3, seed=42).train(x=x, y="y",
                                                       training_frame=fr)

    out["xgboost_257"] = run_path(
        f"XGBoost {ROWS} x {NFEAT}, {XGB_TREES} trees depth {DEPTH} "
        f"{XGB_BINS} bins", xgb(XGB_TREES), xgb(2), fr, XGB_TREES,
        planned_launches(XGB_TREES, DEPTH, XGB_BINS + 1, 2), {"auc": 1e-4},
        ("fixed", "global"))

    t0 = time.perf_counter()
    codes = multi_codes(fr.vec("x0").data, fr.vec("x1").data,
                        fr.vec("x2").data, np.random.default_rng(12))
    frm = Frame(x + ["c"], [fr.vec(c) for c in x]
                + [Vec.from_device(codes, VecType.CAT,
                                   domain=("c0", "c1", "c2"))])
    torch.cuda.synchronize()
    shares = (torch.bincount(codes.long()).float() / ROWS).tolist()
    print(f"3-class label on the card: {time.perf_counter() - t0:.2f} s, "
          f"class shares {shares}")

    def multi(n):
        return lambda: GBM(ntrees=n, max_depth=DEPTH, nbins=NBINS,
                           learn_rate=0.1, seed=42).train(x=x, y="c",
                                                          training_frame=frm)

    out["multinomial_k3"] = run_path(
        f"multinomial GBM {ROWS} x {NFEAT}, K = 3, {NTREES} rounds depth "
        f"{DEPTH} {NBINS} bins", multi(NTREES), multi(2), frm, NTREES,
        planned_launches(NTREES, DEPTH, NBINS + 1, 1, 3),
        {"logloss": 1e-4, "mean_per_class_error": 1e-4}, ("fixed",))
    del frm, codes

    def drf(n):
        return lambda: DRF(ntrees=n, max_depth=DRF_DEPTH, nbins=NBINS,
                           mtries=DRF_MTRIES, seed=42).train(
                               x=x, y="y", training_frame=fr)

    out["drf_depth14"] = run_path(
        f"DRF {ROWS} x {NFEAT}, {DRF_TREES} trees depth {DRF_DEPTH} {NBINS} "
        f"bins, sample_rate 0.632, mtries {DRF_MTRIES}", drf(DRF_TREES),
        drf(1), fr, DRF_TREES,
        planned_launches(DRF_TREES, DRF_DEPTH, NBINS + 1, 1), {"auc": 1e-9},
        ("fixed", "global"))
    torch.cuda.empty_cache()
    return out


def phase_main_path(fr) -> dict:
    """Phase 4: bench_gbm's configuration on the full 11M x 28 frame."""
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.ops.hist import (launch_count, level_histograms,
                                         node_totals)

    def train():
        return GBM(ntrees=NTREES, max_depth=DEPTH, nbins=NBINS,
                   learn_rate=0.1, seed=42).train(y="y", training_frame=fr)

    t0 = time.perf_counter()
    train()                                   # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    node_totals.launches = 0
    t0 = time.perf_counter()
    model = train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_count()
    by_kernel = dict(level_histograms.kernel_launches)
    totals = node_totals.launches
    auc = model.training_metrics.auc
    t0 = time.perf_counter()
    pred = model.predict(fr)
    ps = pred.vec("ps").data
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    scored_auc = model.model_performance(fr).auc
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_training(train, seconds)
    print(f"main path GBM {ROWS} x {NFEAT}, {NTREES} trees depth {DEPTH} "
          f"{NBINS} bins: warm-up {warm:.2f} s, timed {seconds:.3f} s, "
          f"{ROWS * NTREES / seconds:.4g} rows*trees/s, training AUC "
          f"{auc:.6f}, kernel launches {launches} {by_kernel}, node totals "
          f"{totals}, peak device memory {peak:.2f} GiB")
    print(f"scoring {ROWS} rows: {score_s:.3f} s, scored AUC {scored_auc:.6f}")
    # one histogram per level of every tree, each on the plan's kernel
    expected = planned_launches(NTREES, DEPTH, NBINS + 1, 1)
    if launches != NTREES * DEPTH or by_kernel != expected \
            or not all(by_kernel[k] for k, n in expected.items() if n) \
            or totals != NTREES:
        raise AssertionError(f"kernels launched {launches} times "
                             f"{by_kernel}, expected {expected}; node totals "
                             f"{totals}, expected {NTREES}")
    if not (np.isfinite(auc) and auc > 0.5):
        raise AssertionError(f"training AUC {auc}")
    if ps.shape != (ROWS,) or not bool(torch.isfinite(ps).all()) \
            or not bool(((ps >= 0) & (ps <= 1)).all()):
        raise AssertionError("scores are not finite probabilities")
    if abs(scored_auc - auc) >= 1e-4:
        raise AssertionError(f"scored AUC {scored_auc} vs training {auc}")
    return dict(seconds=seconds, launches=launches, by_kernel=by_kernel,
                node_totals=totals, auc=auc,
                rows_trees_per_s=ROWS * NTREES / seconds,
                score_s=score_s, peak_gib=peak, **prof)


def cuda_ms_auto(fn, budget_ms: float = 300.0, max_reps: int = 20) -> float:
    """:func:`cuda_ms` with as many repetitions as fit ``budget_ms`` (at
    least 2, at most ``max_reps``), from one timed warm-up call."""
    est = cuda_ms(fn, reps=1, warmup=1)
    return cuda_ms(fn, reps=int(min(max_reps, max(2, budget_ms // est))),
                   warmup=0)


def time_levels(what: str, binned_T, g, h, w, Bt: int, layouts,
                earlier: dict | None = None) -> list:
    """The kernel, its plain version and one ``index_add_`` computing the
    same function, timed at each ``(level, N, node)`` layout of a path,
    beside the bound (each input once: the bins once for all classes),
    ``earlier`` ms by level (an earlier kernel's, from PERF.md, printed
    only), the other kernel's time in the same run and, printed only at the
    global kernel's levels, its update bound (one
    16-byte reduction per active (row, feature) at ``RED_V4_PER_S``, a rate
    this run does not measure)."""
    from h2o3_tpu_torch.ops.hist import (_launch, hist_bytes, hist_flops,
                                         launch_plan,
                                         level_histograms,
                                         level_histograms_plain)
    F, R = binned_T.shape
    K = g.shape[0] if g.dim() == 2 else 1
    rows = []
    for level, N, node in layouts:
        active = int((node >= 0).sum())
        calls = dict(level_histograms.kernel_launches)
        ms = cuda_ms_auto(lambda: level_histograms(binned_T, node, g, h, w, N,
                                                   Bt))
        plain_ms = cuda_ms(lambda: level_histograms_plain(
            binned_T, node, g, h, w, N, Bt), reps=2, warmup=1)
        # the yardstick: one index_add_ of the stats of every active (class,
        # feature, row) onto flattened (class, feature, node, bin) ids
        nk = node.reshape(K, 1, R)
        act = (nk >= 0).expand(K, F, R).reshape(-1)
        cls = torch.arange(K, device="cuda").reshape(K, 1, 1)
        fid = torch.arange(F, device="cuda").reshape(1, F, 1)
        ids = (((cls * F + fid) * N + nk.long()) * Bt
               + binned_T.long()[None]).reshape(-1)[act]
        src = torch.stack([g.reshape(K, 1, R).expand(K, F, R),
                           h.reshape(K, 1, R).expand(K, F, R),
                           w.reshape(-1, 1, R).expand(K, F, R)],
                          -1).reshape(-1, 3)[act]
        del act
        library_ms = cuda_ms(lambda: torch.zeros(
            (K * F * N * Bt, 3), device="cuda").index_add_(0, ids, src),
            reps=3, warmup=1)
        del ids, src
        # timing launches are not counted
        level_histograms.kernel_launches = dict(calls)
        nbytes = hist_bytes(R, F, N, Bt, binned_T.element_size(), K,
                            w.dim() == 2)
        flops = hist_flops(active, F)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / F32_FLOPS_PER_S else "operations")
        plan = launch_plan(binned_T, N, Bt, K=K)
        update_ms = None
        if plan["kernel"] == "global":
            update_ms = active * F / RED_V4_PER_S * 1e3
        # the other kernel, for the switch
        other_ms = {k: cuda_ms_auto(lambda k=k: _launch(
            binned_T, node, g, h, w, N, Bt, k))
            for k in ("fixed", "global") if k != plan["kernel"]}
        level_histograms.kernel_launches = dict(calls)
        before = earlier.get(level) if earlier else None
        print(f"hist {what} level {level} N={N} K={K} active={active}: kernel "
              f"{ms:.4f} ms"
              + (f" (first kernel {before:.4f} ms)" if before else "")
              + f", {100 * bound_ms / ms:.1f}% of bound "
              f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB)"
              + (f", update bound {update_ms:.4f} ms" if update_ms else "")
              + "".join(f"; {k} {v:.4f} ms" for k, v in other_ms.items()) +
              f"; plain {plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms; "
              f"plan {plan['kernel']} groups={plan['groups']} "
              f"Nb={plan['nodes_per_block']} "
              f"node_blocks={plan['node_blocks']} smem={plan['smem_bytes']} B "
              f"blocks={plan['blocks']}"
              + (f" qbits={plan['qbits']}" if "qbits" in plan else ""))
        rows.append(dict(level=level, N=N, active_rows=active,
                         kernel=plan["kernel"], ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bound_share=bound_ms / ms,
                         **{f"{k}_ms": v for k, v in other_ms.items()}))
    return rows


def phase_new_path_times() -> dict:
    """Phase 6's kernel times at each new path's level shapes: the
    multinomial levels (K = 3, shared w) and the XGBoost levels (257 int16
    bins) of one tree, and every DRF level (1 to 4096 nodes)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    Bt = NBINS + 1
    out = {}
    binned_T, _, g, h, w = batch_inputs(ROWS, NFEAT, Bt, 1, torch.int8, gen,
                                        3, False)
    layouts = []
    for level in range(DEPTH):
        per_class = [level_nodes(ROWS, level, gen) for _ in range(3)]
        layouts.append((level, per_class[0][0],
                        torch.stack([n for _, n in per_class])))
    out["multinomial_k3"] = time_levels("multinomial K=3", binned_T, g, h, w,
                                        Bt, layouts)
    del layouts, g, h, w
    g, h, w = hist_inputs(ROWS, 1, 2, 1, torch.int8, gen)[2:]
    out["drf_depth14"] = time_levels(
        "DRF", binned_T, g, h, w, Bt,
        [(level, *level_nodes(ROWS, level, gen))
         for level in range(DRF_DEPTH)])
    del binned_T
    binned_T = torch.randint(0, XGB_BINS + 1, (NFEAT, ROWS), generator=gen,
                             device="cuda").to(torch.int16)
    out["xgboost_257"] = time_levels(
        "XGBoost", binned_T, g, h, w, XGB_BINS + 1,
        [(level, *level_nodes(ROWS, level, gen)) for level in range(DEPTH)],
        dict(enumerate(ATOMIC_KERNEL_MS)))
    out["fixed_split"] = fixed_split(binned_T, g, h, w, XGB_BINS + 1, gen)
    del binned_T, g, h, w
    torch.cuda.empty_cache()
    return out


def fixed_split(binned_T, g, h, w, Bt: int, gen) -> dict:
    """Device ms of the fixed kernel's two launches at XGBoost's level 0,
    the scale reduction and the histogram kernel, from torch.profiler over
    five calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from h2o3_tpu_torch.ops.hist import _launch
    N, node = level_nodes(binned_T.shape[1], 0, gen)
    _launch(binned_T, node, g, h, w, N, Bt, "fixed")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            _launch(binned_T, node, g, h, w, N, Bt, "fixed")
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in ("fixed_scale_kernel", "fixed_hist_kernel"):
            if name in e.key and e.device_type == DeviceType.CUDA:
                out[name] = e.device_time_total / 1e3 / e.count
    print(f"fixed kernel at XGBoost level 0, device ms a launch: {out}")
    return out


def kernel_entry(launches: int, max_err: float, times: list,
                 name: str = "level_histograms",
                 replaces: str = "h2o3_tpu/ops/pallas_hist.py:179",
                 **extra) -> dict:
    """One object of the ``kernels`` line: per launch, averaged over the
    path's timed level shapes."""
    mean = lambda k: sum(r[k] for r in times) / len(times)
    return dict(
        name=name, route="cuda",
        source="h2o3_tpu_torch/csrc/hist.cu",
        replaces=replaces,
        launches=launches, max_abs_err=max_err,
        ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in times)
        else "operations", library_ms=mean("library_ms"),
        bound_share=mean("bound_ms") / mean("ms"), **extra,
        levels=[{k: r[k] for k in r
                 if k not in ("bound_by", "bytes", "flops", "gbps")
                 and r[k] is not None} for r in times])


# -- the skewed-stats repair, node totals and the categorical path -------

#: the node-totals instance's TPU-side counterpart: not a TPU kernel, the
#: reference's segment_sum of the final level
TOTALS_REPLACES = "h2o3_tpu/models/tree.py:151 (_node_totals, not a TPU kernel)"


def skewed_stats(R: int, case: str, gen: torch.Generator) -> tuple:
    """Fault C.1's stats on the card: (a) g normal with 5 rows at 1e4, h = w
    = 1; (b) g, h of a bernoulli logit (normal, sd 1.5), w uniform in
    [0.05, 1] with 5 rows at 1e3; (c) (a) without the outliers."""
    dev = "cuda"
    rows = torch.randperm(R, generator=gen, device=dev)[:5]
    if case in "ac":
        g = torch.randn(R, generator=gen, device=dev)
        if case == "a":
            g[rows] = 1e4
        return g, torch.ones(R, device=dev), torch.ones(R, device=dev)
    p = torch.sigmoid(1.5 * torch.randn(R, generator=gen, device=dev))
    y = (torch.rand(R, generator=gen, device=dev) < p).float()
    w = 0.05 + 0.95 * torch.rand(R, generator=gen, device=dev)
    w[rows] = 1e3
    return (w * (p - y)).contiguous(), (w * p * (1 - p)).contiguous(), w


def check_totals(node, g, h, w, N: int, what: str,
                 against_plain: bool = True) -> float:
    """The node-totals instance at one shape: two launches bit for bit
    equal, equal bit for bit to its emulation, within the check of the
    plain version (unless ``against_plain`` is False, as for skewed stats)
    and of float64 sums. Returns the max abs err against the plain
    version, or else against float64 sums."""
    from h2o3_tpu_torch.ops import hist
    calls = hist.node_totals.launches
    got = hist.node_totals(node, g, h, w, N)
    again = hist.node_totals(node, g, h, w, N)
    hist.node_totals.launches = calls      # checking launches do not count
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    as_emu = torch.equal(got.view(torch.int32), hist.node_totals_fixed_plain(
        node, g, h, w, N).view(torch.int32))
    err = (check_hist(got, hist.node_totals_plain(node, g, h, w, N),
                      f"{what} [node totals]") if against_plain else None)
    err64 = check_hist(got, hist.node_totals_plain(
        node, g.double(), h.double(), w.double(), N),
        f"{what} [node totals] against float64 sums")
    if err is None:
        err = err64
    print(f"  node totals {what}: two launches bit-identical {same}, equal "
          f"to the emulation {as_emu}")
    if not (same and as_emu):
        raise AssertionError(f"node totals at {what}")
    return err


def phase_skewed_checks() -> dict:
    """Phase 2's checks of fault C.1's repair and of the node totals: the
    fixed kernel on skewed stats (cases (a), (b), (c) of
    :func:`skewed_stats`) at 2M rows (levels 0, 4 and 6) and 11M rows
    (every level the plan gives it at 65 bins, 0-6), 28 int8 features,
    through :func:`check_fixed` (bit for bit across two launches and
    against its emulation, within the check of the plain version and of
    float64 sums, within its stated bound); then the node-totals instance
    at the main path's final level (64 nodes, 11M rows), at K = 3 and on
    cases (a) and (b). Returns the largest errors and bound ratio."""
    from h2o3_tpu_torch.ops import hist
    gen = torch.Generator(device="cuda").manual_seed(23)
    Bt = NBINS + 1
    out = dict(err=0.0, bound_ratio=0.0, totals_err=0.0)
    for R, levels in ((2_000_000, (0, 4, 6)), (ROWS, range(7))):
        binned_T = torch.randint(0, Bt, (NFEAT, R), generator=gen,
                                 device="cuda").to(torch.int8)
        for case in "abc":
            g, h, w = skewed_stats(R, case, gen)
            for level in levels:
                N, node = level_nodes(R, level, gen)
                if hist.launch_plan(binned_T, N, Bt)["kernel"] != "fixed":
                    raise AssertionError(f"level {level}: not the fixed kernel")
                r = check_fixed((binned_T, node, g, h, w), N, Bt,
                                f"C.1 case ({case}) R={R} level {level} "
                                f"N={N}", against_plain=False)
                for k in ("err", "bound_ratio"):
                    out[k] = max(out[k], r[k])
                del node
            del g, h, w
        del binned_T
    dev = "cuda"
    N = 2 ** DEPTH
    node = torch.randint(-1, N, (1, ROWS), generator=gen, device=dev,
                         dtype=torch.int32)
    for case in "abc":
        g, h, w = skewed_stats(ROWS, case, gen)
        out["totals_err"] = max(out["totals_err"], check_totals(
            node, g[None], h[None], w, N,
            f"R={ROWS} N={N} final level, case ({case})",
            against_plain=case == "c"))
    node3 = torch.randint(-1, N, (3, ROWS), generator=gen, device=dev,
                          dtype=torch.int32)
    g3 = torch.randn((3, ROWS), generator=gen, device=dev)
    h3 = torch.rand((3, ROWS), generator=gen, device=dev) + 0.1
    out["totals_err"] = max(out["totals_err"], check_totals(
        node3, g3, h3, torch.ones(ROWS, device=dev), N,
        f"R={ROWS} N={N} K=3 w shared"))
    del node, node3, g3, h3
    torch.cuda.empty_cache()
    return out


def skewed_cols(case: str, rows: int) -> dict:
    """tests/test_torch_skewed_gbm.py's frame columns: 28 normal features
    from default_rng(11) and (a) y = x0 + 0.5 x1^2 + 0.3 N(0, 1) with 5
    rows at 1e4, (b) a bernoulli logit of the first four features with
    weights in [0.05, 1] and 5 rows at 1e3, (c) (a) without the
    outliers."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((NFEAT, rows), dtype=np.float32)
    cols = {f"x{i}": X[i] for i in range(NFEAT)}
    logit = np.array([1.2, -0.8, 0.5, 0.3], np.float32) @ X[:4]
    out = rng.choice(rows, 5, replace=False)
    if case in "ac":
        y = (X[0] + 0.5 * X[1] ** 2
             + 0.3 * rng.normal(size=rows)).astype(np.float32)
        if case == "a":
            y[out] = 1e4
        cols["y"] = y
    else:
        cols["y"] = np.where(rng.random(rows) < 1 / (1 + np.exp(-logit)),
                             "s", "b")
        w = rng.uniform(0.05, 1, rows).astype(np.float32)
        w[out] = 1e3
        cols["w"] = w
    return cols


def tie_aware_differences(cpu, card, ties: list, depth: int) -> tuple:
    """Heap nodes whose split differs between two models' trees, walking
    each tree from its root: (differing nodes, differing nodes where the
    CPU's split search tied two candidates exactly, whose subtrees are not
    compared). ``ties`` holds :func:`tree.tied_splits` of each level of the
    CPU run, in call order."""
    differ, tied = [], []
    for t, (a, b) in enumerate(zip(_tree_sets(cpu)[0], _tree_sets(card)[0])):
        alike = torch.stack([getattr(a, k).cpu() == getattr(b, k).cpu()
                             for k in SPLIT_KEYS]).all(0)
        todo = [0]
        while todo:
            i = todo.pop()
            d = int(np.log2(i + 1))
            if d >= depth:
                continue
            if not alike[i]:
                (tied if bool(ties[t * depth + d][i - (2 ** d - 1)])
                 else differ).append((t, i))
            elif bool(a.is_split[i]):
                todo += [2 * i + 1, 2 * i + 2]
    return differ, tied


def cross_device_ties(what: str, make_frame, make, x, y: str, metric: str,
                      depth: int) -> dict:
    """A model trained on the CPU (plain path) and on the card (kernels):
    alike at every split node, where the CPU's split search did not tie
    two candidates exactly; the training ``metric`` within 1e-4 of it (of
    1 or of the metric, whichever is larger: an outlier's squared error
    makes the MSE large) and the margins within atol 1e-4 plus rtol 1e-5
    (an outlier's leaf is large). Returns the card's launches."""
    from h2o3_tpu_torch.models import tree
    from h2o3_tpu_torch.ops.hist import level_histograms, node_totals
    ties, find = [], tree._find_splits

    def recording(hists, *a, **kw):
        ties.append(tree.tied_splits(hists, *a, **kw).cpu())
        return find(hists, *a, **kw)

    models, margins = {}, {}
    for dev in ("cpu", "cuda"):
        fr = make_frame(dev)
        reset_launches()
        node_totals.launches = 0
        tree._find_splits = recording if dev == "cpu" else find
        t0 = time.perf_counter()
        try:
            models[dev] = make().train(x=x, y=y, training_frame=fr)
        finally:
            tree._find_splits = find
        margins[dev] = _margins(models[dev], fr).cpu()
        print(f"cross-device {what} on {dev}: "
              f"{time.perf_counter() - t0:.2f} s, {metric} "
              f"{getattr(models[dev].training_metrics, metric):.6f}, "
              f"launches {dict(level_histograms.kernel_launches)}, node "
              f"totals {node_totals.launches}")
        del fr
    launches = dict(level_histograms.kernel_launches,
                    node_totals=node_totals.launches)
    differ, tied = tie_aware_differences(models["cpu"], models["cuda"], ties,
                                         depth)
    d_metric = abs(getattr(models["cpu"].training_metrics, metric)
                   - getattr(models["cuda"].training_metrics, metric))
    d_margin = float((margins["cpu"] - margins["cuda"]).abs().max())
    close = torch.allclose(margins["cuda"], margins["cpu"], rtol=1e-5,
                           atol=1e-4)
    scale = max(1.0, abs(getattr(models["cpu"].training_metrics, metric)))
    print(f"cross-device {what}: split nodes that differ {differ}, differing "
          f"at the CPU's exact ties {tied}; |d{metric}| {d_metric:.2e}, max "
          f"|dmargin| {d_margin:.2e}")
    if differ or d_metric >= 1e-4 * scale or not close:
        raise AssertionError(f"card and CPU {what} disagree")
    return launches


#: the airlines-shaped frame (szilard/benchm-ml's airlines GBM benchmark,
#: train-10m / test): categorical columns and their levels
AIRLINE_CATS = {"Month": 12, "DayofMonth": 31, "DayOfWeek": 7,
                "UniqueCarrier": 22, "Origin": 300, "Dest": 300}
AIRLINE_X = list(AIRLINE_CATS) + ["DepTime", "Distance"]
AIRLINE_Y = "dep_delayed_15min"
AIRLINE_ROWS, AIRLINE_VALID = 10_000_000, 100_000


def _airline_domain(name: str, card: int) -> tuple:
    """Sorted level names: c-1 ... for the calendar columns, two-letter
    carrier codes, three-letter airport codes."""
    if name in ("Origin", "Dest"):
        letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        levels = [a + b + c for a in letters for b in letters
                  for c in letters][5::58][:card]
    elif name == "UniqueCarrier":
        levels = [a + b for a in "ABCDEFGHIJ" for b in "AEIOU"][:card]
    else:
        levels = [f"c-{i + 1}" for i in range(card)]
    return tuple(sorted(levels))


def airlines_arrays(rows: int, seed: int) -> dict:
    """An airlines-shaped frame's columns from ``seed``: categorical codes
    of AIRLINE_CATS (Origin and Dest with Zipf-like frequencies, 1/rank^1.1
    over a fixed shuffle of the airports), DepTime (hhmm, 5:00 to 23:59),
    Distance (log-normal miles, 30 to 4983) and dep_delayed_15min (about
    19% Y) from a logit with per-level effects, a term rising in DepTime
    and one in Distance. The effects come from a fixed generator, so a
    validation frame from another seed shares them."""
    rng = np.random.default_rng(seed)
    eff = np.random.default_rng(101)
    cols = {}
    logit = np.full(rows, -1.8, np.float32)
    for name, card in AIRLINE_CATS.items():
        if name in ("Origin", "Dest"):
            p = 1.0 / np.arange(1, card + 1) ** 1.1
            p = (p / p.sum())[eff.permutation(card)]
            codes = rng.choice(card, rows, p=p).astype(np.int32)
        else:
            codes = rng.integers(0, card, rows, dtype=np.int32)
        logit += eff.normal(scale=0.3, size=card).astype(np.float32)[codes]
        cols[name] = codes
    dep = (rng.integers(5, 24, rows) * 100
           + rng.integers(0, 60, rows)).astype(np.float32)
    dist = np.clip(np.round(np.exp(rng.normal(6.4, 0.6, rows))), 30,
                   4983).astype(np.float32)
    logit += 0.0008 * (dep - 1300) + 0.0001 * (dist - 700)
    cols["DepTime"], cols["Distance"] = dep, dist
    cols[AIRLINE_Y] = (rng.random(rows) < 1 / (1 + np.exp(-logit))).astype(
        np.int32)
    return cols


def airlines_frame(cols: dict, device):
    """The columns as a Frame: categorical codes with their domains (no
    strings are factorised), numeric float32."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.types import VecType
    from h2o3_tpu_torch.frame.vec import Vec
    vecs = []
    for name, v in cols.items():
        t = torch.from_numpy(v).to(device)
        if name in AIRLINE_CATS:
            vecs.append(Vec(t, VecType.CAT,
                            domain=_airline_domain(name, AIRLINE_CATS[name])))
        elif name == AIRLINE_Y:
            vecs.append(Vec(t, VecType.CAT, domain=("N", "Y")))
        else:
            vecs.append(Vec(t, VecType.NUM))
    return Frame(list(cols), vecs)


#: rows of phase 3's C.1 GBMs, trained on the CPU and on the card
C1_GBM_ROWS = 500_000


def phase_cross_device_new() -> dict:
    """Phase 3's new models, CPU (plain path) against the card: fault C.1's
    GBMs (cases (a), (b), (c) at 500k rows, depth 6, 64 bins, 3 trees;
    levels 0 and 1 keep 15 bits a value as at 2M rows, levels 2-5 one more
    bit, and the CPU side takes a quarter of 2M rows' 140-180 s) and a
    100k-row airlines-shaped GBM with group splits (Origin and Dest range-
    grouped into 64 bins), a monotone DepTime and interaction sets
    {Origin, Dest} and {DepTime, Distance}."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.gbm import GBM
    out = {}
    for case in "abc":
        cols = skewed_cols(case, C1_GBM_ROWS)
        out[case] = cross_device_ties(
            f"C.1 case ({case}) GBM {C1_GBM_ROWS} x 28",
            lambda dev: Frame.from_arrays(cols, device=dev),
            lambda: GBM(ntrees=3, max_depth=DEPTH, nbins=NBINS,
                        learn_rate=0.1, seed=42,
                        weights_column="w" if case == "b" else None),
            [f"x{i}" for i in range(NFEAT)], "y",
            "auc" if case == "b" else "mse", DEPTH)
        del cols
    cols = airlines_arrays(100_000, 41)
    out["airlines"] = cross_device_ties(
        "airlines-shaped GBM 100k, group splits and constraints",
        lambda dev: airlines_frame(cols, dev),
        lambda: GBM(ntrees=5, max_depth=DEPTH, nbins=NBINS, learn_rate=0.1,
                    seed=42, monotone_constraints={"DepTime": 1},
                    interaction_constraints=[["Origin", "Dest"],
                                             ["DepTime", "Distance"]]),
        AIRLINE_X, AIRLINE_Y, "auc", DEPTH)
    return out


def _heaps_bitwise(a, b) -> bool:
    """Every heap field and left mask of every tree equal bit for bit."""
    from h2o3_tpu_torch.models.tree import HEAP_FIELDS
    for ta, tb in zip(_tree_sets(a), _tree_sets(b)):
        if len(ta) != len(tb):
            return False
        for x, y in zip(ta, tb):
            for f in HEAP_FIELDS + ("left_mask",):
                u, v = getattr(x, f), getattr(y, f)
                if (u is None) != (v is None) or (
                        u is not None and not torch.equal(u, v)):
                    return False
    return True


def airlines_frames() -> tuple:
    """Phase 7's frames (phase 8b's too): an airlines-shaped training frame
    of 10M rows and a validation frame of 100k, built on the host from
    seeds."""
    t0 = time.perf_counter()
    fr = airlines_frame(airlines_arrays(AIRLINE_ROWS, 31), "cuda")
    vf = airlines_frame(airlines_arrays(AIRLINE_VALID, 32), "cuda")
    torch.cuda.synchronize()
    share = float(fr.vec(AIRLINE_Y).data.float().mean())
    print(f"airlines-shaped frames {AIRLINE_ROWS} + {AIRLINE_VALID} rows on "
          f"the card: {time.perf_counter() - t0:.2f} s, {100 * share:.1f}% "
          f"delayed")
    return fr, vf


def phase_airlines(fr, vf) -> dict:
    """Phase 7: the categorical path at full width on
    :func:`airlines_frames`; GBM with 64 bins (Origin and Dest
    range-grouped into 64), depth 6, learn rate 0.1, up to 300 trees, stopping_rounds 5 on the
    validation logloss (tolerance 1e-4) and a monotone DepTime. Warmed up,
    timed (launches held to the plan's per level, one node-totals launch a
    tree), profiled, scored; then the scored metric against the training
    one, predictions along a DepTime grid, a straight 20-tree run against
    a 10-tree run resumed to 20 (bit for bit), and the stopping point of a
    second run."""
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.ops.hist import (launch_count, level_histograms,
                                         node_totals)
    params = dict(ntrees=300, max_depth=DEPTH, nbins=NBINS, learn_rate=0.1,
                  stopping_rounds=5, stopping_metric="logloss",
                  stopping_tolerance=1e-4, monotone_constraints={"DepTime": 1},
                  seed=42)
    builders = []

    def train(**over):
        b = GBM(**dict(params, **over))
        builders.append(b)
        return b.train(x=AIRLINE_X, y=AIRLINE_Y, training_frame=fr,
                       validation_frame=vf)

    t0 = time.perf_counter()
    train(ntrees=10, stopping_rounds=0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_launches()
    node_totals.launches = 0
    t0 = time.perf_counter()
    model = train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    grown = builders[-1]._rounds_grown
    kept = model.output["ntrees"]
    by_kernel = dict(level_histograms.kernel_launches)
    totals = node_totals.launches
    expected = planned_launches(grown, DEPTH, NBINS + 1, 1)
    tm, vm = model.training_metrics, model.validation_metrics
    print(f"airlines GBM {AIRLINE_ROWS} x {len(AIRLINE_X)} ({', '.join(AIRLINE_X)}): "
          f"warm-up {warm_s:.2f} s, timed {seconds:.3f} s, "
          f"{AIRLINE_ROWS * grown / seconds:.4g} rows*trees/s, {grown} trees "
          f"grown, {kept} kept; launches {launch_count()} {by_kernel} "
          f"(plan {expected}), node totals {totals}; training AUC "
          f"{tm.auc:.6f} logloss {tm.logloss:.6f}, validation AUC "
          f"{vm.auc:.6f} logloss {vm.logloss:.6f}")
    again = []
    prof = profile_training(lambda: again.append(train()), seconds)
    t0 = time.perf_counter()
    scored = model.model_performance(fr)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    # predictions along DepTime, every other column held
    k = 49
    grid = {name: np.full(k, AIRLINE_CATS[name] // 3, np.int32)
            for name in AIRLINE_CATS}
    grid.update(DepTime=np.linspace(0, 2400, k).astype(np.float32),
                Distance=np.full(k, 700.0, np.float32))
    grid[AIRLINE_Y] = np.zeros(k, np.int32)
    pgrid = model.predict(airlines_frame(grid, "cuda")).vec("pY").data.cpu()
    rises = float(torch.diff(pgrid).min())
    # checkpoint: 10 trees resumed to 20 against 20 straight
    base = dict(ntrees=20, stopping_rounds=0)
    straight = train(**base)
    half = train(ntrees=10, stopping_rounds=0)
    resumed = train(checkpoint=half, **base)
    same_trees = _heaps_bitwise(straight, resumed)
    same_margins = torch.equal(_margins(straight, fr), _margins(resumed, fr))
    same_metrics = (straight.training_metrics.logloss
                    == resumed.training_metrics.logloss)
    print(f"airlines: scored logloss {scored.logloss:.6f} AUC "
          f"{scored.auc:.6f} in {score_s:.3f} s; along DepTime the least "
          f"step of p(Y) is {rises:.3e}; checkpoint 10 + 10 against 20: "
          f"trees bit-identical {same_trees}, margins {same_margins}, "
          f"training logloss {same_metrics}; a second run kept "
          f"{again[0].output['ntrees']} trees")
    if by_kernel != expected or totals != grown:
        raise AssertionError(f"airlines: launches {by_kernel}, node totals "
                             f"{totals}, expected {expected} and {grown}")
    if not (abs(scored.logloss - tm.logloss) < 1e-4
            and abs(scored.auc - tm.auc) < 1e-4):
        raise AssertionError("airlines: scored metrics differ from training")
    if rises < -1e-6:
        raise AssertionError(f"airlines: p(Y) falls along DepTime: {pgrid}")
    if not (same_trees and same_margins and same_metrics):
        raise AssertionError("airlines: the resumed run differs")
    if again[0].output["ntrees"] != kept:
        raise AssertionError(f"airlines: stopping kept {kept} then "
                             f"{again[0].output['ntrees']} trees")
    if not (np.isfinite(vm.logloss) and vm.auc > 0.6):
        raise AssertionError(f"airlines: validation metrics {vm}")
    del model, again, straight, half, resumed, builders
    torch.cuda.empty_cache()
    return dict(seconds=seconds, trees_grown=grown, trees_kept=kept,
                rows_trees_per_s=AIRLINE_ROWS * grown / seconds,
                by_kernel=by_kernel, node_totals=totals,
                train_auc=tm.auc, train_logloss=tm.logloss,
                valid_auc=vm.auc, valid_logloss=vm.logloss, **prof)


# -- phase 8: GLM on the card ------------------------------------------------

#: bench.py:146 bench_glm: 1M x 12 normal features from seed 13, binomial
GLM_ROWS, GLM_FEAT, GLM_Y = 1_000_000, 12, "dep_delayed"
#: rows of the CPU-against-card checks of 8c and 8e
GLM_CHECK_ROWS = 200_000


def glm_bench_cols(rows: int) -> dict:
    """bench.py:146-161's data: 12 normal features from default_rng(13),
    y from a logit of the first five."""
    rng = np.random.default_rng(13)
    X = rng.normal(size=(rows, GLM_FEAT)).astype(np.float32)
    logit = X[:, :5] @ np.array([0.8, -0.5, 0.3, -0.2, 0.4], np.float32)
    y = rng.random(rows) < 1.0 / (1.0 + np.exp(-logit))
    cols = {f"x{i}": X[:, i] for i in range(GLM_FEAT)}
    cols[GLM_Y] = np.where(y, "YES", "NO")
    return cols


def count_syncs(fn):
    """``fn()`` under torch's sync debug mode: every operation that makes
    the host wait for the card warns, and the warnings are counted by the
    source line that issued them. Returns (result, {"file:line": n})."""
    import warnings
    from collections import Counter
    from pathlib import Path
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, dict(Counter(f"{Path(r.filename).name}:{r.lineno}"
                             for r in rec if "synchroniz" in str(r.message)))


def loop_syncs(sites: dict) -> int:
    """The syncs issued from inside GLM._irls_fit (the IRLS loop's fetch
    and the L1 pass's)."""
    import inspect
    from h2o3_tpu_torch.models.glm import GLM
    lines, start = inspect.getsourcelines(GLM._irls_fit)
    return sum(n for site, n in sites.items()
               if site.startswith("glm.py:")
               and start <= int(site.split(":")[1]) < start + len(lines))


def glm_agree(what: str, a, b, ra, rb, coef: bool = True,
              pred_rtol: float = 1e-5, pred_atol: float | None = None
              ) -> dict:
    """Two fits of one GLM (CPU and card) held to the CPU tests'
    tolerances: iterations equal, deviance rtol 1e-5, coefficients rtol
    1e-4 with an atol of 1e-5 x max|beta|, outputs ``ra``/``rb``
    (predictions) rtol 1e-5 with an atol of 1e-6 x max(1, max|ra|)."""
    if pred_atol is None:
        pred_atol = 1e-6 * max(1.0, float(np.abs(ra).max()))
    ba, bb = (m.output["beta"].cpu().numpy() for m in (a, b))
    dbeta = float(np.abs(ba - bb).max())
    dpred = float(np.abs(ra - rb).max())
    dev_a, dev_b = a.output["residual_deviance"], b.output["residual_deviance"]
    print(f"  {what}: iterations {a.output['iterations']} / "
          f"{b.output['iterations']}, deviance {dev_a:.6f} / {dev_b:.6f}, "
          f"max |dbeta| {dbeta:.3e} (max |beta| {np.abs(ba).max():.3g}), "
          f"max |dpred| {dpred:.3e}")
    if a.output["iterations"] != b.output["iterations"]:
        raise AssertionError(f"GLM {what}: iterations differ")
    np.testing.assert_allclose(dev_b, dev_a, rtol=1e-5, err_msg=what)
    if coef:
        np.testing.assert_allclose(bb, ba, rtol=1e-4,
                                   atol=1e-5 * np.abs(ba).max(),
                                   err_msg=what)
    np.testing.assert_allclose(rb, ra, rtol=pred_rtol, atol=pred_atol,
                               err_msg=what)
    return dict(check_iterations=a.output["iterations"], max_dbeta=dbeta,
                max_dpred=dpred)


def phase_glm_bench() -> dict:
    """Phase 8a: bench_glm's configuration at full size (1M x 12 binomial,
    lambda 1e-4, max_iterations 30) on the CPU and on the card, timed
    warm, twice more for bit-identity, with TF32 allowed, under the sync
    counter and under torch.profiler."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.glm import GLM
    cols = glm_bench_cols(GLM_ROWS)
    fr = Frame.from_arrays(cols, device="cuda")
    params = dict(family="binomial", lambda_=1e-4, max_iterations=30)

    def fit(frame):
        return GLM(**params).train(y=GLM_Y, training_frame=frame)

    t0 = time.perf_counter()
    cpu = fit(Frame.from_arrays(cols, device="cpu"))
    cpu_s = time.perf_counter() - t0
    fit(fr)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = fit(fr)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    again = fit(fr)
    repeat = torch.equal(card.output["beta"], again.output["beta"])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = fit(fr)
        X = torch.stack([fr.vec(f"x{i}").data for i in range(GLM_FEAT)], 1)
        g_tf32 = X.T @ X
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    g_full = X.T @ X
    tf32_raw = float(((g_tf32 - g_full).abs() / g_full.abs().clamp_min(
        1e-30)).max())
    tf32_same = torch.equal(card.output["beta"], tf32.output["beta"])
    _, sites = count_syncs(lambda: fit(fr))
    iters = card.output["iterations"]
    in_loop = loop_syncs(sites)
    prof = profile_training(lambda: fit(fr), seconds)
    agree = glm_agree("8a CPU / card", cpu, card,
                      cpu.training_metrics.auc, card.training_metrics.auc,
                      pred_rtol=0, pred_atol=1e-4)
    print(f"GLM 8a (bench_glm) {GLM_ROWS} x {GLM_FEAT} binomial: {iters} "
          f"iterations, timed {seconds:.4f} s ({seconds / iters:.4f} s an "
          f"iteration, {GLM_ROWS * iters / seconds:.4g} rows*iterations/s; "
          f"CPU {cpu_s:.2f} s), AUC card {card.training_metrics.auc:.6f} "
          f"CPU {cpu.training_metrics.auc:.6f}; coefficients repeat bit for "
          f"bit {repeat}; TF32 allowed: coefficients bit-identical "
          f"{tf32_same} (a plain TF32 X'X differs by up to {tf32_raw:.2e} "
          f"relative); host syncs {sum(sites.values())} in all, {in_loop} "
          f"in the IRLS loop ({in_loop / iters:.2f} an iteration): {sites}")
    if not (repeat and tf32_same):
        raise AssertionError("GLM 8a: coefficients differ between runs or "
                             "with TF32 allowed")
    del fr, X, g_tf32, g_full
    return dict(seconds=seconds, iterations=iters,
                rows_iters_per_s=GLM_ROWS * iters / seconds,
                s_per_iteration=seconds / iters, cpu_seconds=cpu_s,
                auc=card.training_metrics.auc,
                auc_cpu=cpu.training_metrics.auc, repeat_bitwise=repeat,
                tf32_bitwise=tf32_same, tf32_raw_gram_rel=tf32_raw,
                host_syncs=sum(sites.values()),
                host_syncs_per_iteration=in_loop / iters, **agree, **prof)


def glm_lambda_search() -> dict:
    """Phase 8d: lambda search on 8a's frame (alpha 0.5, 30 lambdas)."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.glm import GLM
    fr = Frame.from_arrays(glm_bench_cols(GLM_ROWS), device="cuda")

    def fit():
        return GLM(family="binomial", alpha=0.5, lambda_search=True,
                   nlambdas=30).train(y=GLM_Y, training_frame=fr)

    fit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _, sites = count_syncs(fit)
    path = model.get_regularization_path()
    n = len(path)
    total = sum(sites.values())
    print(f"GLM 8d lambda search {GLM_ROWS} x {GLM_FEAT}, alpha 0.5, 30 "
          f"lambdas: path of {n} (best lambda {model.output['lambda_best']:.4g}"
          f", {path[-1]['nonzero']} nonzero at the last), {seconds:.3f} s, "
          f"{total} host syncs ({total / n:.2f} a lambda): {sites}")
    if not (2 <= n <= 30 and all(np.isfinite(e["deviance"]) for e in path)):
        raise AssertionError(f"GLM 8d: path {path}")
    return dict(seconds=seconds, path_length=n, host_syncs=total,
                host_syncs_per_lambda=total / n,
                lambda_best=model.output["lambda_best"])


def fp32_peak() -> tuple:
    """The card's float32 rate outside the tensor cores: SMs x 128 lanes x
    2 (a fused multiply-add) x the SM clock (``clock_rate`` of the device
    properties where torch gives it, else nvidia-smi's clocks.max.sm)."""
    props = torch.cuda.get_device_properties(0)
    khz = getattr(props, "clock_rate", None)
    src = "device properties"
    if not khz:
        mhz = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0]
        khz, src = float(mhz) * 1e3, "nvidia-smi clocks.max.sm"
    return props.multi_processor_count * 128 * 2 * khz * 1e3, src


def phase_glm_airlines(fr, vf) -> dict:
    """Phase 8b: the airlines logistic GLM at full width on phase 7's
    frames (10M rows, 6 categoricals one-hot into 666 columns, DepTime and
    Distance standardised; alpha 0.5, lambda 1e-5 so that the L1 pass
    runs), timed and once more under torch.profiler, then the Gram, the
    expansion, the Cholesky and one host pass of non_negative's coordinate
    descent timed apart."""
    from h2o3_tpu_torch.models.glm import (GLM, _nn_solve, _weighted_gram,
                                           full_fp32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = dict(family="binomial", alpha=0.5, lambda_=1e-5)

    def fit():
        return GLM(**params).train(x=AIRLINE_X, y=AIRLINE_Y,
                                   training_frame=fr, validation_frame=vf)

    t0 = time.perf_counter()
    model = fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_training(fit, seconds)
    di = model.data_info
    P = di.ncols_expanded
    t0 = time.perf_counter()
    scored = model.model_performance(fr)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    tm, vm = model.training_metrics, model.validation_metrics
    iters = model.output["iterations"]
    # the pieces, timed apart at the fit's shapes
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    X = di.expand(fr)
    end.record()
    torch.cuda.synchronize()
    expand_ms = start.elapsed_time(end)
    gen = torch.Generator(device="cuda").manual_seed(5)
    W = torch.rand(AIRLINE_ROWS, generator=gen, device="cuda") * 0.25
    z = torch.randn(AIRLINE_ROWS, generator=gen, device="cuda")
    nobs = torch.tensor(float(AIRLINE_ROWS), device="cuda")
    with full_fp32():
        gram_ms = cuda_ms(lambda: _weighted_gram(X, W, z, 1e-5, nobs, 1e-5),
                          reps=3, warmup=1)
        gram, _ = _weighted_gram(X, W, z, 1e-5, nobs, 1e-5)
    chol_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(gram), reps=20)
    # non_negative's coordinate descent runs on the host: one pass at P + 1
    rhs = torch.randn(P + 1, generator=gen, device="cuda")
    beta0 = torch.zeros(P + 1, device="cuda")
    t0 = time.perf_counter()
    _nn_solve(gram, rhs, beta0, max_passes=1)
    nn_pass_ms = (time.perf_counter() - t0) * 1e3
    peak, src = fp32_peak()
    bound_ms = 2.0 * AIRLINE_ROWS * P * P / peak * 1e3
    grams = iters + 10          # the IRLS steps and the L1 pass's ten
    print(f"GLM 8b airlines {AIRLINE_ROWS} x {len(AIRLINE_X)} -> P = {P} "
          f"expanded columns: {iters} iterations + the 10-step L1 pass "
          f"({grams} Gram builds), fit {seconds:.3f} s, peak memory "
          f"{peak_gb:.2f} GB; training AUC {tm.auc:.6f} logloss "
          f"{tm.logloss:.6f}, validation AUC {vm.auc:.6f} logloss "
          f"{vm.logloss:.6f}; scored logloss {scored.logloss:.6f} AUC "
          f"{scored.auc:.6f} in {score_s:.3f} s; expansion {expand_ms:.2f} "
          f"ms; Gram {gram_ms:.2f} ms against its bound {bound_ms:.2f} ms "
          f"(2RP^2 FLOP at {peak / 1e12:.2f} TFLOP/s float32 from {src}; "
          f"{100 * bound_ms / gram_ms:.1f}% of it); Cholesky {chol_ms:.3f} "
          f"ms ({P + 1}^2); one non_negative coordinate pass on the host "
          f"{nn_pass_ms:.2f} ms")
    if not (np.isfinite([tm.auc, tm.logloss, vm.auc, vm.logloss]).all()
            and vm.auc > 0.6):
        raise AssertionError(f"GLM 8b: metrics {tm} {vm}")
    if not (abs(scored.logloss - tm.logloss) < 1e-6
            and abs(scored.auc - tm.auc) < 1e-9):
        raise AssertionError("GLM 8b: scored metrics differ from training")
    del X, W, z, gram, rhs, beta0, model
    torch.cuda.empty_cache()
    return dict(rows=AIRLINE_ROWS, P=P, iterations=iters, seconds=seconds,
                peak_gb=peak_gb, train_auc=tm.auc, train_logloss=tm.logloss,
                valid_auc=vm.auc, valid_logloss=vm.logloss,
                scored_logloss=scored.logloss, expand_ms=expand_ms,
                gram_ms=gram_ms, gram_bound_ms=bound_ms,
                grams_per_fit=grams, cholesky_ms=chol_ms,
                nn_pass_ms=nn_pass_ms, fp32_tflops=peak / 1e12, **prof)


def phase_glm_multinomial(fr) -> dict:
    """Phase 8c: multinomial GLM on phase 4's 11M x 28 frame with phase
    6's 3-class label (lambda 1e-4, max_iterations 10), timed warm; then
    the CPU against the card on its first 200k rows."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.types import VecType
    from h2o3_tpu_torch.frame.vec import Vec
    from h2o3_tpu_torch.models.glm import GLM
    x = [f"x{i}" for i in range(NFEAT)]
    codes = multi_codes(fr.vec("x0").data, fr.vec("x1").data,
                        fr.vec("x2").data, np.random.default_rng(12))
    dom = ("c0", "c1", "c2")
    frm = Frame(x + ["c"], [fr.vec(c) for c in x]
                + [Vec.from_device(codes, VecType.CAT, domain=dom)])

    def fit(frame):
        return GLM(family="multinomial", lambda_=1e-4,
                   max_iterations=10).train(x=x, y="c", training_frame=frame)

    fit(frm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = fit(frm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sweeps = model.output["iterations"]
    n = GLM_CHECK_ROWS
    small = {c: fr.vec(c).data[:n] for c in x}
    small_c = codes[:n]
    fits = []
    for dev in ("cpu", "cuda"):
        f = Frame(x + ["c"], [Vec.from_device(small[c].to(dev).contiguous(),
                                              VecType.NUM) for c in x]
                  + [Vec.from_device(small_c.to(dev).contiguous(),
                                     VecType.CAT, domain=dom)])
        m = fit(f)
        fits.append((m, m._score_raw(f).cpu().numpy()))
    agree = glm_agree(f"8c multinomial {n} rows CPU / card", fits[0][0],
                      fits[1][0], fits[0][1], fits[1][1])
    ll_cpu = fits[0][0].training_metrics.logloss
    ll_card = fits[1][0].training_metrics.logloss
    tm = model.training_metrics
    print(f"GLM 8c multinomial {ROWS} x {NFEAT}, K = 3: {sweeps} sweeps in "
          f"{seconds:.3f} s ({seconds / sweeps:.4f} s a sweep), logloss "
          f"{tm.logloss:.6f}, mean per-class error "
          f"{tm.mean_per_class_error:.4f}; {n} rows: logloss CPU "
          f"{ll_cpu:.7f} card {ll_card:.7f}")
    if abs(ll_cpu - ll_card) > 1e-5 * ll_cpu or not np.isfinite(tm.logloss):
        raise AssertionError("GLM 8c: logloss")
    del frm, codes, model
    torch.cuda.empty_cache()
    return dict(seconds=seconds, sweeps=sweeps,
                s_per_sweep=seconds / sweeps, logloss=tm.logloss,
                check_logloss_cpu=ll_cpu, check_logloss_card=ll_card,
                **agree)


def glm_family_cols(rows: int) -> dict:
    """The 8e frame: six normal features, two categoricals (5 and 4
    levels), weights, an offset, and a response per family from one linear
    predictor (seed 17)."""
    rng = np.random.default_rng(17)
    X = rng.normal(size=(rows, 6)).astype(np.float32)
    cols = {f"x{i}": X[:, i] for i in range(6)}
    c1 = rng.integers(0, 5, rows)
    c2 = rng.integers(0, 4, rows)
    cols["c1"] = np.array(list("abcde"))[c1]
    cols["c2"] = np.array(list("pqrs"))[c2]
    eta = (0.6 * X[:, 0] - 0.4 * X[:, 1] + 0.3 * X[:, 2]
           + np.array([0.0, 0.4, -0.3, 0.2, 0.1])[c1])
    cols["w"] = rng.uniform(0.5, 2.0, rows).astype(np.float32)
    cols["off"] = (0.1 * rng.normal(size=rows)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-eta))
    mu = np.exp(0.3 * eta)
    cols["yb"] = np.where(rng.random(rows) < p, "Y", "N")
    cols["yg"] = (eta + rng.normal(size=rows)).astype(np.float32)
    cols["yp"] = rng.poisson(mu).astype(np.float32)
    cols["ygam"] = rng.gamma(2.0, mu / 2.0).astype(np.float32)
    cols["yt"] = (rng.gamma(2.0, mu / 2.0)
                  * (rng.random(rows) < 0.7)).astype(np.float32)
    cols["yq"] = np.clip(p + 0.1 * rng.normal(size=rows), 0, 1).astype(
        np.float32)
    lat = 1.1 * X[:, 0] - 0.6 * X[:, 2] + rng.logistic(size=rows)
    cols["yo"] = np.array(["1lo", "2mid", "3hi", "4top"])[
        np.digitize(lat, [-1.0, 0.2, 1.3])]
    return cols


#: phase 8e's fits: (what, x, y, params); the others of 8a-8d run on the
#: card only, against a CPU fit where they say so
NUM6 = [f"x{i}" for i in range(6)]
GLM_CASES = [
    ("gaussian, weights and offset", NUM6 + ["c1"], "yg",
     dict(family="gaussian", weights_column="w", offset_column="off")),
    ("poisson", NUM6 + ["c1"], "yp", dict(family="poisson")),
    ("gamma", NUM6 + ["c1"], "ygam", dict(family="gamma")),
    ("tweedie 1.5", NUM6 + ["c1"], "yt", dict(family="tweedie")),
    ("negativebinomial", NUM6 + ["c1"], "yp",
     dict(family="negativebinomial", theta=0.5)),
    ("quasibinomial", NUM6 + ["c1"], "yq", dict(family="quasibinomial")),
    ("binomial non_negative", NUM6 + ["c1"], "yb",
     dict(family="binomial", non_negative=True)),
    ("binomial beta_constraints", NUM6 + ["c1"], "yb",
     dict(family="binomial", beta_constraints={"x0": (-1, 0.4),
                                               "x2": (0.0, 0.1)})),
    ("binomial offset", NUM6 + ["c1"], "yb",
     dict(family="binomial", offset_column="off")),
    ("interactions cat x cat", NUM6, "yg",
     dict(family="gaussian", interactions=["c1", "c2"])),
    ("interactions cat x num", NUM6[:3] + ["c2"], "yg",
     dict(family="gaussian", interactions=["c1", "x3"])),
    ("p-values", NUM6 + ["c1"], "yg",
     dict(family="gaussian", compute_p_values=True)),
    ("ordinal, 200 Adam steps", NUM6 + ["c1"], "yo",
     dict(family="ordinal", max_iterations=10)),
]


def phase_glm_cross() -> dict:
    """Phase 8e: each of GLM_CASES on the CPU and on the card at 200k
    rows, and the sparse path on one COO, held to the CPU tests'
    tolerances."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.sparse import SparseFrame, SparseMatrix
    from h2o3_tpu_torch.frame.vec import Vec
    from h2o3_tpu_torch.models.glm import GLM
    t0 = time.perf_counter()
    cols = glm_family_cols(GLM_CHECK_ROWS)
    frames = {d: Frame.from_arrays(cols, device=d) for d in ("cpu", "cuda")}
    out = {}
    print(f"GLM 8e: CPU against the card at {GLM_CHECK_ROWS} rows")
    for what, x, y, params in GLM_CASES:
        fits = []
        for d in ("cpu", "cuda"):
            m = GLM(**params).train(x=x, y=y, training_frame=frames[d])
            fits.append((m, m._score_raw(frames[d]).cpu().numpy()))
        (a, ra), (b, rb) = fits
        if params["family"] == "ordinal":
            out[what] = glm_agree(what, a, b, ra, rb, coef=False,
                                  pred_rtol=0, pred_atol=1e-4)
        else:
            out[what] = glm_agree(what, a, b, ra, rb)
        if params.get("compute_p_values"):
            for k in ("std_errs", "z_values", "p_values"):
                np.testing.assert_allclose(b.output[k], a.output[k],
                                           rtol=1e-4, atol=1e-12, err_msg=k)
    # the sparse path: 200k x 500 at 1% density, binomial ridge
    rng = np.random.default_rng(19)
    nnz = GLM_CHECK_ROWS * 5
    rows = np.sort(rng.integers(0, GLM_CHECK_ROWS, nnz))
    colx = rng.integers(0, 500, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    eta = np.zeros(GLM_CHECK_ROWS, np.float32)
    np.add.at(eta, rows, vals * rng.normal(scale=0.5, size=500)[colx])
    yv = (eta + rng.logistic(size=GLM_CHECK_ROWS) > 0).astype(np.float32)
    fits = []
    for d in ("cpu", "cuda"):
        sf = SparseFrame(SparseMatrix.from_scipy_like(
            rows, colx, vals, GLM_CHECK_ROWS, 500, device=d),
            {"C0": Vec.from_numpy(yv, device=d)})
        m = GLM(family="binomial", lambda_=1e-3).train(y="C0",
                                                       training_frame=sf)
        fits.append((m, m._score_raw(sf).cpu().numpy()))
    out["sparse binomial"] = glm_agree("sparse binomial 200k x 500",
                                       fits[0][0], fits[1][0], fits[0][1],
                                       fits[1][1])
    print(f"GLM 8e: {len(out)} cases agree, {time.perf_counter() - t0:.1f} s")
    return out


def phase_glm(glm_airlines: dict, glm_multi: dict) -> dict:
    """Phase 8: GLM on the card (8b and 8c ran beside phases 7 and 6,
    which hold their frames)."""
    return dict(bench_glm=phase_glm_bench(), airlines=glm_airlines,
                multinomial=glm_multi, lambda_search=glm_lambda_search(),
                cross=phase_glm_cross())


def totals_times() -> list:
    """The node-totals instance timed at the final level of the main path
    (11M rows, 64 nodes, K = 1) and of the multinomial path (K = 3, w
    shared), beside its plain version (one index_add_ with its ids built),
    one index_add_ of prepared ids (the library call) and its bound (node,
    g, h per class and w once read, [K, 64, 3] written)."""
    from h2o3_tpu_torch.ops import hist
    gen = torch.Generator(device="cuda").manual_seed(29)
    N = 2 ** DEPTH
    rows = []
    for K in (1, 3):
        node = torch.randint(-1, N, (K, ROWS), generator=gen, device="cuda",
                             dtype=torch.int32)
        g = torch.randn((K, ROWS), generator=gen, device="cuda")
        h = torch.rand((K, ROWS), generator=gen, device="cuda")
        w = torch.ones(ROWS, device="cuda")
        calls = hist.node_totals.launches
        ms = cuda_ms_auto(lambda: hist.node_totals(node, g, h, w, N))
        hist.node_totals.launches = calls
        plain_ms = cuda_ms_auto(lambda: hist.node_totals_plain(node, g, h,
                                                               w, N))
        act = node >= 0
        ids = torch.where(act, torch.arange(K, device="cuda")[:, None] * N
                          + node, 0).long().reshape(-1)
        src = torch.stack([torch.where(act, v, 0.0) for v in
                           (g, h, w.expand(K, ROWS))], -1).reshape(-1, 3)
        library_ms = cuda_ms_auto(lambda: torch.zeros(
            (K * N, 3), device="cuda").index_add_(0, ids, src))
        nbytes = K * ROWS * 12 + ROWS * 4 + K * N * 12
        flops = 3 * int(act.sum())
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       flops / F32_FLOPS_PER_S) * 1e3
        print(f"node totals K={K} R={ROWS} N={N}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms (bytes, {nbytes / 1e6:.1f} MB)")
        rows.append(dict(level=DEPTH, N=N, K=K, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by="bytes", bound_share=bound_ms / ms))
        del node, g, h, w, ids, src, act
    torch.cuda.empty_cache()
    return rows


# -- phase 9: the rest of the tree family ---------------------------------

#: the uplift frame, shaped as the Criteo Uplift Prediction Dataset v2.1
#: (Diemert et al., "A Large Scale Benchmark for Uplift Modeling", AdKDD
#: 2018): its rows, its 12 float features f0-f11, 85% treated, the visit
#: label at about 4.7%
UPLIFT_ROWS, UPLIFT_FEAT = 13_979_592, 12
#: rows of the CPU-against-card checks of one uplift batch and of a whole
#: uplift model (cut from 500k and 200k: ROADMAP.md "Reduced checks")
UPLIFT_BATCH_ROWS, UPLIFT_CROSS_ROWS = 200_000, 100_000
#: DART at bench_xgboost's settings and XGBoost's DART tutorial's
DART_TREES = 50
DART = dict(booster="dart", max_depth=DEPTH, max_bin=XGB_BINS, eta=0.3,
            rate_drop=0.1, skip_drop=0.5, normalize_type="tree", seed=42)
#: rows of the CPU-against-card fits, of TreeSHAP and of calibration
CROSS_ROWS, SHAP_ROWS, SHAP_CROSS_ROWS, CAL_ROWS = (200_000, 1_000_000,
                                                    10_000, 1_000_000)
#: rows of the isolation forests' CPU-against-card fits (cut from 200k:
#: ROADMAP.md "Reduced checks")
ISO_CROSS_ROWS = 50_000
#: the isolation forests: (name, builder parameters, trees)
ISO_CASES = (("IF", dict(ntrees=50, sample_size=256, max_depth=8), 50),
             ("EIF extension 0", dict(ntrees=100, extension_level=0), 100),
             ("EIF extension 27", dict(ntrees=100, extension_level=27), 100))
#: the fixed few bytes a fit copies to the host besides the subsamples
ISO_FIXED_BYTES = 4096


def head(fr, n: int):
    """The frame's first n rows, as views on its device."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.vec import Vec
    return Frame(fr.names, [Vec(v.data[:n], v.type, v.domain)
                            for v in fr.vecs])


def frame_on(fr, dev):
    """A copy of the frame on ``dev``."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.vec import Vec
    return Frame(fr.names, [Vec(v.data.to(dev), v.type, v.domain)
                            for v in fr.vecs])


def model_on(model, dev):
    """A copy of a model with every tensor of its output (trees included)
    on ``dev``."""
    import copy
    import dataclasses

    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{f.name: move(getattr(v, f.name))
                                             for f in dataclasses.fields(v)})
        if isinstance(v, list):
            return [move(u) for u in v]
        if isinstance(v, dict):
            return {k: move(u) for k, u in v.items()}
        return v

    out = copy.copy(model)
    out.output = move(model.output)
    return out


def _outputs_bitwise(a: dict, b: dict, keys) -> bool:
    """The outputs' entries ``keys`` equal bit for bit (trees field by
    field), wherever they lie."""
    from h2o3_tpu_torch.models.tree import HEAP_FIELDS
    for k in keys:
        u, v = a[k], b[k]
        if k == "trees":
            pairs = [(getattr(x, f), getattr(y, f)) for x, y in zip(u, v)
                     for f in HEAP_FIELDS]
            if len(u) != len(v):
                return False
        else:
            pairs = [(u, v)]
        for x, y in pairs:
            if (x is None) != (y is None):
                return False
            if isinstance(x, torch.Tensor):
                if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
                    return False
            elif x != y:
                return False
    return True


def tree_family_dt(fr) -> dict:
    """(b) The decision tree at its defaults (depth 10, min_rows 10, 64
    bins) on phase 4's frame: levels 0-6 on the fixed kernel, 7-9 (64-256
    histogrammed nodes) on the global kernel."""
    from h2o3_tpu_torch.models.decision_tree import DecisionTree
    x = [f"x{i}" for i in range(NFEAT)]

    def train():
        return DecisionTree().train(x=x, y="y", training_frame=fr)

    return run_path(f"decision tree {ROWS} x {NFEAT}, depth 10, min_rows 10, "
                    f"{NBINS} bins", train, train, fr, 1,
                    planned_launches(1, 10, NBINS + 1, 1), {"auc": 1e-9},
                    ("fixed", "global"))


def tree_family_dart(fr) -> dict:
    """(d) DART at bench_xgboost's settings with XGBoost's DART tutorial's
    (rate_drop 0.1, skip_drop 0.5, normalize_type tree), 50 rounds, on
    phase 4's frame; then 6 rounds on 200k rows on the CPU and the card,
    sampling off, alike at every split but the CPU's exact ties."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.xgboost import XGBoost
    x = [f"x{i}" for i in range(NFEAT)]
    builders = []

    def dart(n):
        def train():
            builders.append(XGBoost(ntrees=n, **DART))
            return builders[-1].train(x=x, y="y", training_frame=fr)
        return train

    out = run_path(
        f"DART XGBoost {ROWS} x {NFEAT}, {DART_TREES} rounds depth {DEPTH} "
        f"{XGB_BINS} bins, rate_drop 0.1, skip_drop 0.5", dart(DART_TREES),
        dart(2), fr, DART_TREES,
        planned_launches(DART_TREES, DEPTH, XGB_BINS + 1, 2), {"auc": 1e-4},
        ("fixed", "global"))
    drops = {m: len(d) for m, d in enumerate(builders[1].dart_drops) if d}
    print(f"DART rounds that dropped trees (round: trees dropped), "
          f"{len(drops)} of {DART_TREES}: {drops}")
    out["dropped"] = drops
    cols = higgs_arrays(CROSS_ROWS)
    out["cross"] = cross_device_ties(
        f"DART XGBoost {CROSS_ROWS} x {NFEAT}, 6 rounds, rate_drop 0.3, "
        "skip_drop 0.3", lambda dev: Frame.from_arrays(cols, device=dev),
        lambda: XGBoost(ntrees=6, **dict(DART, rate_drop=0.3,
                                         skip_drop=0.3)),
        x, "y", "auc", DEPTH)
    return out


def device_ops(fn) -> tuple:
    """``fn()`` once under torch.profiler: (its device ops, their device
    ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in cuda),
            sum(e.device_time_total for e in cuda) / 1e3)


def tree_family_shap(fr) -> dict:
    """(e) varimp and TreeSHAP of the main path's model (20 trees, depth
    6): varimp equal to the CPU's from the same trees; contributions of 1M
    rows, timed and profiled, each row summing to the raw margin within
    1e-5 x max(1, |margin|); 10k rows against the port on the CPU at rtol
    1e-9 (float64 sums in another order; an absolute floor of 1e-12 x the
    largest contribution)."""
    from h2o3_tpu_torch.models.gbm import GBM
    m = GBM(ntrees=NTREES, max_depth=DEPTH, nbins=NBINS, learn_rate=0.1,
            seed=42).train(y="y", training_frame=fr)
    cpu = model_on(m, "cpu")
    vi = m.varimp()
    if vi != cpu.varimp():
        raise AssertionError("varimp on the card differs from the CPU's")
    print(f"varimp (card = CPU): {[(r[0], round(r[3], 4)) for r in vi[:5]]}")
    sub = head(fr, SHAP_ROWS)
    m.contributions(head(fr, 1000))                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phi = m.contributions(sub)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    margin = (m.output["f0"] + m.output["learn_rate"]
              * m._tree_raw_sum(sub)).double()
    gap = float(((phi.sum(1) - margin).abs()
                 / margin.abs().clamp_min(1.0)).max())
    frame = m.predict_contributions(head(fr, 1000))
    ops, busy_ms = device_ops(lambda: m.contributions(sub))
    small = head(fr, SHAP_CROSS_ROWS)
    a = m.contributions(small).cpu()
    b = cpu.contributions(frame_on(small, "cpu"))
    rel = float(((a - b).abs() / (b.abs() + 1e-12 * float(b.abs().max())))
                .max())
    print(f"TreeSHAP {SHAP_ROWS} rows x {NFEAT}, {NTREES} trees depth "
          f"{DEPTH}: {seconds:.3f} s ({seconds / NTREES * 1e3:.2f} ms a "
          f"tree), {ops} device ops ({ops / NTREES:.0f} a tree), device busy "
          f"{busy_ms:.1f} ms; rows sum to the margin within "
          f"{gap:.2e} x max(1, |margin|); {SHAP_CROSS_ROWS} rows: card "
          f"against CPU max rel diff {rel:.2e}; columns "
          f"{frame.names[:3]}...{frame.names[-1]}")
    if gap > 1e-5 or rel > 1e-9 or frame.names[-1] != "BiasTerm" \
            or not bool(torch.isfinite(phi).all()):
        raise AssertionError("TreeSHAP contributions disagree")
    return dict(seconds=seconds, ms_per_tree=seconds / NTREES * 1e3,
                device_ops=ops, ops_per_tree=ops / NTREES, busy_ms=busy_ms,
                margin_gap=gap, cpu_rel=rel, rows=SHAP_ROWS)


def tree_family_calibration(fr) -> dict:
    """(f) The main path's GBM with calibrate_model on a 1M-row calibration
    frame (phase 4's generator, seed 12), by Platt scaling and by isotonic
    regression: the calibration step timed apart, and cal_p1 of its frame
    within 1e-6 of the CPU's (the same trees on the CPU, calibrated from
    the CPU's own scores of the same frame)."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.gbm import GBM
    ccols = higgs_arrays(CAL_ROWS, seed=12)
    cf, cf_cpu = Frame.from_arrays(ccols), Frame.from_arrays(ccols,
                                                             device="cpu")
    del ccols
    out = {}
    for method in ("PlattScaling", "IsotonicRegression"):
        kw = dict(calibrate_model=True, calibration_method=method)
        b = GBM(ntrees=NTREES, max_depth=DEPTH, nbins=NBINS, learn_rate=0.1,
                seed=42, calibration_frame=cf, **kw)
        m = b.train(y="y", training_frame=fr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b._maybe_calibrate(m)                 # the calibration step alone
        cal_s = time.perf_counter() - t0
        # the CPU: the same trees, calibrated from its own scores of the
        # same frame
        cpu = model_on(m, "cpu")
        GBM(calibration_frame=cf_cpu, **kw)._maybe_calibrate(cpu)
        pred, pred_cpu = m.predict(cf), cpu.predict(cf_cpu)
        differ = int((pred.vec("ps").data.cpu() != pred_cpu.vec("ps").data)
                     .sum())
        got = pred.vec("cal_p1").data.cpu()
        diff = float((got - pred_cpu.vec("cal_p1").data).abs().max())
        cal, cal_cpu = m.output["calibration"], cpu.output["calibration"]
        shown = (f"a {cal['a']:.6f} b {cal['b']:.6f} (the CPU's a "
                 f"{cal_cpu['a']:.6f} b {cal_cpu['b']:.6f})" if "a" in cal
                 else f"{len(cal['xs'])} steps (the CPU's "
                 f"{len(cal_cpu['xs'])})")
        print(f"calibration {method} on {CAL_ROWS} rows: {shown}; the step "
              f"(score on the card, one fetch, fit on the host) "
              f"{cal_s:.3f} s; p1 differs from the CPU's in {differ} rows; "
              f"cal_p1 card against CPU max |diff| {diff:.2e}")
        if diff > 1e-6 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"calibration {method} disagrees")
        out[method] = dict(seconds=cal_s, max_diff=diff,
                           p1_rows_differing=differ,
                           steps=len(cal.get("xs", [])))
    return out


def d2h_bytes(fn) -> tuple:
    """``fn()`` under torch.profiler: its result and the bytes its
    device-to-host copies moved (the trace's memcpy events)."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    path = Path(__file__).resolve().parent / "chiprun_out" / "d2h_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", "")]
    if any("bytes" not in e.get("args", {}) for e in copies):
        raise AssertionError("the trace's device-to-host copies carry no "
                             "byte counts")
    return result, sum(int(e["args"]["bytes"]) for e in copies), len(copies)


def tree_family_isofor(fr) -> dict:
    """(g) The isolation forests on phase 4's frame, fit (timed; its
    device-to-host bytes counted under the profiler, held to ntrees x 256
    x 28 x 4 plus a few kB) and scored (timed; profiled on 1M rows); then
    fitted on its first 50k rows on the card and on the CPU: equal bit for
    bit (the entries that differ printed), scores within 1e-6 x max(1,
    |score|)."""
    from h2o3_tpu_torch.models.isofor import (ExtendedIsolationForest,
                                              IsolationForest)
    x = [f"x{i}" for i in range(NFEAT)]
    out = {}
    for name, params, ntrees in ISO_CASES:
        sub = head(fr, ISO_CROSS_ROWS)
        sub_cpu = frame_on(sub, "cpu")
        cls = IsolationForest if name == "IF" else ExtendedIsolationForest
        make = lambda: cls(seed=42, **params)
        make().train(x=x, training_frame=head(fr, 100_000))    # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = make().train(x=x, training_frame=fr)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = model.predict(fr)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        # the profile of a 1M-row scoring (one chunk of rows)
        ops, busy_ms = device_ops(lambda: model.predict(head(fr, SHAP_ROWS)))
        _, nbytes, ncopies = d2h_bytes(
            lambda: make().train(x=x, training_frame=fr))
        bound = ntrees * 256 * NFEAT * 4 + ISO_FIXED_BYTES
        card = make().train(x=x, training_frame=sub)
        cpu = make().train(x=x, training_frame=sub_cpu)
        keys = (("trees", "min_path_length", "max_path_length") if name == "IF"
                else ("normals", "offsets", "is_split", "leaf", "cn"))
        differ = [k for k in keys
                  if not _outputs_bitwise(card.output, cpu.output, (k,))]
        same = not differ
        if differ:
            print(f"{name}: the CPU's forest differs in {differ}: "
                  + "; ".join(f"{k} {card.output[k]!r} / {cpu.output[k]!r}"
                              for k in differ if "path_length" in k))
        a = torch.stack([v.data for v in card.predict(sub).vecs]).cpu()
        b = torch.stack([v.data for v in cpu.predict(sub_cpu).vecs])
        gap = float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
        col = pred.vecs[0].data
        print(f"{name} {ROWS} x {NFEAT}, {ntrees} trees: fit {fit_s:.3f} s, "
              f"score {score_s:.3f} s (1M rows: {ops} device ops, busy "
              f"{busy_ms:.1f} ms); device-to-host {nbytes} bytes in "
              f"{ncopies} copies (bound {bound}); {ISO_CROSS_ROWS} rows: "
              f"forest equal to the CPU's bit for bit {same}, scores within "
              f"{gap:.2e}; {pred.names[0]} in [{float(col.min()):.4f}, "
              f"{float(col.max()):.4f}]")
        if nbytes > bound or not same or gap > 1e-6 \
                or not bool(torch.isfinite(col).all()):
            raise AssertionError(f"{name} disagrees")
        out[name] = dict(fit_s=fit_s, score_s=score_s, score_ops=ops,
                         score_busy_ms=busy_ms, d2h_bytes=nbytes,
                         d2h_bound=bound, score_gap=gap)
    return out


def uplift_frame(rows: int, seed: int):
    """The Criteo-shaped uplift frame, made on the card from ``seed``:
    f0-f11 normal, treatment at 85%, visit from a logit whose treatment
    lift grows with f0."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.types import VecType
    from h2o3_tpu_torch.frame.vec import Vec
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((UPLIFT_FEAT, rows), generator=gen, device="cuda")
    treated = torch.rand(rows, generator=gen, device="cuda") < 0.85
    logit = -3.43 + 0.4 * X[1] - 0.3 * X[2] + treated * (0.3 + 0.35 * X[0])
    visit = torch.rand(rows, generator=gen, device="cuda") < \
        torch.sigmoid(logit)
    names = [f"f{i}" for i in range(UPLIFT_FEAT)] + ["treatment", "visit"]
    vecs = [Vec(X[i], VecType.NUM) for i in range(UPLIFT_FEAT)]
    vecs += [Vec(treated.to(torch.int32), VecType.CAT,
                 ("control", "treatment")),
             Vec(visit.to(torch.int32), VecType.CAT, ("0", "1"))]
    return Frame(names, vecs)


def batch_tie_differences(cpu_trees, card_trees, ties: list,
                          depth: int) -> tuple:
    """:func:`tie_aware_differences` for the K trees of one batched
    growth: ``ties`` holds each level's :func:`tree.tied_splits` over the
    level's K x N nodes (tree-major)."""
    differ, tied = [], []
    for k, (a, b) in enumerate(zip(cpu_trees, card_trees)):
        alike = torch.stack([getattr(a, f).cpu() == getattr(b, f).cpu()
                             for f in SPLIT_KEYS]).all(0)
        todo = [0]
        while todo:
            i = todo.pop()
            d = int(np.log2(i + 1))
            if d >= depth:
                continue
            if not alike[i]:
                n = 2 ** d
                (tied if bool(ties[d][k * n + i - (n - 1)])
                 else differ).append((k, i))
            elif bool(a.is_split[i]):
                todo += [2 * i + 1, 2 * i + 2]
    return differ, tied


def tree_family_uplift() -> dict:
    """(a) and (c): the uplift path's kernel shapes held against the plain
    version (level 0 at 14M x 12, K = 8, w per tree; node totals at K = 8,
    32 nodes), timed at each level; uplift DRF
    at the JAX package's defaults on the Criteo-shaped frame; the CPU
    against the card on one batch of 8 trees (200k rows) and on a whole
    model (100k rows), both from bootstrap weights drawn on the CPU."""
    from h2o3_tpu_torch.models import tree
    from h2o3_tpu_torch.models.uplift import UpliftDRF
    t0 = time.perf_counter()
    ufr = uplift_frame(UPLIFT_ROWS, 21)
    torch.cuda.synchronize()
    shares = [float(ufr.vec(c).data.float().mean())
              for c in ("treatment", "visit")]
    print(f"uplift frame {UPLIFT_ROWS} x {UPLIFT_FEAT} on the card: "
          f"{time.perf_counter() - t0:.2f} s, treated {shares[0]:.4f}, visit "
          f"{shares[1]:.4f}")
    K, Bt, R = 8, NBINS + 1, UPLIFT_ROWS
    gen = torch.Generator(device="cuda").manual_seed(23)
    binned_T, _, g, h, w = batch_inputs(R, UPLIFT_FEAT, Bt, 1, torch.int8,
                                        gen, K, True)
    node0 = torch.zeros((K, R), dtype=torch.int32, device="cuda")
    shape = f"uplift R={R} F={UPLIFT_FEAT} Bt={Bt} K={K} w per tree"
    # level 0: every row in node 0, so each entry sums ~215k rows and the
    # float32 plain version's own rounding nears the check: held to float64
    # sums (check_fixed without against_plain)
    fixed = check_fixed((binned_T, node0, g, h, w), 1, Bt,
                        f"{shape} level 0", against_plain=False)
    del node0
    node = torch.randint(-1, 32, (K, R), generator=gen, device="cuda",
                         dtype=torch.int32)
    totals_err = check_totals(node, g, h, w, 32, f"{shape} final level N=32")
    del node
    layouts = []
    for level in range(5):
        per_tree = [level_nodes(R, level, gen) for _ in range(K)]
        layouts.append((level, per_tree[0][0],
                        torch.stack([n for _, n in per_tree])))
    times = time_levels(f"uplift K={K}", binned_T, g, h, w, Bt, layouts)
    del layouts, binned_T, g, h, w
    torch.cuda.empty_cache()

    x = [f"f{i}" for i in range(UPLIFT_FEAT)]

    def uplift(n):
        return lambda: UpliftDRF(treatment_column="treatment", ntrees=n,
                                 seed=42).train(x=x, y="visit",
                                                training_frame=ufr)

    def finite_uplift(pred):
        u = pred.vec("uplift_predict").data
        if u.shape[0] != UPLIFT_ROWS or not bool(torch.isfinite(u).all()):
            raise AssertionError("uplift predictions are not finite")

    out = run_path(
        f"uplift DRF {UPLIFT_ROWS} x {UPLIFT_FEAT}, 50 trees depth 5 "
        f"{NBINS} bins, sample_rate 0.632, 8 trees a batch", uplift(50),
        uplift(8), ufr, 50, planned_launches(7, 5, Bt, 1),
        {"auuc": 1e-6, "qini": 1e-6, "auuc_normalized": 1e-9}, ("fixed",),
        expected_totals=7, pred_check=finite_uplift)
    out.update(times=times, err=fixed["err"], totals_err=totals_err)

    class CPUDrawn(UpliftDRF):
        """Bootstrap weights drawn on the CPU, one generator a tree, and
        copied to the frame's device."""

        def _batch_weights(self, w, s, k):
            rate = float(self.params["sample_rate"])
            return [w * torch.poisson(torch.full((w.shape[0],), rate),
                                      generator=torch.Generator().manual_seed(
                                          1000 + s + i)).to(w.device)
                    for i in range(k)]

    # one batch of 8 trees on the first rows, the same weights
    ties, find = [], tree._find_splits

    def recording(hists, *a, **kw):
        ties.append(tree.tied_splits(hists, *a, **kw).cpu())
        return find(hists, *a, **kw)

    one = head(ufr, UPLIFT_BATCH_ROWS)
    models = {}
    for dev, f in (("cpu", frame_on(one, "cpu")), ("cuda", one)):
        tree._find_splits = recording if dev == "cpu" else find
        try:
            models[dev] = CPUDrawn(treatment_column="treatment", ntrees=8) \
                .train(x=x, y="visit", training_frame=f)
        finally:
            tree._find_splits = find
    differ, tied = batch_tie_differences(models["cpu"].output["trees"],
                                         models["cuda"].output["trees"],
                                         ties, 5)
    # the whole model on the first rows, the same weights
    part = head(ufr, UPLIFT_CROSS_ROWS)
    whole = {dev: CPUDrawn(treatment_column="treatment", ntrees=50).train(
        x=x, y="visit", training_frame=f).training_metrics
        for dev, f in (("cpu", frame_on(part, "cpu")), ("cuda", part))}
    d_auuc = abs(whole["cpu"].auuc - whole["cuda"].auuc)
    print(f"uplift CPU against the card: one batch of 8 trees on "
          f"{UPLIFT_BATCH_ROWS} rows, "
          f"split nodes that differ {differ}, at the CPU's exact ties "
          f"{tied}; the whole model on {UPLIFT_CROSS_ROWS} rows: AUUC CPU "
          f"{whole['cpu'].auuc:.6f} card {whole['cuda'].auuc:.6f}, qini "
          f"{whole['cpu'].qini:.6f} / {whole['cuda'].qini:.6f}")
    # tolerance: trees alike but at ties, whose leaves move a few rows'
    # predictions; 1e-3 of the AUUC
    if differ or d_auuc > 1e-3 * abs(whole["cpu"].auuc) \
            or not all(np.isfinite([whole["cuda"].auuc, whole["cuda"].qini,
                                    whole["cuda"].auuc_normalized])):
        raise AssertionError("uplift DRF on the card disagrees with the CPU")
    out["cross_auuc"] = (whole["cpu"].auuc, whole["cuda"].auuc)
    del ufr
    torch.cuda.empty_cache()
    return out


def phase_tree_family(fr) -> dict:
    """Phase 9: the rest of the tree family, (b) and (d)-(g) on phase 4's
    frame, then (a) and (c) on the uplift frame; each part's seconds (its
    checks on the CPU included) in ``part_seconds``."""
    t0 = time.perf_counter()
    out, parts = {}, {}
    for name, part in (("decision_tree", lambda: tree_family_dt(fr)),
                       ("dart", lambda: tree_family_dart(fr)),
                       ("treeshap", lambda: tree_family_shap(fr)),
                       ("calibration", lambda: tree_family_calibration(fr)),
                       ("isofor", lambda: tree_family_isofor(fr)),
                       ("uplift", tree_family_uplift)):
        t1 = time.perf_counter()
        out[name] = part()
        parts[name] = time.perf_counter() - t1
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 9: {out['seconds']:.1f} s; by part "
          f"{ {k: round(v, 1) for k, v in parts.items()} }")
    return out


#: phase 10: bench.py:181's bench_dl frame (60,000 x 784 normal features
#: from default_rng(5), labels 0-9) and its CPU head
DL_ROWS, DL_FEAT, DL_CPU_ROWS = 60_000, 784, 2_000
#: the like part of each fit that is profiled: one epoch of its first rows
#: (cut from the whole warm fit: ROADMAP.md "Reduced checks")
DL_PROFILE_ROWS = 10_000
DL_X = [f"p{i}" for i in range(DL_FEAT)]
#: phase 10's DeepLearning configurations: (name, builder parameters)
DL_CASES = (
    ("a bench_dl", dict(hidden=[50, 50], activation="Rectifier", epochs=3,
                        mini_batch_size=128, seed=7)),
    ("b H2O defaults", dict(hidden=[200, 200], activation="Rectifier",
                            mini_batch_size=32, epochs=1, seed=7)),
    ("c MaxoutWithDropout, momentum SGD, Nesterov",
     dict(hidden=[50, 50], activation="MaxoutWithDropout",
          adaptive_rate=False, epochs=1, seed=7)),
    ("d AutoEncoder", dict(autoencoder=True, hidden=[50], activation="Tanh",
                           epochs=3, seed=7)),
)
#: rows of the CPU heads of the unsupervised checks; estimate_k's rows and
#: the proximal GLRM's (airlines) rows, and its CPU head
UNSUP_CPU_ROWS, ESTIMATE_K_ROWS = 20_000, 1_000_000
GLRM_PROX_ROWS, GLRM_PROX_CPU_ROWS = 1_000_000, 4_000
NB_CPU_ROWS = 200_000
KMEANS = dict(k=10, init="Furthest", max_iterations=10, standardize=True,
              seed=7)
#: the exact path: k 10, at most 10 iterations (the default 100 cut to keep
#: phase 10 short; on this frame it settles in 2)
GLRM_EXACT = dict(k=10, max_iterations=10)
GLRM_PROX = dict(k=10, multi_loss="Categorical", max_iterations=50)


def device_events(fn) -> list:
    """``fn()`` once under torch.profiler (device activity only): its
    device ops as [(name, ms, count)], costliest first. The trace's raw
    events are summed directly: parsing them into the profiler's event
    tree takes tens of seconds at 10^5 events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    agg: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t = agg.setdefault(e.name(), [0.0, 0])
            t[0] += e.duration_ns() / 1e6
            t[1] += 1
    if not agg:
        raise AssertionError("the profiler recorded no device op")
    return sorted(((k, ms, n) for k, (ms, n) in agg.items()),
                  key=lambda k: -k[1])


def timed_fit(what: str, fit, units: float, unit: str,
              before_timed=None, sample=None) -> tuple:
    """``fit()`` twice on the card: the warm run under torch.profiler (the
    device's busy time, op count and costliest ops), then the timed run
    under the sync counter, after ``before_timed()`` (which zeroes counts)
    and with its peak device memory. A fit of hundreds of thousands of
    device ops takes the profiler several times its own time: there
    ``sample`` = (what it is, a fit of one of its like parts) is profiled
    and timed instead, for the busy and idle share, and ``fit`` runs once,
    timed. Returns (the timed run's model, its numbers)."""
    profiled = fit if sample is None else sample[1]
    t0 = time.perf_counter()
    ops = device_events(profiled)
    warm_s = time.perf_counter() - t0
    busy_ms = sum(ms for _, ms, _ in ops)
    if sample is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        profiled()
        torch.cuda.synchronize()
        busy_wall_s = time.perf_counter() - t0
    if before_timed is not None:
        before_timed()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, sites = count_syncs(fit)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if sample is None:
        busy_wall_s = seconds
    idle = 1.0 - busy_ms / (busy_wall_s * 1e3)
    of = "" if sample is None else \
        f" of {sample[0]} ({busy_wall_s:.4f} s unprofiled)"
    print(f"{what}: {seconds:.4f} s, {units / seconds:.6g} {unit}/s; device "
          f"busy {busy_ms:.2f} ms in {sum(n for _, _, n in ops)} ops{of} "
          f"(idle {100 * idle:.1f}%); host syncs {sum(sites.values())}: "
          f"{sites}; peak device memory {peak:.2f} GiB; the profiled warm "
          f"run {warm_s:.2f} s")
    for name, ms, n in ops[:5]:
        print(f"  {ms:9.2f} ms {n:6d}x  {name[:90]}")
    return model, dict(seconds=seconds, rate=units / seconds, unit=unit,
                       busy_ms=busy_ms, idle_share=idle, peak_gib=peak,
                       device_ops=sum(n for _, _, n in ops),
                       profiled=what if sample is None else sample[0],
                       host_syncs=sum(sites.values()), sync_sites=sites,
                       top_ops=[(name[:60], ms, n) for name, ms, n in ops[:3]])


def prime_rollups(fr) -> None:
    """Every column's rollups, so that no timed fit computes them."""
    for v in fr.vecs:
        v.rollups()


def close(what: str, got, want, rtol: float, atol: float = 0.0) -> float:
    """Hold two arrays at rtol (plus atol); returns the largest |difference|
    over its allowance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ratio = float(np.max(np.abs(got - want) / (rtol * np.abs(want) + atol
                                               + 1e-300)))
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: CPU and card differ by {ratio:.3g} x "
                             f"the tolerance (rtol {rtol}, atol {atol})")
    return ratio


def dl_frame(device):
    """bench.py:181's frame: 60,000 x 784 normal features from
    default_rng(5), labels 0-9 (domain "0".."9")."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.types import VecType
    from h2o3_tpu_torch.frame.vec import Vec
    rng = np.random.default_rng(5)
    X = rng.normal(size=(DL_ROWS, DL_FEAT)).astype(np.float32)
    yv = rng.integers(0, 10, size=DL_ROWS).astype(np.int32)
    fr = Frame.from_arrays({f"p{i}": X[:, i] for i in range(DL_FEAT)},
                           device=device)
    y = Vec(torch.from_numpy(yv).to(device), VecType.CAT,
            domain=tuple(str(d) for d in range(10)))
    return Frame(fr.names + ["y"], fr.vecs + [y])


@contextlib.contextmanager
def host_streams(seed: int):
    """DeepLearning's initial weights and each epoch's permutation drawn on
    the host (a CPU generator, numpy), so that a CPU fit and a card fit
    start alike and see the rows in one order."""
    from h2o3_tpu_torch.models import deeplearning as dl
    perm0, init0 = dl._permutation, dl._init_params

    def perm(n, gen, device):
        return torch.from_numpy(np.random.default_rng(seed).permutation(
            n)).to(device)

    def init(sizes, act, dist, scale, gen, device):
        Ws, bs = init0(sizes, act, dist, scale,
                       torch.Generator().manual_seed(seed), "cpu")
        return [w.to(device) for w in Ws], [b.to(device) for b in bs]

    dl._permutation, dl._init_params = perm, init
    try:
        yield
    finally:
        dl._permutation, dl._init_params = perm0, init0


def dl_cross(name: str, params: dict, fr) -> dict:
    """The configuration on the frame's first 2,000 rows, one epoch,
    dropout 0, the streams on the host, on the CPU and on the card: class
    probabilities (the autoencoder's anomaly) at rtol 1e-5, as the CPU
    tests hold them; the weights' largest difference printed."""
    from h2o3_tpu_torch.models.deeplearning import DeepLearning
    p = dict(params, epochs=1)
    if p["activation"].endswith("WithDropout"):
        p["hidden_dropout_ratios"] = [0.0] * len(p["hidden"])
    sub = head(fr, DL_CPU_ROWS)
    fits = {}
    t0 = time.perf_counter()
    for dev, frame in (("cpu", frame_on(sub, "cpu")), ("cuda", sub)):
        with host_streams(11):
            fits[dev] = DeepLearning(**p).train(
                x=DL_X, y=None if p.get("autoencoder") else "y",
                training_frame=frame)
    cpu, card = fits["cpu"], fits["cuda"]
    w_ratio = max(float(((a.cpu() - b).abs() / (1e-5 * b.abs() + 1e-6 *
                                                b.abs().max())).max())
                  for a, b in zip(card.output["net"].params(),
                                  cpu.output["net"].params()))
    if p.get("autoencoder"):
        got = card.anomaly(sub).vec("Reconstruction.MSE").to_numpy()
        want = cpu.anomaly(frame_on(sub, "cpu")).vec(
            "Reconstruction.MSE").to_numpy()
        ratio = close(f"{name} anomaly", got, want, 1e-5)
    else:
        got = card._score_raw(sub).cpu().numpy()
        want = cpu._score_raw(frame_on(sub, "cpu")).numpy()
        ratio = close(f"{name} probabilities", got, want, 1e-5, 1e-7)
    print(f"  CPU / card on {DL_CPU_ROWS} rows, 1 epoch, host streams "
          f"({time.perf_counter() - t0:.1f} s): "
          f"{'anomaly' if p.get('autoencoder') else 'probabilities'} at "
          f"{ratio:.3g} x rtol 1e-5; weights at {w_ratio:.3g} x the step "
          f"tolerance (rtol 1e-5 + 1e-6 x max, printed only)")
    return dict(cross_ratio=ratio, cross_weights_ratio=w_ratio)


def dl_part(fr) -> dict:
    """(a)-(d): each configuration fitted warm and timed on the card, then
    checked against the CPU on a head."""
    from h2o3_tpu_torch.models.deeplearning import DeepLearning
    out = {}
    for name, params in DL_CASES:
        auto = bool(params.get("autoencoder"))

        def fit(params=params, auto=auto):
            return DeepLearning(**params).train(
                x=DL_X, y=None if auto else "y", training_frame=fr)

        def part(params=params, auto=auto, sub=head(fr, DL_PROFILE_ROWS)):
            return DeepLearning(**dict(params, epochs=1)).train(
                x=DL_X, y=None if auto else "y", training_frame=sub)

        B = params.get("mini_batch_size", 32)
        samples = DL_ROWS * params["epochs"]
        model, res = timed_fit(f"DL ({name}) {DL_ROWS} x {DL_FEAT}, hidden "
                               f"{params['hidden']}", fit, samples,
                               "samples", sample=(
                                   f"one epoch of its first "
                                   f"{DL_PROFILE_ROWS} rows", part))
        in_loop = sum(n for s, n in res["sync_sites"].items()
                      if s.startswith("deeplearning.py:"))
        hist = [h["train_loss"] for h in model.output["score_history"]]
        res.update(samples_trained=model.output["samples_trained"],
                   epoch_loss=hist, syncs_in_fit_loop=in_loop)
        if auto:
            t0 = time.perf_counter()
            mse = model.anomaly(fr).vec("Reconstruction.MSE").data
            torch.cuda.synchronize()
            res["anomaly_s"] = time.perf_counter() - t0
            res["anomaly_mean"] = float(mse.mean())
            if not (torch.isfinite(mse).all() and mse.numel() == DL_ROWS):
                raise AssertionError("DL (d): anomaly scores not finite")
        else:
            res["train_logloss"] = model.training_metrics.logloss
        print(f"  epoch losses {hist}; samples trained "
              f"{model.output['samples_trained']:.0f}; syncs inside "
              f"deeplearning.py {in_loop}" + (
                  f"; training logloss {res['train_logloss']:.6f}"
                  if not auto else f"; anomaly of {DL_ROWS} rows "
                  f"{res['anomaly_s']:.4f} s, mean {res['anomaly_mean']:.6f}"))
        if not (np.all(np.isfinite(hist)) and model.output["samples_trained"]
                == DL_ROWS // B * B * params["epochs"]):
            raise AssertionError(f"DL ({name}): losses not finite or samples "
                                 "miscounted")
        if in_loop != 1:
            raise AssertionError(f"DL ({name}): {in_loop} host syncs inside "
                                 "deeplearning.py; the fit fetches once")
        res.update(dl_cross(name, params, fr))
        out[name.split()[0]] = res
    return out


@contextlib.contextmanager
def first_center(row: int):
    """KMeans' first center (its one random draw under Furthest) at
    ``row`` on every device."""
    from h2o3_tpu_torch.models import kmeans as km
    choice0 = km._weighted_row_choice
    km._weighted_row_choice = lambda gen, p, w: torch.tensor(row,
                                                             device=w.device)
    try:
        yield
    finally:
        km._weighted_row_choice = choice0


def kmeans_part(fr) -> dict:
    """(e) KMeans on the 11M x 28 frame (k 10, Furthest, 10 iterations,
    standardize) and estimate_k (k 10) on its first 1M rows; then on its
    first 20,000 rows on the CPU and the card from the same first center:
    within-SS at rtol 1e-5 and the same iterations, estimate_k's k
    exactly, and one Lloyd step from the CPU's centers: the same
    assignment for every row but near-ties (two nearest squared distances
    within 1e-5 relative: the 28 features are independent normals, so
    such rows flip with the order of the sums) and, if none flips, the new
    centers at rtol 1e-5."""
    from h2o3_tpu_torch.models import kmeans as km
    x = [f"x{i}" for i in range(NFEAT)]

    def fit():
        return km.KMeans(**KMEANS).train(x=x, training_frame=fr)

    model, res = timed_fit(f"KMeans {ROWS} x {NFEAT}, k 10, Furthest, "
                           "10 iterations, standardize", fit,
                           ROWS * KMEANS["max_iterations"], "rows*iterations")
    C = model.centers()
    if not (C.shape == (10, NFEAT) and np.isfinite(C).all()
            and model.output["size"].sum() == ROWS):
        raise AssertionError("KMeans: centers not finite or sizes off")
    res.update(iterations=model.output["iterations"],
               tot_withinss=model.tot_withinss(), totss=model.totss(),
               betweenss=model.betweenss(),
               sizes=model.output["size"].tolist())
    sub = head(fr, ESTIMATE_K_ROWS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ek = km.KMeans(k=10, estimate_k=True).train(x=x, training_frame=sub)
    torch.cuda.synchronize()
    res["estimate_k"] = dict(
        seconds=time.perf_counter() - t0,
        k=int(ek.output["centers_std"].shape[0]),
        iterations=ek.output["iterations"], tot_withinss=ek.tot_withinss())
    print(f"  iterations {res['iterations']}, within-SS "
          f"{res['tot_withinss']:.6g} of total {res['totss']:.6g}; "
          f"estimate_k on {ESTIMATE_K_ROWS} rows: k = "
          f"{res['estimate_k']['k']} in {res['estimate_k']['seconds']:.3f} s")
    sub = head(fr, UNSUP_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    fits = {}
    with first_center(0):
        for dev, f in (("cpu", cpu_sub), ("cuda", sub)):
            fits[dev] = (km.KMeans(**KMEANS).train(x=x, training_frame=f),
                         km.KMeans(k=10, estimate_k=True).train(
                             x=x, training_frame=f))
    (cpu, cpu_ek), (card, card_ek) = fits["cpu"], fits["cuda"]
    close("KMeans within-SS", card.tot_withinss(), cpu.tot_withinss(), 1e-5)
    close("estimate_k within-SS", card_ek.tot_withinss(),
          cpu_ek.tot_withinss(), 1e-5)
    if card.output["iterations"] != cpu.output["iterations"] or \
            card_ek.output["centers_std"].shape != \
            cpu_ek.output["centers_std"].shape:
        raise AssertionError("KMeans: iterations or estimate_k's k differ "
                             "between the CPU and the card")
    X = cpu.data_info.expand(cpu_sub)
    C0 = cpu.output["centers_std"]
    d2 = km._sq_dists(X, C0).sort(dim=1).values
    tie = (d2[:, 1] - d2[:, 0]) <= 1e-5 * d2[:, 0].clamp_min(1.0)
    a_cpu = km._assign(X, C0)[0]
    a_card = km._assign(cpu.data_info.expand(sub), C0.cuda())[0].cpu()
    flips = a_cpu != a_card
    if (flips & ~tie).any():
        raise AssertionError(f"KMeans: {int((flips & ~tie).sum())} rows "
                             "assigned otherwise on the card, not at a tie")
    if not flips.any():
        close("KMeans Lloyd step centers",
              km._lloyd_step(cpu.data_info.expand(sub), torch.ones(
                  UNSUP_CPU_ROWS, device="cuda"), C0.cuda())[0].cpu(),
              km._lloyd_step(X, torch.ones(UNSUP_CPU_ROWS), C0)[0],
              1e-5, 1e-6)
    res["cross"] = dict(rows=UNSUP_CPU_ROWS, flips=int(flips.sum()),
                        near_ties=int(tie.sum()),
                        wss_cpu=cpu.tot_withinss(),
                        wss_card=card.tot_withinss())
    print(f"  CPU / card on {UNSUP_CPU_ROWS} rows: within-SS "
          f"{card.tot_withinss():.9g} / {cpu.tot_withinss():.9g}, "
          f"estimate_k k = {card_ek.output['centers_std'].shape[0]}; one "
          f"Lloyd step: {int(flips.sum())} rows assigned otherwise, "
          f"{int(tie.sum())} near-ties")
    return res


def eigen_residual(M: np.ndarray, V, lam) -> float:
    """max |M v - lambda v| over the eigenpairs, over lambda_max."""
    V = np.asarray(V, np.float64)
    lam = np.asarray(lam, np.float64)
    return float(np.abs(M @ V - V * lam[None, :]).max() / lam.max())


def pca_svd_part(fr) -> dict:
    """(f) PCA (k 10, DEMEAN) and SVD (nv 10) on the 11M x 28 frame, the
    Gram alone beside its 2RP^2 FLOP at the float32 peak; then on the
    first 20,000 rows on the CPU and the card: eigenvalues (and singular
    values) at rtol 1e-5, and the card's eigenvectors eigenvectors of the
    CPU's float64 matrix (residual within 1e-5 of the largest eigenvalue).
    The 28 features are independent normals, so the eigenvalues lie close
    together and the eigenvectors themselves are not determined to rtol
    1e-5 by float32 sums: they are printed, not held."""
    from h2o3_tpu_torch.models import decomposition as dec
    x = [f"x{i}" for i in range(NFEAT)]
    out = {}
    for name, make in (("pca", lambda: dec.PCA(k=10, transform="DEMEAN")),
                       ("svd", lambda: dec.SVD(nv=10))):
        def fit(make=make):
            return make().train(x=x, training_frame=fr)

        model, res = timed_fit(f"{name.upper()} {ROWS} x {NFEAT}, 10 "
                               "components", fit, ROWS, "rows")
        lam = model.output["eigenvalues"] if name == "pca" else \
            model.output["d"] ** 2
        if not (np.isfinite(lam).all() and (lam > 0).all()):
            raise AssertionError(f"{name}: eigenvalues not finite")
        res["values"] = (model.output["std_deviation"] if name == "pca"
                         else model.output["d"]).tolist()
        out[name] = res
    X = model.data_info.expand(fr)
    w = torch.ones(ROWS, device="cuda")
    ms = cuda_ms(lambda: dec._gram(X, w), reps=5)
    peak, src = fp32_peak()
    bound = 2.0 * ROWS * NFEAT * NFEAT / peak * 1e3
    del X, w
    out["gram"] = dict(ms=ms, bound_ms=bound, peak_flops=peak, peak_src=src)
    print(f"  the Gram alone ({ROWS} x {NFEAT}, weighted): {ms:.4f} ms "
          f"against {bound:.4f} ms of 2RP^2 FLOP at {peak / 1e12:.2f} "
          f"TFLOP/s ({src})")
    sub = head(fr, UNSUP_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    for name, make in (("pca", lambda: dec.PCA(k=10, transform="DEMEAN")),
                       ("svd", lambda: dec.SVD(nv=10))):
        cpu = make().train(x=x, training_frame=cpu_sub)
        card = make().train(x=x, training_frame=sub)
        Xh = cpu.data_info.expand(cpu_sub).double().numpy()
        if name == "pca":
            mu = Xh.mean(axis=0)
            n = Xh.shape[0]
            M = Xh.T @ Xh / (n - 1.0) - np.outer(mu, mu) * (n / (n - 1.0))
            V, lam, lam_cpu = (card.rotation(), card.output["eigenvalues"],
                               cpu.output["eigenvalues"])
        else:
            M = Xh.T @ Xh
            V, lam, lam_cpu = (card.output["v"].cpu().numpy(),
                               card.output["d"] ** 2, cpu.output["d"] ** 2)
        close(f"{name} eigenvalues", lam, lam_cpu, 1e-5)
        resid = eigen_residual(M, V, lam)
        if not resid <= 1e-5:
            raise AssertionError(f"{name}: the card's eigenvectors leave a "
                                 f"residual of {resid:.3g} x lambda_max")
        vdiff = float(np.abs(np.abs(V) - np.abs(
            cpu.rotation() if name == "pca" else
            cpu.output["v"].numpy())).max())
        out[name]["cross"] = dict(rows=UNSUP_CPU_ROWS, residual=resid,
                                  eigvec_abs_diff=vdiff)
        print(f"  {name} CPU / card on {UNSUP_CPU_ROWS} rows: eigenvalues "
              f"within rtol 1e-5, residual {resid:.3g} x lambda_max; "
              f"eigenvectors differ by up to {vdiff:.3g} (printed only)")
    return out


@contextlib.contextmanager
def fixed_archetypes(k: int, seed: int = 7):
    """GLRM's initial Y: k orthonormal rows from numpy on every device."""
    from h2o3_tpu_torch.models import decomposition as dec
    init0 = dec._init_archetypes

    def init(Xc, k_, init, gen):
        Q = np.linalg.qr(np.random.default_rng(seed).normal(
            size=(Xc.shape[1], k_)))[0]
        return torch.from_numpy(Q.T.astype(np.float32)).to(Xc.device)

    dec._init_archetypes = init
    try:
        yield
    finally:
        dec._init_archetypes = init0


def glrm_part(fr, air_fr) -> dict:
    """(g) GLRM's exact path (k 10) on the 11M x 28 frame and the proximal
    path (Categorical multi_loss on the six enum columns, quadratic on the
    numeric two, transform NONE as H2O's default, k 10, 50 iterations) on
    the first 1M airlines rows; then each on a head on the CPU and the
    card from the same initial archetypes: the objective at rtol 1e-4
    (exact) and 1e-3 (proximal), the exact path's reconstruction at rtol
    1e-4, as the CPU tests hold them. The proximal path's step starts at
    1/(observed cells), the reference's rule, so at 1M x 674 its first
    step changes the objective by less than its 1e-7 stop rule."""
    from h2o3_tpu_torch.models import decomposition as dec
    x = [f"x{i}" for i in range(NFEAT)]
    out = {}
    air = head(air_fr, GLRM_PROX_ROWS)
    for name, params, frame, cols, rows in (
            ("exact", GLRM_EXACT, fr, x, ROWS),
            ("proximal", GLRM_PROX, air, AIRLINE_X, GLRM_PROX_ROWS)):
        def fit(params=params, frame=frame, cols=cols):
            return dec.GLRM(**params).train(x=cols, training_frame=frame)

        model, res = timed_fit(f"GLRM {name} {rows} rows, k 10", fit, rows,
                               "rows")
        its = model.output["iterations"]
        res.update(iterations=its, objective=model.output["objective"],
                   rows_iters_per_s=rows * its / res["seconds"],
                   width=len(model.data_info.coef_names))
        if not np.isfinite(res["objective"]):
            raise AssertionError(f"GLRM {name}: objective not finite")
        print(f"  {its} iterations ({res['rows_iters_per_s']:.6g} "
              f"rows*iterations/s), objective {res['objective']:.9g}, "
              f"{res['width']} expanded columns")
        n_cpu = UNSUP_CPU_ROWS if name == "exact" else GLRM_PROX_CPU_ROWS
        sub = head(frame, n_cpu)
        cpu_sub = frame_on(sub, "cpu")
        with fixed_archetypes(params["k"]):
            cpu = dec.GLRM(**params).train(x=cols, training_frame=cpu_sub)
            card = dec.GLRM(**params).train(x=cols, training_frame=sub)
        rtol = 1e-4 if name == "exact" else 1e-3
        ratio = close(f"GLRM {name} objective", card.output["objective"],
                      cpu.output["objective"], rtol)
        if name == "exact":
            want = cpu._score_raw(cpu_sub).numpy()
            ratio = max(ratio, close("GLRM exact reconstruction",
                                     card._score_raw(sub).cpu().numpy(),
                                     want, 1e-4, 1e-4 * np.abs(want).max()))
        res["cross"] = dict(rows=n_cpu, ratio=ratio,
                            objective_cpu=cpu.output["objective"],
                            objective_card=card.output["objective"])
        print(f"  CPU / card on {n_cpu} rows from the same archetypes: "
              f"objective {card.output['objective']:.9g} / "
              f"{cpu.output['objective']:.9g}, at {ratio:.3g} x rtol {rtol}")
        out[name] = res
    return out


def nb_part(air_fr) -> dict:
    """(h) NaiveBayes on the 10M-row airlines frame (dep_delayed_15min ~
    the eight columns); then on its first 200k rows on the CPU and the
    card: tables at rtol 1e-6, probabilities at rtol 1e-6 with a floor of
    1e-6 per term of a row's log-likelihood (the prior and one a feature),
    as the CPU tests hold them."""
    from h2o3_tpu_torch.models.naive_bayes import NaiveBayes

    def fit(frame=air_fr):
        return NaiveBayes().train(x=AIRLINE_X, y=AIRLINE_Y,
                                  training_frame=frame)

    model, res = timed_fit(f"NaiveBayes {AIRLINE_ROWS} airlines rows", fit,
                           AIRLINE_ROWS, "rows")
    res["auc"] = model.training_metrics.auc
    res["logloss"] = model.training_metrics.logloss
    print(f"  training AUC {res['auc']:.6f}, logloss {res['logloss']:.6f}")
    if not 0.5 < res["auc"] < 1.0:
        raise AssertionError("NaiveBayes: training AUC out of range")
    sub = head(air_fr, NB_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    cpu, card = fit(cpu_sub), fit(sub)
    co, ko = cpu.output, card.output
    for k in ("log_prior", "mu", "sd"):
        close(f"NaiveBayes {k}", ko[k].cpu(), co[k], 1e-6)
    for a, b in zip(ko["cat_logp"], co["cat_logp"]):
        close("NaiveBayes count tables", a.cpu(), b, 1e-6)
    terms = 1 + len(AIRLINE_X)
    ratio = close("NaiveBayes probabilities", card._score_raw(sub).cpu(),
                  cpu._score_raw(cpu_sub), 1e-6, 1e-6 * terms)
    res["cross"] = dict(rows=NB_CPU_ROWS, ratio=ratio)
    print(f"  CPU / card on {NB_CPU_ROWS} rows: tables within rtol 1e-6, "
          f"probabilities at {ratio:.3g} x (rtol 1e-6 + {terms} x 1e-6)")
    return res


def phase_dl_unsupervised(fr, air_fr) -> dict:
    """Phase 10: DeepLearning (a)-(d) on bench_dl's frame, then KMeans (e),
    PCA and SVD (f) and GLRM's exact path (g) on phase 4's frame, GLRM's
    proximal path (g) and NaiveBayes (h) on phase 7's airlines frame; each
    part's seconds (its CPU checks included) in ``part_seconds``."""
    t0 = time.perf_counter()
    out, parts = {}, {}
    dl_fr = dl_frame("cuda")
    prime_rollups(dl_fr)
    prime_rollups(fr)
    prime_rollups(air_fr)
    for name, part in (("deeplearning", lambda: dl_part(dl_fr)),
                       ("kmeans", lambda: kmeans_part(fr)),
                       ("pca_svd", lambda: pca_svd_part(fr)),
                       ("glrm", lambda: glrm_part(fr, air_fr)),
                       ("naive_bayes", lambda: nb_part(air_fr))):
        t1 = time.perf_counter()
        out[name] = part()
        parts[name] = time.perf_counter() - t1
        print(f"phase 10 {name}: {parts[name]:.1f} s")
        if name == "deeplearning":
            del dl_fr
            torch.cuda.empty_cache()
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 10: {out['seconds']:.1f} s; by part "
          f"{ {k: round(v, 1) for k, v in parts.items()} }")
    return out


# -- phase 11: the builders on GBM and GLM, and the standalone solvers ----

#: 11a: the H2O-3 ModelSelection docs' gaussian example's 20 predictors
MS_ROWS, MS_FEAT = 1_000_000, 20
#: 11e-11g's frames; 11f's covariates and 11g's groups
ISO_ROWS = COX_ROWS = HGLM_ROWS = 1_000_000
COX_FEAT, HGLM_GROUPS = 10, 1000
#: 11h: PSVM on the first rows of phase 4's frame
PSVM_ROWS = 100_000
#: the CPU heads of the CPU-against-card checks
MS_CPU_ROWS = RULEFIT_CPU_ROWS = INFOGRAM_CPU_ROWS = PSVM_CPU_ROWS = 20_000
BUILDER_CPU_ROWS = 200_000
#: 11b: H2O-3 GAM docs' three bases: cr on x0-x2, tp on [x3, x4], a
#: non-negative I-spline on x5, 5 knots; the other columns linear
GAM_PARAMS = dict(gam_columns=["x0", "x1", "x2", ["x3", "x4"], "x5"],
                  bs=[0, 0, 0, 1, 2], num_knots=5)


def builder_frame(cols: dict, device, cats: dict | None = None):
    """A frame from host columns, with categorical columns given as
    (codes, domain) in ``cats``."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.types import VecType
    from h2o3_tpu_torch.frame.vec import Vec
    fr = Frame.from_arrays(cols, device=device)
    extra = {k: Vec(torch.as_tensor(codes).to(device), VecType.CAT,
                    domain=dom) for k, (codes, dom) in (cats or {}).items()}
    return Frame(fr.names + list(extra), fr.vecs + list(extra.values()))


def ms_frame(rows: int, device):
    """11a: 20 normal predictors (seed 41); y = 3 m0 - 2 m1 + 1.5 m2 + m3
    - 0.5 m4 + N(0, 1): the best subsets of sizes 1-3 are m0, m0-m1 and
    m0-m2, each clearly ahead of the next."""
    rng = np.random.default_rng(41)
    X = rng.normal(size=(rows, MS_FEAT)).astype(np.float32)
    y = X[:, :5] @ np.float32([3.0, -2.0, 1.5, 1.0, -0.5]) \
        + rng.normal(size=rows).astype(np.float32)
    return builder_frame(dict({f"m{i}": X[:, i] for i in range(MS_FEAT)},
                              y=y.astype(np.float32)), device)


def ms_check(card_sub, cpu_sub, x) -> dict:
    """ModelSelection (maxr to 2 predictors, 210 fits) and ANOVAGLM on a
    head, on the CPU and the card: the same subsets, R² at rtol 1e-5; the
    same degrees of freedom, deviances at rtol 1e-4 with a floor of 2e-6 x
    the full deviance (the CPU tests' tolerances), F values at that floor
    carried through, and each p-value within the F tail's values at the
    CPU's F plus and minus that F allowance."""
    from scipy.stats import f as f_dist
    from h2o3_tpu_torch.models.model_selection import ANOVAGLM, ModelSelection
    fits = [ModelSelection(max_predictor_number=2).train(
        x=x, y="y", training_frame=f) for f in (cpu_sub, card_sub)]
    a, b = (m.result() for m in fits)
    if [r["predictors"] for r in a] != [r["predictors"] for r in b]:
        raise AssertionError("11a: CPU and card select other subsets")
    ratio = close("11a R2", [r["r2"] for r in b], [r["r2"] for r in a], 1e-5)
    av = [ANOVAGLM().train(x=x[:6], y="y", training_frame=f)
          for f in (cpu_sub, card_sub)]
    ta, tb = (m.anova_table() for m in av)
    if [r["df"] for r in ta] != [r["df"] for r in tb]:
        raise AssertionError("11a: ANOVA degrees of freedom differ")
    dev_full = float(av[0].output["full_model"].output["residual_deviance"])
    floor = 2e-6 * dev_full
    df_resid = cpu_sub.nrows - 7
    f_tol = floor * df_resid / dev_full
    close("11a ANOVA deviance", [r["deviance"] for r in tb],
          [r["deviance"] for r in ta], 1e-4, floor)
    close("11a ANOVA F", [r["f_value"] for r in tb],
          [r["f_value"] for r in ta], 1e-4, f_tol)
    for ra, rb in zip(ta, tb):
        f_a, df = ra["f_value"], max(ra["df"], 1)
        allow = 1e-4 * f_a + f_tol
        lo = f_dist.sf(f_a + allow, df, df_resid)
        hi = f_dist.sf(max(f_a - allow, 0.0), df, df_resid)
        if not lo - 1e-15 <= rb["p_value"] <= hi + 1e-15:
            raise AssertionError(f"11a ANOVA p-value of {ra['predictor']}: "
                                 f"card {rb['p_value']}, CPU's F allows "
                                 f"[{lo}, {hi}]")
    return dict(rows=cpu_sub.nrows, r2_ratio=ratio)


def builders_model_selection(device) -> dict:
    """11a: ModelSelection maxr to 3 predictors (1,350 GLM fits; the
    device's busy share profiled on its 20 one-predictor fits) and
    ANOVAGLM (21 fits) on the 1M x 20 frame."""
    from h2o3_tpu_torch.models.model_selection import ANOVAGLM, ModelSelection
    fr = ms_frame(MS_ROWS, device)
    prime_rollups(fr)
    x = [f"m{i}" for i in range(MS_FEAT)]
    n_fits = sum(math.comb(MS_FEAT, k) for k in (1, 2, 3))

    def fit():
        return ModelSelection(mode="maxr", max_predictor_number=3).train(
            x=x, y="y", training_frame=fr)

    def sizes_1():
        return ModelSelection(mode="maxr", max_predictor_number=1).train(
            x=x, y="y", training_frame=fr)

    model, res = timed_fit(f"11a ModelSelection maxr to 3 of {MS_FEAT} "
                           f"predictors, {MS_ROWS} rows, {n_fits} GLM fits",
                           fit, MS_ROWS * n_fits, "rows*fits",
                           sample=("its 20 one-predictor fits", sizes_1))
    best = [r["predictors"] for r in model.result()]
    if best != [["m0"], ["m0", "m1"], ["m0", "m1", "m2"]] or not all(
            np.isfinite(r["r2"]) for r in model.result()):
        raise AssertionError(f"11a: best subsets {best}")
    res.update(n_fits=n_fits, best=best,
               r2=[r["r2"] for r in model.result()])
    am, ares = timed_fit(f"11a ANOVAGLM on {MS_FEAT} predictors, {MS_ROWS} "
                         "rows, 21 GLM fits",
                         lambda: ANOVAGLM().train(x=x, y="y",
                                                  training_frame=fr),
                         MS_ROWS * (MS_FEAT + 1), "rows*fits")
    pv = [r["p_value"] for r in am.anova_table()]
    if not (max(pv[:5]) < 1e-10 and all(np.isfinite(pv))):
        raise AssertionError(f"11a: ANOVA p-values {pv}")
    res["anova"] = dict(ares, p_values=pv)
    sub = head(fr, MS_CPU_ROWS)
    res["cross"] = ms_check(sub, frame_on(sub, "cpu"), x)
    print(f"  CPU / card on {MS_CPU_ROWS} rows (maxr to 2, 210 fits; "
          f"ANOVA on 6): subsets alike, R2 at {res['cross']['r2_ratio']:.3g}"
          " x rtol 1e-5")
    return res


def builders_gam(fr) -> dict:
    """11b: binomial GAM on phase 4's frame (cr x0-x2, tp [x3, x4],
    I-spline x5, 5 knots); on the first 200k rows on the CPU and the card:
    knots at rtol 1e-6, coefficients at rtol 1e-4 with a floor of 1e-3 x
    the largest and p1 at rtol 1e-4 with a floor of 1e-4 (the CPU tests'
    tolerances: the spline columns make the Gram ill-conditioned)."""
    from h2o3_tpu_torch.models.gam import GAM
    x = [f"x{i}" for i in range(NFEAT)]

    def fit(frame=fr):
        return GAM(**GAM_PARAMS).train(x=x, y="y", training_frame=frame)

    model, res = timed_fit(f"11b GAM binomial {ROWS} x {NFEAT}, cr x0-x2, "
                           "tp [x3, x4], I-spline x5, 5 knots", fit, ROWS,
                           "rows")
    coef = model.coef()
    ispl = [v for k, v in coef.items() if k.startswith("x5_gam_")]
    auc = model.training_metrics.auc
    if not (min(ispl) >= 0 and np.isfinite(list(coef.values())).all()
            and 0.5 < auc < 1.0):
        raise AssertionError(f"11b: I-spline coefficients {ispl}, AUC {auc}")
    res.update(auc=auc, n_coef=len(coef),
               iterations=model.output["glm"].output["iterations"])
    sub = head(fr, BUILDER_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    cpu, card = fit(cpu_sub), fit(sub)
    for k in cpu.output["knots"]:
        close(f"11b knots {k}", card.output["knots"][k],
              cpu.output["knots"][k], 1e-6)
    cv = np.asarray(list(cpu.coef().values()))
    ratio = close("11b coefficients", list(card.coef().values()), cv, 1e-4,
                  1e-3 * np.abs(cv).max())
    p_cpu = cpu._score_raw(cpu_sub)[:, 1].numpy()
    close("11b p1", card._score_raw(sub)[:, 1].cpu(), p_cpu, 1e-4,
          1e-4 * np.abs(p_cpu).max())
    res["cross"] = dict(rows=BUILDER_CPU_ROWS, coef_ratio=ratio)
    print(f"  training AUC {auc:.6f}, {len(coef)} coefficients; CPU / card "
          f"on {BUILDER_CPU_ROWS} rows: coefficients at {ratio:.3g} x "
          "(rtol 1e-4 + 1e-3 x max)")
    return res


def reset_kernel_counts() -> None:
    """Every histogram-kernel and node-totals launch count to 0."""
    from h2o3_tpu_torch.ops.hist import node_totals
    reset_launches()
    node_totals.launches = 0


def kernel_counts() -> tuple:
    """(launches by kernel, node-totals launches) since the last reset."""
    from h2o3_tpu_torch.ops.hist import level_histograms, node_totals
    return dict(level_histograms.kernel_launches), node_totals.launches


def hold_launches(what: str, plan: dict, trees: int) -> dict:
    """The kernel launches of the timed fit against the plan's, and one
    node-totals launch a tree."""
    by_kernel, totals = kernel_counts()
    if by_kernel != plan or totals != trees:
        raise AssertionError(f"{what}: kernels launched {by_kernel}, "
                             f"planned {plan}; node totals {totals}, "
                             f"expected {trees}")
    print(f"  kernel launches {by_kernel} as planned, node totals {totals}")
    return dict(by_kernel=by_kernel, launches=sum(by_kernel.values()),
                node_totals=totals)


def builders_rulefit(fr) -> dict:
    """11c: RuleFit at the JAX package's defaults (rules and linear terms,
    rule lengths 1-3, 10 trees a depth, lambda 1e-3) on phase 4's frame,
    its GBMs' launches held to the plan; on the first 20k rows on the CPU
    and the card: the same rules kept and the training logloss at rtol
    2e-3. The level-1 L1 GLM is singular and its probabilities are not
    fixed by float32 sums: on those rows, one float32 ulp added to every
    input moves the CPU's own p1 by up to 0.052 and its logloss by 7.5e-4
    relative, with the same rules; the CPU-card p1 difference is printed
    beside that."""
    from h2o3_tpu_torch.models.rulefit import RuleFit
    x = [f"x{i}" for i in range(NFEAT)]

    def fit(frame=fr):
        return RuleFit().train(x=x, y="y", training_frame=frame)

    model, res = timed_fit(f"11c RuleFit {ROWS} x {NFEAT}, depths 1-3 x 10 "
                           "trees, rules and linear, lambda 1e-3", fit, ROWS,
                           "rows", before_timed=reset_kernel_counts)
    plan = dict.fromkeys(("fixed", "global"), 0)
    for d in (1, 2, 3):
        for k, v in planned_launches(10, d, NBINS + 1, 1).items():
            plan[k] += v
    res.update(hold_launches("11c RuleFit", plan, 30))
    o = model.output
    auc = model.training_metrics.auc
    if not (0.5 < auc < 1.0 and np.isfinite(o["beta"]).all()):
        raise AssertionError(f"11c: AUC {auc}")
    res.update(auc=auc, rules_kept=int(o["rule_keep"].sum()),
               columns=len(o["rule_names"]),
               nonzero=len(model.rule_importance()))
    sub = head(fr, RULEFIT_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    cpu, card = fit(cpu_sub), fit(sub)
    if cpu.output["rule_names"] != card.output["rule_names"]:
        raise AssertionError("11c: CPU and card keep other rules")
    ratio = close("11c logloss", card.training_metrics.logloss,
                  cpu.training_metrics.logloss, 2e-3)
    dp = float((card._score_raw(sub)[:, 1].cpu()
                - cpu._score_raw(cpu_sub)[:, 1]).abs().max())
    res["cross"] = dict(rows=RULEFIT_CPU_ROWS, logloss_ratio=ratio,
                        p1_max_diff=dp)
    print(f"  training AUC {auc:.6f}; {res['rules_kept']} rules kept, "
          f"{res['nonzero']} non-zero; CPU / card on {RULEFIT_CPU_ROWS} "
          f"rows: the same rules, logloss at {ratio:.3g} x rtol 2e-3, p1 "
          f"{dp:.3g} apart (one float32 ulp of the inputs moves it 0.052)")
    return res


def builders_infogram(fr) -> dict:
    """11d: the core infogram with H2O's default GBM surrogates (20 trees,
    depth 5) on phase 4's frame: 1 + 28 surrogates, their launches held to
    the plan, the device's busy share profiled on one surrogate; on the
    first 20k rows and 6 predictors on the CPU and the
    card: the same predictor order and admissible set, relevance at rtol
    1e-3 and raw CMI at an absolute 1e-4 (the card's fixed-point histogram
    sums move the gains in their last bits)."""
    from h2o3_tpu_torch.models.infogram import Infogram
    x = [f"x{i}" for i in range(NFEAT)]

    def fit(frame=fr, cols=x):
        return Infogram().train(x=cols, y="y", training_frame=frame)

    def surrogate():
        return Infogram()._surrogate(x, "y", fr, fr.row_mask().float())

    model, res = timed_fit(f"11d Infogram core {ROWS} x {NFEAT}, 1 + "
                           f"{NFEAT} GBM surrogates (20 trees, depth 5)", fit,
                           ROWS * (NFEAT + 1), "rows*surrogates",
                           before_timed=reset_kernel_counts,
                           sample=("its relevance surrogate", surrogate))
    plan = {k: v * (NFEAT + 1)
            for k, v in planned_launches(20, 5, NBINS + 1, 1).items()}
    res.update(hold_launches("11d Infogram", plan, 20 * (NFEAT + 1)))
    o = model.output
    res.update(admissible=o["admissible_features"],
               relevance=dict(zip(o["all_predictor_names"], o["relevance"])),
               cmi=dict(zip(o["all_predictor_names"], o["cmi"])))
    if not (o["admissible_features"] and np.isfinite(o["cmi_raw"]).all()):
        raise AssertionError("11d: no admissible feature")
    sub = head(fr, INFOGRAM_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    cpu, card = (fit(f, x[:6]) for f in (cpu_sub, sub))
    co, ko = cpu.output, card.output
    if co["all_predictor_names"] != ko["all_predictor_names"] or \
            co["admissible_features"] != ko["admissible_features"]:
        raise AssertionError("11d: CPU and card rank other predictors")
    ratio = close("11d relevance", ko["relevance"], co["relevance"], 1e-3)
    close("11d raw CMI", ko["cmi_raw"], co["cmi_raw"], 0.0, 1e-4)
    res["cross"] = dict(rows=INFOGRAM_CPU_ROWS, relevance_ratio=ratio)
    print(f"  admissible {o['admissible_features']}; CPU / card on "
          f"{INFOGRAM_CPU_ROWS} rows, 6 predictors: the same ranking, "
          f"relevance at {ratio:.3g} x rtol 1e-3")
    return res


def iso_frame(rows: int, device):
    """11e: x uniform on [0, 10], y = log1p(x) + N(0, 0.3) (seed 42)."""
    rng = np.random.default_rng(42)
    x = rng.uniform(0, 10, rows).astype(np.float32)
    y = (np.log1p(x) + rng.normal(scale=0.3, size=rows)).astype(np.float32)
    return builder_frame(dict(x=x, y=y), device)


def builders_isotonic(device) -> dict:
    """11e: IsotonicRegression on 1M rows; on the first 200k rows on the
    CPU and the card: thresholds at rtol 1e-6, predictions at rtol 1e-6
    with a floor of 1e-6."""
    from h2o3_tpu_torch.models.isotonic import IsotonicRegression
    fr = iso_frame(ISO_ROWS, device)

    def fit(frame=fr):
        return IsotonicRegression().train(x=["x"], y="y",
                                          training_frame=frame)

    model, res = timed_fit(f"11e IsotonicRegression {ISO_ROWS} rows", fit,
                           ISO_ROWS, "rows")
    tx = model.output["thresholds_x"].cpu().numpy()
    ty = model.output["thresholds_y"].cpu().numpy()
    pred = model.predict(fr).vec("predict").to_numpy()
    if not (np.all(np.diff(tx) > 0) and np.all(np.diff(ty) >= 0)
            and np.isfinite(pred).all()):
        raise AssertionError("11e: thresholds not monotone")
    res.update(thresholds=len(tx), mse=model.training_metrics.mse)
    sub = head(fr, BUILDER_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    cpu, card = fit(cpu_sub), fit(sub)
    close("11e thresholds", card.output["thresholds_y"].cpu(),
          cpu.output["thresholds_y"], 1e-6, 1e-6)
    ratio = close("11e predictions", card._score_raw(sub).cpu(),
                  cpu._score_raw(cpu_sub), 1e-6, 1e-6)
    res["cross"] = dict(rows=BUILDER_CPU_ROWS, ratio=ratio)
    print(f"  {len(tx)} thresholds, training MSE {res['mse']:.6f}; CPU / "
          f"card on {BUILDER_CPU_ROWS} rows: predictions at {ratio:.3g} x "
          "(rtol 1e-6 + 1e-6)")
    return res


#: 11f's true coefficients
COX_BETA = np.float32([0.5, -0.4, 0.3, 0.2, -0.1, 0, 0, 0, 0, 0])


def cox_frame(rows: int, device):
    """11f: 10 normal covariates (seed 43), hazard exp(x·beta), times in
    days rounded up and capped at 1..3,650 (heavy ties), ~30% censored."""
    rng = np.random.default_rng(43)
    X = rng.normal(size=(rows, COX_FEAT)).astype(np.float32)
    haz = np.exp(X @ COX_BETA)
    t = np.clip(np.ceil(rng.exponential(1.0 / haz) * 365.0), 1, 3650)
    event = (rng.random(rows) >= 0.3).astype(np.float32)
    return builder_frame(dict({f"c{i}": X[:, i] for i in range(COX_FEAT)},
                              t=t.astype(np.float32), event=event), device)


def builders_coxph(device) -> dict:
    """11f: CoxPH with Efron ties on 1M rows, then its concordance; on the
    first 200k rows on the CPU and the card: coefficients at rtol 1e-4,
    the log-likelihood at rtol 1e-5, the baseline hazard and the
    concordance at rtol 1e-4 (the CPU tests' tolerances)."""
    from h2o3_tpu_torch.models.coxph import CoxPH
    fr = cox_frame(COX_ROWS, device)
    x = [f"c{i}" for i in range(COX_FEAT)]

    def fit(frame=fr):
        return CoxPH(stop_column="t").train(x=x, y="event",
                                            training_frame=frame)

    model, res = timed_fit(f"11f CoxPH Efron {COX_ROWS} x {COX_FEAT}", fit,
                           COX_ROWS, "rows")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    conc = model.concordance()
    conc_s = time.perf_counter() - t0
    coef = model.output["coef"].cpu().numpy()
    if not (np.abs(coef - COX_BETA).max() < 0.05 and 0.5 < conc < 1.0):
        raise AssertionError(f"11f: coefficients {coef}, concordance {conc}")
    res.update(iterations=model.output["iterations"], coef=coef.tolist(),
               concordance=conc, concordance_s=conc_s,
               tie_groups=len(model.output["baseline_times"]))
    sub = head(fr, BUILDER_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    cpu, card = fit(cpu_sub), fit(sub)
    co, ko = cpu.output, card.output
    ratio = close("11f coefficients", ko["coef"].cpu(), co["coef"], 1e-4)
    close("11f loglik", ko["loglik"], co["loglik"], 1e-5)
    close("11f baseline hazard", ko["baseline_cumhaz"],
          co["baseline_cumhaz"], 1e-4)
    close("11f concordance", card.concordance(), cpu.concordance(), 1e-4)
    res["cross"] = dict(rows=BUILDER_CPU_ROWS, coef_ratio=ratio)
    print(f"  {res['iterations']} Newton iterations, {res['tie_groups']} tie "
          f"groups, concordance {conc:.6f} in {conc_s:.3f} s; CPU / card on "
          f"{BUILDER_CPU_ROWS} rows: coefficients at {ratio:.3g} x rtol 1e-4")
    return res


def hglm_frame(rows: int, device):
    """11g: 5 normal fixed effects (seed 44), 1,000 groups, a random
    intercept (sd 1) and a random slope on h0 (sd 0.5), noise sd 1."""
    rng = np.random.default_rng(44)
    X = rng.normal(size=(rows, 5)).astype(np.float32)
    g = rng.integers(0, HGLM_GROUPS, rows)
    u0 = rng.normal(size=HGLM_GROUPS)
    u1 = rng.normal(scale=0.5, size=HGLM_GROUPS)
    y = 1.0 + X @ np.float32([1.0, -0.5, 0.25, 0.0, 0.75]) + u0[g] \
        + u1[g] * X[:, 0] + rng.normal(size=rows)
    dom = tuple(f"g{i:04d}" for i in range(HGLM_GROUPS))
    return builder_frame(dict({f"h{i}": X[:, i] for i in range(5)},
                              y=y.astype(np.float32)), device,
                         cats=dict(grp=(g.astype(np.int32), dom)))


def builders_hglm(device) -> dict:
    """11g: HGLM with a random intercept and a random slope on h0 (q = 2)
    over 1,000 groups of 1M rows; on the first 200k rows on the CPU and
    the card: fixed effects, random effects and both variances at rtol
    1e-4 with a floor of 1e-4 x each's largest (the CPU tests')."""
    from h2o3_tpu_torch.models.hglm import HGLM
    fr = hglm_frame(HGLM_ROWS, device)
    x = [f"h{i}" for i in range(5)]

    def fit(frame=fr):
        return HGLM(group_column="grp", random_columns=["h0"]).train(
            x=x, y="y", training_frame=frame)

    model, res = timed_fit(f"11g HGLM {HGLM_ROWS} rows, 5 fixed effects, "
                           f"{HGLM_GROUPS} groups, q = 2", fit, HGLM_ROWS,
                           "rows")
    o = model.output
    if not (0.4 < o["sig_u"] < 1.2 and 0.8 < o["sig_e"] < 1.2):
        raise AssertionError(f"11g: variances {o['sig_u']}, {o['sig_e']}")
    res.update(iterations=o["iterations"], sig_u=o["sig_u"],
               sig_e=o["sig_e"], coef=o["coef"].tolist())
    sub = head(fr, BUILDER_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    cpu, card = fit(cpu_sub), fit(sub)
    co, ko = cpu.output, card.output
    ratio = close("11g fixed effects", ko["coef"], co["coef"], 1e-4,
                  1e-4 * np.abs(co["coef"]).max())
    u = co["u"].numpy()
    close("11g random effects", ko["u"].cpu(), u, 1e-4, 1e-4 * np.abs(u).max())
    close("11g variances", [ko["sig_u"], ko["sig_e"]],
          [co["sig_u"], co["sig_e"]], 1e-4)
    res["cross"] = dict(rows=BUILDER_CPU_ROWS, coef_ratio=ratio,
                        iterations=(co["iterations"], ko["iterations"]))
    print(f"  {o['iterations']} EM iterations, sig_u {o['sig_u']:.6f}, "
          f"sig_e {o['sig_e']:.6f}; CPU / card on {BUILDER_CPU_ROWS} rows: "
          f"fixed effects at {ratio:.3g} x (rtol 1e-4 + 1e-4 x max)")
    return res


def builders_psvm(fr) -> dict:
    """11h: PSVM at its defaults (gaussian kernel, gamma 1/28, rank
    sqrt(n) = 316, C 1) on the first 100k rows of phase 4's frame, scored
    in row blocks; on the first 20k rows on the CPU and the card: training
    AUC within 5e-3 and the decision's sign alike on 99% of rows (the IPM
    is chaotic in float32; the CPU tests hold it so)."""
    from h2o3_tpu_torch.models.psvm import PSVM
    x = [f"x{i}" for i in range(NFEAT)]
    sub = head(fr, PSVM_ROWS)

    def fit(frame=sub):
        return PSVM().train(x=x, y="y", training_frame=frame)

    model, res = timed_fit(f"11h PSVM {PSVM_ROWS} x {NFEAT}, rank 316", fit,
                           PSVM_ROWS, "rows")
    auc = model.training_metrics.auc
    if not (model.output["svs_count"] > 0 and 0.5 < auc < 1.0):
        raise AssertionError(f"11h: {model.output['svs_count']} SVs, "
                             f"AUC {auc}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.decision_function(sub)
    torch.cuda.synchronize()
    res.update(auc=auc, svs=model.output["svs_count"],
               rank=model.output["rank"],
               score_s=time.perf_counter() - t0)
    small = head(fr, PSVM_CPU_ROWS)
    cpu_small = frame_on(small, "cpu")
    cpu, card = fit(cpu_small), fit(small)
    d_auc = abs(cpu.training_metrics.auc - card.training_metrics.auc)
    agree = float((np.sign(card.decision_function(small).cpu().numpy())
                   == np.sign(cpu.decision_function(cpu_small).numpy()))
                  .mean())
    if not (d_auc <= 5e-3 and agree >= 0.99):
        raise AssertionError(f"11h: CPU and card AUC {d_auc} apart, signs "
                             f"alike on {agree}")
    res["cross"] = dict(rows=PSVM_CPU_ROWS, auc_diff=d_auc, agree=agree)
    print(f"  {res['svs']} support vectors, training AUC {auc:.6f}, scoring "
          f"{res['score_s']:.3f} s; CPU / card on {PSVM_CPU_ROWS} rows: AUC "
          f"{d_auc:.2e} apart, signs alike on {agree:.4f}")
    return res


def phase_builders(fr) -> dict:
    """Phase 11: 11a ModelSelection and ANOVAGLM, 11b GAM, 11c RuleFit,
    11d Infogram, 11e IsotonicRegression, 11f CoxPH, 11g HGLM and 11h
    PSVM, each timed after a warm run under torch.profiler and held to
    the CPU on a head; each part's seconds (its CPU check included) in
    ``part_seconds``."""
    t0 = time.perf_counter()
    dev = fr.device
    out, parts = {}, {}
    for name, part in (("11a_model_selection",
                        lambda: builders_model_selection(dev)),
                       ("11b_gam", lambda: builders_gam(fr)),
                       ("11c_rulefit", lambda: builders_rulefit(fr)),
                       ("11d_infogram", lambda: builders_infogram(fr)),
                       ("11e_isotonic", lambda: builders_isotonic(dev)),
                       ("11f_coxph", lambda: builders_coxph(dev)),
                       ("11g_hglm", lambda: builders_hglm(dev)),
                       ("11h_psvm", lambda: builders_psvm(fr))):
        t1 = time.perf_counter()
        out[name] = part()
        parts[name] = time.perf_counter() - t1
        print(f"phase {name}: {parts[name]:.1f} s")
        torch.cuda.empty_cache()
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card_name()
    print(f"phase 11: {out['seconds']:.1f} s; by part "
          f"{ {k: round(v, 1) for k, v in parts.items()} }")
    return out


# -- phase 12: cross-validation, TargetEncoder, explanations, Aggregator, ---
# -- and the scikit-learn surface ---------------------------------------------

#: bench_gbm's configuration (phase 4)
MAIN_GBM = dict(ntrees=NTREES, max_depth=DEPTH, nbins=NBINS, learn_rate=0.1,
                seed=42)
#: AutoML's CV setting (h2o3_tpu/orchestration/automl.py:185)
CV_FOLDS = 5
#: H2O-3's Target Encoding docs' example settings, on three airlines columns
TE_COLS = ["Origin", "Dest", "UniqueCarrier"]
TE_PARAMS = dict(data_leakage_handling="KFold", blending=True,
                 inflection_point=3, smoothing=10, noise=0.15, nfolds=5,
                 seed=42)
#: phase 7's GBM (validation, stopping on logloss, monotone DepTime)
AIRLINE_GBM = dict(ntrees=300, max_depth=DEPTH, nbins=NBINS, learn_rate=0.1,
                   stopping_rounds=5, stopping_metric="logloss",
                   stopping_tolerance=1e-4,
                   monotone_constraints={"DepTime": 1}, seed=42)
#: a user explains, aggregates and fits sklearn on a sample of phase 4's frame
SAMPLE_ROWS = 1_000_000
#: H2O-3's AggregatorModel default (the JAX package's is 100)
AGG_EXEMPLARS = 5000
#: the CPU heads of phase 12's CPU-against-card checks
CV_CPU_ROWS = EXPLAIN_CPU_ROWS = 10_000
AGG_CPU_ROWS = 20_000
TE_CPU_ROWS = 50_000


def cv_part(fr) -> tuple:
    """12a: bench_gbm's GBM with 5-fold CV and the out-of-fold predictions
    kept (AutoML's setting) on phase 4's frame: 6 fits, exactly 720
    fixed-kernel launches and 120 node totals; the main model bit for bit
    a GBM trained without CV; the pooled CV AUC that of the kept
    predictions; 5 folds in the summary. Profiled on one fold (a fit with
    a fold's weights). On the first 10k rows, the CPU's CV against the
    card's: the same folds, CV AUC within 1e-4, logloss at rtol 1e-4 and
    out-of-fold probabilities within 1e-4 (phase 3's tolerances)."""
    from h2o3_tpu_torch.models.data_info import response_as_float
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.models.model_base import compute_metrics

    def cv(frame):
        return GBM(nfolds=CV_FOLDS, keep_cross_validation_predictions=True,
                   **MAIN_GBM).train(y="y", training_frame=frame)

    fold_w = (torch.arange(ROWS, device=fr.device) % CV_FOLDS != 0).float()

    def one_fold():
        GBM(**MAIN_GBM).train(y="y", training_frame=fr, weights=fold_w)

    fits = CV_FOLDS + 1
    model, res = timed_fit(
        f"12a CV GBM {ROWS} x {NFEAT}, {CV_FOLDS} folds, {NTREES} trees "
        f"depth {DEPTH}", lambda: cv(fr), ROWS * NTREES * fits, "rows*trees",
        before_timed=reset_kernel_counts, sample=("one fold", one_fold))
    res.update(hold_launches("12a", planned_launches(
        NTREES * fits, DEPTH, NBINS + 1, 1), NTREES * fits))
    plain = GBM(**MAIN_GBM).train(y="y", training_frame=fr)
    same = (_heaps_bitwise(plain, model)
            and plain.training_metrics.auc == model.training_metrics.auc
            and plain.training_metrics.logloss
            == model.training_metrics.logloss)
    cvm = model.cross_validation_metrics
    rescored = compute_metrics(model.cv_holdout_predictions,
                               response_as_float(fr.vec("y"))[0],
                               model.cv_holdout_mask, 2)
    names, k, rows = model.cv_metrics_summary
    print(f"  main model bit for bit the plain GBM's: {same}; CV AUC "
          f"{cvm.auc:.6f} logloss {cvm.logloss:.6f} (training AUC "
          f"{model.training_metrics.auc:.6f}), the kept predictions' AUC "
          f"{rescored.auc:.6f}; summary {names} over {k} folds")
    if not same:
        raise AssertionError("12a: the main model differs from a GBM "
                             "trained without CV")
    if not (np.isfinite(cvm.auc) and 0.5 < cvm.auc
            and rescored.auc == cvm.auc
            and rescored.logloss == cvm.logloss
            and bool(model.cv_holdout_mask.all())):
        raise AssertionError(f"12a: CV metrics {cvm}, rescored {rescored}")
    if k != CV_FOLDS or any(len(r) != 3 + CV_FOLDS for r in rows):
        raise AssertionError(f"12a: summary {model.cv_metrics_summary}")
    sub = head(fr, CV_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    cpu, card = cv(cpu_sub), cv(sub)
    d_auc = abs(cpu.cross_validation_metrics.auc
                - card.cross_validation_metrics.auc)
    ll = close("12a CV logloss", card.cross_validation_metrics.logloss,
               cpu.cross_validation_metrics.logloss, 1e-4)
    d_oof = float((card.cv_holdout_predictions.cpu()
                   - cpu.cv_holdout_predictions).abs().max())
    print(f"  CPU / card on {CV_CPU_ROWS} rows: CV AUC {d_auc:.2e} apart, "
          f"logloss at {ll:.3g} x rtol 1e-4, out-of-fold probabilities "
          f"{d_oof:.2e} apart")
    if not (d_auc < 1e-4 and d_oof <= 1e-4):
        raise AssertionError("12a: CPU and card CV disagree")
    res.update(cv_auc=cvm.auc, cv_logloss=cvm.logloss,
               train_auc=model.training_metrics.auc, main_bitwise=same,
               summary=dict(zip(names, (r[1] for r in rows))),
               cross=dict(rows=CV_CPU_ROWS, auc_diff=d_auc, logloss_ratio=ll,
                          oof_max_diff=d_oof))
    del plain, cpu, card, fold_w
    return model, res


def te_part(air_fr, air_vf) -> dict:
    """12b: TargetEncoder at H2O-3's documented example settings (KFold,
    blending, inflection point 3, smoothing 10, noise 0.15, 5 folds) on
    Origin, Dest and UniqueCarrier of phase 7's 10M-row frame, the
    training frame transformed as_training and the validation frame by
    the full statistics; then phase 7's GBM with those columns replaced by
    their encodings, its launches held to the plan for the trees it grew.
    |noisy - clean| <= 0.15; on the first 50k rows, the CPU's encodings
    without noise against the card's at rtol 1e-6."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.models.target_encoder import TargetEncoder

    def te(frame, **over):
        return TargetEncoder(**dict(TE_PARAMS, **over)).train(
            x=TE_COLS, y=AIRLINE_Y, training_frame=frame)

    def encode(**over):
        m = te(air_fr, **over)
        return m, m.transform(air_fr, as_training=True), m.transform(air_vf)

    (model, tr, va), res = timed_fit(
        f"12b TargetEncoder {AIRLINE_ROWS} rows x {len(TE_COLS)} columns, "
        "KFold 5, blending, noise 0.15", encode, AIRLINE_ROWS, "rows")
    _, clean, _ = encode(noise=0.0)
    d_noise = max(float((tr.vec(f"{c}_te").data.double()
                         - clean.vec(f"{c}_te").data.double()).abs().max())
                  for c in TE_COLS)
    del clean
    print(f"  |noisy - clean| at most {d_noise:.6f}")
    if not 0.1 < d_noise <= 0.15 + 2 ** -23:
        raise AssertionError(f"12b: the noise reaches {d_noise}")
    x_te = [c for c in AIRLINE_X if c not in TE_COLS] + \
        [f"{c}_te" for c in TE_COLS]
    builders = []

    def gbm(**over):
        b = GBM(**dict(AIRLINE_GBM, **over))
        builders.append(b)
        return b.train(x=x_te, y=AIRLINE_Y, training_frame=tr,
                       validation_frame=va)

    gm, gres = timed_fit(
        f"12b GBM on the encodings {AIRLINE_ROWS} x {len(x_te)}, up to "
        "300 trees, stopping", gbm, AIRLINE_ROWS, "rows",
        before_timed=reset_kernel_counts,
        sample=("10 of its trees", lambda: gbm(ntrees=10,
                                               stopping_rounds=0)))
    grown = builders[-1]._rounds_grown
    gres.update(hold_launches("12b GBM", planned_launches(
        grown, DEPTH, NBINS + 1, 1), grown))
    tm, vm = gm.training_metrics, gm.validation_metrics
    scored = gm.model_performance(tr)
    print(f"  {grown} trees grown, {gm.output['ntrees']} kept; training AUC "
          f"{tm.auc:.6f} logloss {tm.logloss:.6f}, validation AUC "
          f"{vm.auc:.6f} logloss {vm.logloss:.6f}")
    if not (abs(scored.logloss - tm.logloss) < 1e-4 and vm.auc > 0.6
            and np.isfinite(vm.logloss)):
        raise AssertionError(f"12b: GBM metrics {tm} {vm} scored {scored}")
    sub = head(air_fr, TE_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    worst = 0.0
    ms = [te(f, noise=0.0) for f in (cpu_sub, sub)]
    for c in TE_COLS:
        worst = max(worst, close(f"12b {c} table", ms[1].output["lut"][c]
                                 .cpu(), ms[0].output["lut"][c], 1e-6))
        for t in (True, False):
            got = ms[1].transform(sub, as_training=t).vec(f"{c}_te").data
            want = ms[0].transform(cpu_sub, as_training=t).vec(f"{c}_te").data
            worst = max(worst, close(f"12b {c} as_training={t}", got.cpu(),
                                     want, 1e-6))
    print(f"  CPU / card encodings on {TE_CPU_ROWS} rows at {worst:.3g} x "
          "rtol 1e-6")
    res.update(noise_max=d_noise, gbm=gres, trees_grown=grown,
               trees_kept=gm.output["ntrees"], valid_auc=vm.auc,
               valid_logloss=vm.logloss,
               cross=dict(rows=TE_CPU_ROWS, ratio=worst))
    del model, tr, va, gm, builders
    return res


def explain_part(gbm, fr1m) -> dict:
    """12c: the 12a model and a binomial GLM (phase 8a's settings) fitted
    on the first 1M rows of phase 4's frame, explained there: ``explain``
    (varimp heatmap, model correlation, partial dependence of each model's
    top 5 features, the GBM's SHAP summary), ``permutation_varimp`` (seed
    42) and ``ice`` of x0; the scorings counted. Profiled on x0's partial
    dependence. On the first 10k rows, the CPU against the card: partial
    dependence at rtol 1e-5, the SHAP ranking equal, permutation deltas
    at rtol 1e-4 with a floor of 1e-6."""
    from h2o3_tpu_torch.explanation import (explain, ice, partial_dependence,
                                            permutation_varimp, shap_summary)
    from h2o3_tpu_torch.models.glm import GLM
    glm = GLM(family="binomial", lambda_=1e-4, max_iterations=30).train(
        y="y", training_frame=fr1m)
    scorings = {"gbm": 0, "glm": 0}

    def count(model, key):
        inner = model._score_raw

        def scored(frame):
            scorings[key] += 1
            return inner(frame)
        model._score_raw = scored

    count(gbm, "gbm")
    count(glm, "glm")

    def run():
        return (explain([gbm, glm], fr1m),
                permutation_varimp(gbm, fr1m, seed=42),
                ice(gbm, fr1m, "x0"))

    (bundle, pvi, curves), res = timed_fit(
        f"12c explain [GBM, GLM] + permutation varimp + ICE on "
        f"{SAMPLE_ROWS} rows", run, SAMPLE_ROWS, "rows",
        before_timed=lambda: scorings.update(gbm=0, glm=0),
        sample=("x0's partial dependence",
                lambda: partial_dependence(gbm, fr1m, "x0")))
    del gbm._score_raw, glm._score_raw
    want = {"gbm": 1 + 5 * 20 + (1 + NFEAT) + 20, "glm": 1 + 5 * 20}
    corr = bundle["model_correlation"]["matrix"][0][1]
    top = [r[0] for r in gbm.varimp()[:5]]
    pd_card = bundle["models"][gbm.key]["partial_dependence"]
    print(f"  scorings {scorings} (expected {want}); model correlation "
          f"{corr:.4f}; GBM top features {top}; permutation top "
          f"{[r['variable'] for r in pvi[:3]]}; ICE {curves.nrows} rows")
    if scorings != want or not 0.5 < corr <= 1.0 or curves.nrows != 2000:
        raise AssertionError(f"12c: scorings {scorings}, correlation {corr}")
    for c, t in pd_card.items():
        if not np.isfinite(t.vec("mean_response").to_numpy()).all():
            raise AssertionError(f"12c: partial dependence of {c}")
    sub = head(fr1m, EXPLAIN_CPU_ROWS)
    cpu_sub = frame_on(sub, "cpu")
    gcpu = model_on(gbm, "cpu")
    worst = 0.0
    for a, b in zip(partial_dependence(gbm, sub, top),
                    partial_dependence(gcpu, cpu_sub, top)):
        worst = max(worst, close("12c partial dependence",
                                 a.vec("mean_response").to_numpy(),
                                 b.vec("mean_response").to_numpy(), 1e-5))
    rank_card = [r[0] for r in shap_summary(gbm, sub)]
    rank_cpu = [r[0] for r in shap_summary(gcpu, cpu_sub)]
    pv_card = {r["variable"]: r["relative_importance"]
               for r in permutation_varimp(gbm, sub, seed=42)}
    pv_cpu = {r["variable"]: r["relative_importance"]
              for r in permutation_varimp(gcpu, cpu_sub, seed=42)}
    pv = close("12c permutation deltas", [pv_card[c] for c in pv_cpu],
               list(pv_cpu.values()), 1e-4, 1e-6)
    print(f"  CPU / card on {EXPLAIN_CPU_ROWS} rows: partial dependence at "
          f"{worst:.3g} x rtol 1e-5, SHAP ranking alike "
          f"{rank_card == rank_cpu}, permutation deltas at {pv:.3g} x the "
          "tolerance")
    if rank_card != rank_cpu:
        raise AssertionError(f"12c: SHAP ranking {rank_card} vs {rank_cpu}")
    res.update(scorings=scorings, correlation=corr, gbm_top=top,
               permutation_top=[r["variable"] for r in pvi[:5]],
               cross=dict(rows=EXPLAIN_CPU_ROWS, pd_ratio=worst,
                          permutation_ratio=pv))
    del glm, bundle
    return res


def aggregator_part(fr1m) -> dict:
    """12d: Aggregator at H2O-3's default 5,000 exemplars, NORMALIZE, on
    the first 1M rows of phase 4's frame: 5,000 exemplars, counts summing
    to 1M, peak memory under 8 GiB (the assignment row-blocked), its
    fetches counted; profiled on one chunk of the sweep (257 exemplars).
    On the first 20k rows with the first exemplar injected (row 0), the
    CPU's exemplars, assignment and counts against the card's, exactly."""
    from h2o3_tpu_torch.models import aggregator
    from h2o3_tpu_torch.models.aggregator import Aggregator
    x = [f"x{i}" for i in range(NFEAT)]

    def agg(frame, k=AGG_EXEMPLARS):
        return Aggregator(target_num_exemplars=k, transform="NORMALIZE"
                          ).train(x=x, training_frame=frame)

    model, res = timed_fit(
        f"12d Aggregator {SAMPLE_ROWS} x {NFEAT}, {AGG_EXEMPLARS} exemplars",
        lambda: agg(fr1m), SAMPLE_ROWS, "rows",
        sample=("one chunk of the sweep", lambda: agg(
            fr1m, aggregator.SWEEP_CHUNK + 1)))
    counts = model.output["counts"]
    n_ex = len(model.output["exemplar_rows"])
    total = float(counts.sum())
    print(f"  {n_ex} exemplars, counts summing to {total:.0f}, "
          f"{(counts == 0).sum().item()} empty")
    if n_ex != AGG_EXEMPLARS or total != SAMPLE_ROWS \
            or res["peak_gib"] >= 8.0:
        raise AssertionError(f"12d: {n_ex} exemplars, counts {total}, peak "
                             f"{res['peak_gib']} GiB")
    sub = head(fr1m, AGG_CPU_ROWS)
    first = aggregator._first_exemplar
    aggregator._first_exemplar = lambda mask, seed: 0
    try:
        cpu, card = agg(frame_on(sub, "cpu")), agg(sub)
    finally:
        aggregator._first_exemplar = first
    same = (np.array_equal(cpu.output["exemplar_rows"],
                           card.output["exemplar_rows"])
            and torch.equal(cpu.output["exemplar_assignment"],
                            card.output["exemplar_assignment"].cpu())
            and torch.equal(cpu.output["counts"],
                            card.output["counts"].cpu()))
    print(f"  CPU / card on {AGG_CPU_ROWS} rows, first exemplar row 0: the "
          f"same exemplars, assignment and counts {same}")
    if not same:
        raise AssertionError("12d: CPU and card aggregate otherwise")
    res.update(exemplars=n_ex, counts_sum=total,
               sweep_fetches=model.output.get("sweep_fetches"),
               cross=dict(rows=AGG_CPU_ROWS, same=same))
    return res


def sklearn_part(fr1m) -> dict:
    """12e: ``H2OGradientBoostingClassifier(ntrees=20, max_depth=6)``
    fitted on the first 1M rows of phase 4's frame as numpy, its
    ``predict_proba`` equal bit for bit to the port's GBM trained and
    scored on the same frames."""
    from h2o3_tpu_torch import sklearn_adapter as sk
    from h2o3_tpu_torch.models.gbm import GBM
    X = torch.stack([fr1m.vec(f"x{i}").data for i in range(NFEAT)],
                    1).cpu().numpy()
    yv = fr1m.vec("y")
    y = np.asarray(yv.domain)[yv.data.cpu().numpy()]
    params = dict(ntrees=NTREES, max_depth=DEPTH)

    def fit():
        clf = sk.H2OGradientBoostingClassifier(**params).fit(X, y)
        return clf, clf.predict_proba(X)

    (clf, proba), res = timed_fit(
        f"12e sklearn GBM classifier fit + predict_proba on {SAMPLE_ROWS} "
        f"x {NFEAT} numpy", fit, SAMPLE_ROWS, "rows")
    fr, names, ycol = sk._to_frame(X, y, classification=True)
    m = GBM(**params).train(x=names, y=ycol, training_frame=fr)
    pred = m.predict(sk._to_frame(X)[0])
    want = np.stack([pred.vec(f"p{d}").to_numpy()
                     for d in m.response_domain], 1)
    same = np.array_equal(proba, want)
    print(f"  classes {[str(c) for c in clf.classes_]}; predict_proba bit "
          f"for bit the GBM's predict: {same}; accuracy "
          f"{clf.score(X, y):.4f}")
    if not same or proba.shape != (SAMPLE_ROWS, 2):
        raise AssertionError("12e: predict_proba differs from GBM.predict")
    res.update(bitwise=same)
    return res


def phase_cv_explain(fr, air_fr, air_vf) -> dict:
    """Phase 12: 12a CV GBM, 12b TargetEncoder → GBM, 12c explanations,
    12d Aggregator and 12e scikit-learn, each timed after a warm run under
    the sync counter with its peak memory, profiled on a like part, and
    held to the CPU on a head; each part's seconds (its CPU check
    included) in ``part_seconds``."""
    t0 = time.perf_counter()
    out, parts = {}, {}
    fr1m = head(fr, SAMPLE_ROWS)
    prime_rollups(fr1m)
    holder = {}

    def cv():
        holder["gbm"], res = cv_part(fr)
        return res

    for name, part in (("12a_cv_gbm", cv),
                       ("12b_target_encoder", lambda: te_part(air_fr,
                                                              air_vf)),
                       ("12c_explain", lambda: explain_part(holder["gbm"],
                                                            fr1m)),
                       ("12d_aggregator", lambda: aggregator_part(fr1m)),
                       ("12e_sklearn", lambda: sklearn_part(fr1m))):
        t1 = time.perf_counter()
        out[name] = part()
        parts[name] = time.perf_counter() - t1
        print(f"phase {name}: {parts[name]:.1f} s")
        torch.cuda.empty_cache()
    del holder
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card_name()
    print(f"phase 12: {out['seconds']:.1f} s; by part "
          f"{ {k: round(v, 1) for k, v in parts.items()} }")
    return out


# -- phase 13: the DKV and orchestration ---------------------------------

#: 13a: H2O-3's AutoML docs' Python example, ``H2OAutoML(max_models=20,
#: seed=1)``, cut to 10 models (ROADMAP.md "Reduced checks"); the JAX
#: package's defaults otherwise (nfolds 5, parallelism 2, sort by AUC)
AML_ROWS = 1_000_000
AML = dict(max_models=10, seed=1)
#: 13a's CPU head: the same plan, smaller (2 models where 3 were planned:
#: ROADMAP.md "Reduced checks")
AML_CPU = dict(max_models=2, nfolds=3, seed=1,
               include_algos=["GLM", "GBM", "STACKEDENSEMBLE"])
AML_CPU_ROWS = 5_000
#: the like part of 13a that is profiled: one fold of the GBM step def_1,
#: at this many of its trees
AML_PROFILE_TREES = 10
#: 13b: AutoML's own GBM grid (h2o3_tpu/orchestration/automl.py:138-153)
GRID_HYPER = {"max_depth": [3, 5, 7, 9], "learn_rate": [0.05, 0.1, 0.2],
              "sample_rate": [0.6, 0.8, 1.0],
              "col_sample_rate": [0.4, 0.7, 1.0]}
GRID_CRITERIA = dict(strategy="RandomDiscrete", max_models=6, seed=42)
GRID_FIXED = dict(ntrees=50, seed=1, nfolds=0)
#: the deepest tree of 65 bins whose every level runs the fixed kernel:
#: its last level histograms 2^(depth-2) nodes, below the 64 at which
#: ``_KERNEL_SWITCH`` takes the global kernel
FIXED_DEPTH_65 = 7
#: 13c: tests/test_orchestration.py:159's settings
TE_AML = dict(max_models=5, nfolds=0, seed=7,
              include_algos=["GBM", "STACKEDENSEMBLE"],
              preprocessing=["target_encoding"], exploitation_ratio=0.2)
#: 13d: one GBM per carrier (H2O-3's train_segments)
SEG_GBM = dict(ntrees=20, max_depth=5, seed=1)
SEG_COL = "UniqueCarrier"
SEG_CPU_ROWS = 20_000
#: 13d's CPU head grows the segment models' first trees only
SEG_CPU_TREES = 5


def model_plan(models) -> tuple:
    """The launches of each kernel, and of the node totals, that trees
    grown as ``models``' were grew: per fit (the main model and each fold)
    and tree, one launch a level, of the kernel the plan takes at the
    level's node count and bin count (:func:`planned_launches`)."""
    from h2o3_tpu_torch.ops.quantile import bin_dtype
    plan, totals = {}, 0
    for m in models:
        if m.algo not in ("gbm", "xgboost"):
            continue
        p = m.params
        nfolds = int(p.get("nfolds") or 0)
        fits = nfolds + 1 if nfolds >= 2 else 1
        trees = int(m.output["ntrees"]) * fits
        nb = int(p["nbins"])
        for k, n in planned_launches(
                trees, int(p["max_depth"]), nb + 1,
                torch.empty((), dtype=bin_dtype(nb)).element_size()).items():
            plan[k] = plan.get(k, 0) + n
        totals += trees
    return plan, totals


@contextlib.contextmanager
def count_shapes():
    """A tally of the tree engine's histogram calls by (bins, nodes), kept
    while the context is open (calls from every build thread; each call
    is one launch on the card)."""
    from h2o3_tpu_torch.models import tree
    tally: dict = {}
    inner = tree.level_histograms

    def counted(binned_T, node, g, h, w, n_nodes, n_bins_tot):
        key = (n_bins_tot, n_nodes)
        tally[key] = tally.get(key, 0) + 1
        return inner(binned_T, node, g, h, w, n_nodes, n_bins_tot)

    tree.level_histograms = counted
    try:
        yield tally
    finally:
        tree.level_histograms = inner


def step_seconds(aml) -> list:
    """(model key, step, seconds) of each base and annealed step, from the
    EventLog's "model" and "exploit" events."""
    import re
    out = []
    for _, _lvl, stage, msg, _n, _v in aml.event_log.events:
        if stage == "model":
            m = re.fullmatch(r"(\S+) \((\w+)\) in ([0-9.]+)s", msg)
            if m:
                out.append((m[1], m[2], float(m[3])))
        elif stage == "exploit":
            m = re.fullmatch(r"lr-annealed (\w+): (\S+) in ([0-9.]+)s", msg)
            out.append((m[2], f"{m[1]} annealed", float(m[3])))
    return out


def events_ok(what: str, aml) -> None:
    errs = [e for e in aml.event_log.events if e[2] == "error"]
    if errs:
        raise AssertionError(f"{what}: the EventLog holds errors {errs}")


def automl_part(fr1m) -> dict:
    """13a: AutoML(max_models=10, seed=1) at nfolds 5 and parallelism 2 on
    the first 1M rows of phase 4's frame: the budget takes GLM, the three
    XGBoosts, the five GBMs and the lr-annealed GBM, 60 fits, then the
    BestOfFamily and AllModels ensembles: 12 leaderboard rows. Timed once,
    its launches by kernel held to the plan of the grown trees, its host
    syncs and peak memory; profiled on one fold of the GBM step def_1 (10
    of its trees). The leader's CV AUC is the one its kept out-of-fold predictions give
    (an ensemble's: its metalearner's on the level-one rows). On the first
    5k rows, the CPU's AutoML (GLM, GBM, ensembles; 2 models, 3 folds)
    against the card's: the same leaderboard members in plan order, GLM's
    CV AUC within 1e-4 (no sampling), the GBMs' and ensembles' within 0.02
    (the GBM steps sample from each device's own generator)."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.vec import Vec
    from h2o3_tpu_torch.models.data_info import response_as_float
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.models.model_base import compute_metrics
    from h2o3_tpu_torch.orchestration import SLICE_STATS, AutoML
    from h2o3_tpu_torch.orchestration.stacked_ensemble import _base_columns

    def run(frame, **kw):
        aml = AutoML(**kw)
        aml.train(y="y", training_frame=frame)
        return aml

    gbm1 = dict(AutoML()._steps()[4][2], nfolds=0, seed=1,
                ntrees=AML_PROFILE_TREES)
    fold_w = (torch.arange(AML_ROWS, device=fr1m.device) % 5 != 0).float()
    SLICE_STATS.reset()
    with count_shapes() as shapes:
        aml, res = timed_fit(
            f"13a AutoML max_models=10 seed=1 on {AML_ROWS} x {NFEAT}",
            lambda: run(fr1m, **AML), AML_ROWS, "rows",
            before_timed=lambda: (reset_kernel_counts(), shapes.clear()),
            sample=(f"one fold of the GBM step def_1, {AML_PROFILE_TREES} "
                    "trees", lambda: GBM(
                **gbm1).train(y="y", training_frame=fr1m, weights=fold_w)))
    events_ok("13a", aml)
    rows = aml.leaderboard._sorted()
    models = [r["_model"] for r in rows]
    base = [m for m in models if m.algo != "stackedensemble"]
    fits = sum(int(m.params.get("nfolds") or 0) + 1 for m in base)
    plan, totals = model_plan(base)
    res.update(hold_launches("13a", plan, totals))
    res["by_shape"] = {f"{b}x{n}": c for (b, n), c in sorted(shapes.items())}
    if sum(shapes.values()) != res["launches"]:
        raise AssertionError(f"13a: {sum(shapes.values())} histogram calls, "
                             f"{res['launches']} launches")
    steps = step_seconds(aml)
    table = aml.leaderboard.table()
    print(f"  {len(rows)} leaderboard rows from {len(base)} models, {fits} "
          f"fits; steps {[(a, s) for _, a, s in steps]}; launches by "
          f"(bins x nodes) {res['by_shape']}; leases "
          f"{SLICE_STATS.snapshot()['slices']}")
    for r in table[1]:
        print("   ", r[0], " ".join(f"{v:.6f}" for v in r[1:]))
    want_algos = sorted(["glm"] + ["xgboost"] * 3 + ["gbm"] * 6
                        + ["stackedensemble"] * 2)
    if len(rows) != 12 or fits != 60 or \
            sorted(m.algo for m in models) != want_algos:
        raise AssertionError(f"13a: {len(rows)} rows, {fits} fits, "
                             f"{sorted(m.algo for m in models)}")
    leader = aml.leader
    yy = response_as_float(fr1m.vec("y"))[0]
    if leader.algo == "stackedensemble":
        meta = leader.output["metalearner"]
        cols, hold = [], None
        for m in leader.output["base_models"]:
            cols += _base_columns(m, m.cv_holdout_predictions)
            hold = m.cv_holdout_mask if hold is None \
                else hold & m.cv_holdout_mask
        lvl1 = Frame(list(leader.output["levelone_names"]),
                     [Vec.from_device(c.contiguous()) for c in cols])
        kept = compute_metrics(meta._score_raw(lvl1), yy, hold, 2)
    else:
        kept = compute_metrics(leader.cv_holdout_predictions, yy,
                               leader.cv_holdout_mask, 2)
    cv_auc = leader.cross_validation_metrics.auc
    print(f"  leader {leader.key} ({leader.algo}): CV AUC {cv_auc:.6f}, "
          f"from its kept out-of-fold predictions {kept.auc:.6f}")
    if abs(kept.auc - cv_auc) > (1e-6 if leader.algo == "stackedensemble"
                                 else 0.0):
        raise AssertionError("13a: the leader's CV AUC is not its kept "
                             "predictions'")
    sub = head(fr1m, AML_CPU_ROWS)
    heads = {dev: run(f, **AML_CPU) for dev, f in
             (("cpu", frame_on(sub, "cpu")), ("cuda", sub))}
    for dev, a in heads.items():
        events_ok(f"13a CPU head ({dev})", a)
    plan_rows = [[(r["algo"], r["auc"]) for r in a.leaderboard._rows]
                 for a in heads.values()]
    if [a for a, _ in plan_rows[0]] != [a for a, _ in plan_rows[1]]:
        raise AssertionError(f"13a: CPU and card members {plan_rows}")
    worst = 0.0
    for (algo, a_cpu), (_, a_card) in zip(*plan_rows):
        tol = 1e-4 if algo == "glm" else 0.02
        worst = max(worst, abs(a_cpu - a_card) / tol)
    print(f"  CPU / card on {AML_CPU_ROWS} rows: members "
          f"{[a for a, _ in plan_rows[0]]}, CV AUC apart at {worst:.3g} x "
          "their tolerance (GLM 1e-4, the rest 0.02)")
    if worst > 1.0:
        raise AssertionError(f"13a: CPU and card CV AUCs {plan_rows}")
    cross = dict(rows=AML_CPU_ROWS, members=[a for a, _ in plan_rows[0]],
                 auc_ratio=worst)
    res.update(models=len(base), fits=fits, rows=len(rows),
               step_seconds=steps, leader=leader.algo, leader_cv_auc=cv_auc,
               leaderboard=[(r[0], r[1]) for r in table[1]],
               leases=SLICE_STATS.snapshot()["slices"], cross=cross)
    del aml, models, base, heads, fold_w
    return res


def grid_part(fr1m) -> dict:
    """13b: AutoML's GBM grid, RandomDiscrete (search seed 42, 6 of its
    108 points, builder seed 1, 50 trees, no CV) on 13a's rows, once at
    parallelism 1 and once at 2 (two builds in flight, each on a stream of
    its own): both timed, their launches held to the plan, the same model
    ids, the models of max_depth 7 or less (every level on the fixed
    kernel) equal bit for bit, the deeper ones (global kernel from 64
    nodes on, float reductions in another order each run) at training AUC
    within 1e-3."""
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.models.tree import HEAP_FIELDS
    from h2o3_tpu_torch.orchestration import GridSearch
    grids, out = {}, {}
    for par in (1, 2):
        reset_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = GridSearch(GBM, GRID_HYPER, grid_id="grid13b",
                       search_criteria=GRID_CRITERIA, parallelism=par,
                       **GRID_FIXED).train(y="y", training_frame=fr1m)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        plan, totals = model_plan(g.models)
        held = hold_launches(f"13b parallelism {par}", plan, totals)
        print(f"13b grid at parallelism {par}: {secs:.3f} s, "
              f"{len(g.models)} models, {len(g.failures)} failed")
        grids[par], out[f"par{par}_seconds"] = g, secs
        out[f"par{par}_launches"] = held["by_kernel"]
    a, b = grids[1], grids[2]
    if a.model_ids != b.model_ids or len(a.models) != 6:
        raise AssertionError(f"13b: ids {a.model_ids} vs {b.model_ids}")
    bitwise, auc_diff = [], 0.0
    for ma, mb in zip(a.models, b.models):
        same = all(torch.equal(getattr(ta, f), getattr(tb, f))
                   for ta, tb in zip(ma.output["trees"], mb.output["trees"])
                   for f in HEAP_FIELDS)
        bitwise.append(same)
        d = abs(ma.training_metrics.auc - mb.training_metrics.auc)
        auc_diff = max(auc_diff, d)
        if (ma.params["max_depth"] <= FIXED_DEPTH_65 and not same) or \
                d > 1e-3:
            raise AssertionError(f"13b: {ma.key} (depth "
                                 f"{ma.params['max_depth']}) differs")
    print(f"  ids equal; bit for bit {sum(bitwise)} of 6 (depths "
          f"{[m.params['max_depth'] for m in a.models]}: {bitwise}); "
          f"training AUC at most {auc_diff:.2e} apart; parallelism 2 / 1 = "
          f"{out['par2_seconds'] / out['par1_seconds']:.3f}")
    out.update(ids=a.model_ids, depths=[m.params["max_depth"]
                                        for m in a.models],
               bitwise=bitwise, auc_max_diff=auc_diff)
    return out


def te_automl_part(air1m) -> dict:
    """13c: AutoML with target encoding at tests/test_orchestration.py's
    settings (max_models 5, no CV, seed 7, GBM and ensembles, exploitation
    ratio 0.2) on the first 1M rows of phase 7's airlines frame: the
    EventLog holds "target-encoded" (the columns of more than 10 levels)
    and "lr-annealed"; every tree model scores the raw frame through its
    encoder, bit for bit its scores of the encoded frame; launches held to
    the plan."""
    from h2o3_tpu_torch.orchestration import AutoML
    reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aml = AutoML(**TE_AML)
    aml.train(y=AIRLINE_Y, training_frame=air1m)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    events_ok("13c", aml)
    models = aml.leaderboard.models
    held = hold_launches("13c", *model_plan(models))
    log = " ".join(aml.event_log.as_list())
    encoded = [e[3] for e in aml.event_log.events if e[2] == "preprocess"]
    probe = head(air1m, 10_000)
    through = True
    for m in models:
        te, = m.preprocessors
        a = m.predict(probe).vecs[2].data
        b = m.predict(te.transform(probe)).vecs[2].data
        through &= bool(torch.equal(a, b))
    print(f"13c AutoML with target encoding on {air1m.nrows} airlines rows: "
          f"{secs:.3f} s, {len(models)} models ({[m.algo for m in models]}); "
          f"{encoded}; lr-annealed in the log {'lr-annealed' in log}; "
          f"scores through the encoder {through}")
    if "target-encoded" not in log or "lr-annealed" not in log \
            or not through or len(models) != 5:
        raise AssertionError(f"13c: {aml.event_log.as_list()}")
    return dict(seconds=secs, models=len(models), encoded=encoded,
                step_seconds=step_seconds(aml), **held)


def segments_part(air1m) -> dict:
    """13d: ``train_segments(GBM(ntrees=20, max_depth=5, seed=1),
    ["UniqueCarrier"])`` on the first 1M rows of phase 7's frame: a model
    per carrier, every status SUCCEEDED, each model found through the DKV,
    launches held to the plan. On the first 20k rows, the CPU's segment
    models of 5 trees against the card's: alike at every split node but
    where the CPU's split search tied two candidates exactly."""
    from h2o3_tpu_torch.models import tree
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.utils.registry import DKV
    x = [c for c in AIRLINE_X if c != SEG_COL]
    reset_kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sm = GBM(**SEG_GBM).train_segments([SEG_COL], AIRLINE_Y, air1m, x=x)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    status = [r["status"] for r in sm.rows]
    models = [sm.get_model(**r["segment"]) for r in sm.rows]
    found = all(m is not None and DKV.get(m.key) is m for m in models)
    held = hold_launches("13d", *model_plan(models))
    print(f"13d segment models by {SEG_COL} on {air1m.nrows} rows: "
          f"{secs:.3f} s, {len(sm)} segments, statuses {set(status)}, every "
          f"model in the DKV {found}")
    if len(sm) != AIRLINE_CATS[SEG_COL] or set(status) != {"SUCCEEDED"} \
            or not found or DKV.get(sm.key) is not sm:
        raise AssertionError(f"13d: {[(r['segment'], r['status'], r['errors']) for r in sm.rows]}")
    sub = head(air1m, SEG_CPU_ROWS)
    ties, find = [], tree._find_splits

    def recording(hists, *a, **kw):
        ties.append(tree.tied_splits(hists, *a, **kw).cpu())
        return find(hists, *a, **kw)

    head_gbm = dict(SEG_GBM, ntrees=SEG_CPU_TREES)
    tree._find_splits = recording
    try:
        cpu = GBM(**head_gbm).train_segments([SEG_COL], AIRLINE_Y,
                                             frame_on(sub, "cpu"), x=x)
    finally:
        tree._find_splits = find
    card = GBM(**head_gbm).train_segments([SEG_COL], AIRLINE_Y, sub, x=x)
    levels = SEG_CPU_TREES * SEG_GBM["max_depth"]
    differ, tied = [], []
    for i, (rc, rg) in enumerate(zip(cpu.rows, card.rows)):
        if rc["segment"] != rg["segment"] or rc["status"] != rg["status"]:
            raise AssertionError(f"13d: CPU {rc} vs card {rg}")
        d, t = tie_aware_differences(
            cpu.get_model(**rc["segment"]), card.get_model(**rg["segment"]),
            ties[i * levels:(i + 1) * levels], SEG_GBM["max_depth"])
        differ += [(rc["segment"][SEG_COL], *n) for n in d]
        tied += [(rc["segment"][SEG_COL], *n) for n in t]
    print(f"  CPU / card on {SEG_CPU_ROWS} rows, {len(cpu)} segments: split "
          f"nodes that differ {differ}, differing at the CPU's exact ties "
          f"{len(tied)}")
    if differ or len(ties) != levels * len(cpu):
        raise AssertionError("13d: CPU and card segment models differ")
    return dict(seconds=secs, segments=len(sm), statuses=sorted(set(status)),
                cross=dict(rows=SEG_CPU_ROWS, segments=len(cpu),
                           tied_nodes=len(tied)), **held)


def orchestration_times() -> dict:
    """The kernels at 13a's level shapes (1M rows x 28 features): the
    GBMs' 65 int8 bins at levels 0-12 (1 to 2048 histogrammed nodes) and
    the XGBoosts' 257 int16 bins at levels 0-8, each beside its bound, its
    plain version and one ``index_add_``; each bin count held against its
    plain version at a level of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    out = {}
    for name, Bt, dtype, depth, checks in (("gbm_65", NBINS + 1, torch.int8,
                                            13, (6, 7)),
                                           ("xgboost_257", 257, torch.int16,
                                            9, (4, 5))):
        binned_T, _, g, h, w = hist_inputs(AML_ROWS, NFEAT, Bt, 1, dtype,
                                           gen)
        layouts = [(level, *level_nodes(AML_ROWS, level, gen))
                   for level in range(depth)]
        err = max(check_call((binned_T, layouts[lv][2], g, h, w),
                             layouts[lv][1], Bt,
                             f"13a {name} level {lv} R={AML_ROWS}")[1]
                  for lv in checks)
        out[name] = dict(err=err, times=time_levels(
            f"13a {name}", binned_T, g, h, w, Bt, layouts))
        del binned_T, g, h, w, layouts
    torch.cuda.empty_cache()
    return out


def phase_orchestration(fr, air_fr) -> dict:
    """Phase 13: 13a AutoML, 13b the grid at parallelism 1 and 2, 13c
    AutoML with target encoding, 13d segment models, then the kernels at
    13a's level shapes; each part's seconds (its CPU check included) in
    ``part_seconds``."""
    from h2o3_tpu_torch.utils.registry import DKV
    t0 = time.perf_counter()
    out, parts = {}, {}
    fr1m, air1m = head(fr, AML_ROWS), head(air_fr, AML_ROWS)
    prime_rollups(fr1m)
    prime_rollups(air1m)
    for name, part in (("13a_automl", lambda: automl_part(fr1m)),
                       ("13b_grid", lambda: grid_part(fr1m)),
                       ("13c_automl_te", lambda: te_automl_part(air1m)),
                       ("13d_segments", lambda: segments_part(air1m)),
                       ("13e_kernel_times", orchestration_times)):
        t1 = time.perf_counter()
        out[name] = part()
        parts[name] = time.perf_counter() - t1
        print(f"phase {name}: {parts[name]:.1f} s")
        DKV.clear()
        torch.cuda.empty_cache()
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card_name()
    print(f"phase 13: {out['seconds']:.1f} s; by part "
          f"{ {k: round(v, 1) for k, v in parts.items()} }")
    return out


def drop_models() -> None:
    """Empty the port's DKV, where ``train`` puts every finished model, so
    that no later phase's peak memory holds an earlier phase's models."""
    from h2o3_tpu_torch.utils.registry import DKV
    DKV.clear()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import h2o3_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_env()
    sass = sass_check()
    max_err = phase_kernel_checks()
    fixed = phase_fixed_checks()
    skewed = phase_skewed_checks()
    phase_cross_device()
    drop_models()
    phase_cross_device_new()
    drop_models()
    fr = build_frame()
    main_path = phase_main_path(fr)
    drop_models()
    times = phase_kernel_times()["levels"]
    tot_times = totals_times()
    new_paths = phase_new_paths(fr)
    drop_models()
    glm_multi = phase_glm_multinomial(fr)
    drop_models()
    tree_family = phase_tree_family(fr)
    drop_models()
    new_times = phase_new_path_times()
    air_fr, air_vf = airlines_frames()
    airlines = phase_airlines(air_fr, air_vf)
    drop_models()
    glm_airlines = phase_glm_airlines(air_fr, air_vf)
    drop_models()
    del air_vf
    torch.cuda.empty_cache()
    unsupervised = phase_dl_unsupervised(fr, air_fr)
    drop_models()
    builders = phase_builders(fr)
    drop_models()
    air_vf = airlines_frame(airlines_arrays(AIRLINE_VALID, 32), "cuda")
    cv_explain = phase_cv_explain(fr, air_fr, air_vf)
    drop_models()
    del air_vf
    orchestration = phase_orchestration(fr, air_fr)
    del fr, air_fr
    torch.cuda.empty_cache()
    glm = phase_glm(glm_airlines, glm_multi)
    gen = torch.Generator(device="cuda").manual_seed(37)
    binned_T, _, g, h, w = hist_inputs(AIRLINE_ROWS, len(AIRLINE_X),
                                       NBINS + 1, 1, torch.int8, gen)
    _, node = level_nodes(AIRLINE_ROWS, 3, gen)
    air_err = check_call((binned_T, node, g, h, w), 4, NBINS + 1,
                         f"airlines level 3 R={AIRLINE_ROWS} "
                         f"F={len(AIRLINE_X)}")[1]
    del node
    air_times = time_levels(
        "airlines", binned_T, g, h, w, NBINS + 1,
        [(level, *level_nodes(AIRLINE_ROWS, level, gen))
         for level in range(DEPTH)])
    del binned_T, g, h, w
    torch.cuda.empty_cache()
    kernels = [kernel_entry(main_path["launches"], max_err["binomial"],
                            times)]
    kernels += [kernel_entry(new_paths[path]["launches"], max_err[path],
                             new_times[path], path=path)
                for path in ("multinomial_k3", "xgboost_257", "drf_depth14")]
    # the global kernel: its launches in the DRF training, its times at the
    # DRF levels the plan gives it
    deep = [r for r in new_times["drf_depth14"] if r["kernel"] == "global"]
    kernels.append(kernel_entry(
        new_paths["drf_depth14"]["by_kernel"]["global"], max_err["global"],
        deep, name="global_hist_kernel", path="drf_depth14"))
    # the fixed kernel: its launches in the XGBoost training, its times at
    # the XGBoost levels the plan gives it, beside the first kernel's
    xgb = [r for r in new_times["xgboost_257"] if r["kernel"] == "fixed"]
    kernels.append(kernel_entry(
        new_paths["xgboost_257"]["by_kernel"]["fixed"], fixed["err"], xgb,
        name="fixed_hist_kernel", path="xgboost_257",
        bound_ratio=max(fixed["bound_ratio"], skewed["bound_ratio"]),
        skewed_err=skewed["err"],
        split_ms=new_times["fixed_split"],
        sass={k[-48:]: v for k, v in sass.items()}))
    # the categorical path's histograms (8 features), and the node totals:
    # the main path's launches, timed at its final level (K = 1 and 3)
    kernels.append(kernel_entry(
        sum(airlines["by_kernel"].values()), air_err, air_times,
        path="airlines_gbm"))
    kernels.append(kernel_entry(
        main_path["node_totals"], skewed["totals_err"], tot_times[:1],
        name="node_totals", path="binomial", replaces=TOTALS_REPLACES,
        multinomial_k3=tot_times[1]))
    # phase 9's paths: the decision tree's levels are DRF's levels 0-9 and
    # DART's the XGBoost levels (the same shapes, timed in phase 6); the
    # uplift levels (K = 8, w per tree) were timed in phase 9
    fam = tree_family
    kernels.append(kernel_entry(
        fam["decision_tree"]["launches"], max_err["drf_depth14"],
        new_times["drf_depth14"][:10], path="decision_tree"))
    kernels.append(kernel_entry(
        fam["uplift"]["launches"], fam["uplift"]["err"],
        fam["uplift"]["times"], path="uplift_drf_k8",
        node_totals_err=fam["uplift"]["totals_err"]))
    kernels.append(kernel_entry(
        fam["dart"]["launches"], max_err["xgboost_257"],
        new_times["xgboost_257"], path="dart_257"))
    # phases 11 and 12 launch the kernel at level shapes timed above, so
    # their entries carry those times and errors (named by ``timed_at``);
    # only the launch counts are their own. RuleFit's ladder takes the
    # main path's levels 0-2, the infogram's surrogates levels 0-4 (27 or
    # 28 features), the CV GBM's 6 fits the main path's levels, and the
    # GBM on the encodings the airlines levels (8 features)
    main_levels = "the main path's levels (phase 4), not this path's fits"
    for key, path, depth in (("11c_rulefit", "rulefit_ladder", 3),
                             ("11d_infogram", "infogram_surrogates", 5)):
        kernels.append(kernel_entry(
            builders[key]["launches"], max_err["binomial"], times[:depth],
            path=path, node_totals=builders[key]["node_totals"],
            timed_at=main_levels))
    kernels.append(kernel_entry(
        cv_explain["12a_cv_gbm"]["launches"], max_err["binomial"], times,
        path="gbm_cv5", node_totals=cv_explain["12a_cv_gbm"]["node_totals"],
        timed_at=main_levels))
    te_gbm = cv_explain["12b_target_encoder"]["gbm"]
    kernels.append(kernel_entry(
        te_gbm["launches"], air_err, air_times, path="te_airlines_gbm",
        node_totals=te_gbm["node_totals"],
        timed_at="the airlines GBM's levels (phase 7), not this path's fit"))
    # phase 13: 13a's launches at each bin count, timed at 13a's own level
    # shapes (1M rows), with each kernel's launches by level shape
    aml, aml_times = orchestration["13a_automl"], orchestration[
        "13e_kernel_times"]
    for name, bins in (("gbm_65", NBINS + 1), ("xgboost_257", 257)):
        shapes = {k: n for k, n in aml["by_shape"].items()
                  if k.startswith(f"{bins}x")}
        kernels.append(kernel_entry(
            sum(shapes.values()), aml_times[name]["err"],
            aml_times[name]["times"], path=f"automl_{name}",
            launches_by_shape=shapes))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"glm": glm}, default=float))
    print(json.dumps({"tree_family": {
        k: ({kk: vv for kk, vv in v.items() if kk != "times"}
            if isinstance(v, dict) else v) for k, v in fam.items()}},
        default=float))
    print(json.dumps({"dl_unsupervised": unsupervised}, default=float))
    print(json.dumps({"builders": builders}, default=float))
    print(json.dumps({"cv_explain": cv_explain}, default=float))
    print(json.dumps({"orchestration": {
        k: v for k, v in orchestration.items() if k != "13e_kernel_times"}},
        default=float))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
