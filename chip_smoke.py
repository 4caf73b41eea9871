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
   (256 bins), sampling off, and XGBoost at 4.5M rows (2 trees, depth 4),
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

The line before the last is the ``kernels`` JSON object (the main path's
object, one per further path with its ``path``, one for the global kernel
at the DRF levels it takes and one for the fixed kernel at the XGBoost
levels it takes); the last line is
``{"ok": true, "device": {...}}``; phase 8's numbers are the ``glm`` JSON
line before the ``kernels`` line. Without a CUDA card the script exits
non-zero and prints no result. It imports nothing of JAX or ``h2o3_tpu``.
"""

from __future__ import annotations

import contextlib
import json
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


def higgs_arrays(rows: int) -> dict:
    """The HIGGS-shaped frame's columns: bench.py's ``_higgs_frame``
    generator (seed 11, 28 normal columns, the same logit, labels s/b)."""
    rng = np.random.default_rng(11)
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


def phase_env() -> dict:
    """Phase 1: card, versions, kernel build."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
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
    return dict(card=smi.stdout.strip())


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
                 lambda: XGBoost(ntrees=2, max_depth=QBITS15_DEPTH,
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
             metrics, kernels: tuple) -> dict:
    """Train once to warm up (``warm``: fewer trees at the same shapes) and
    once timed, with the kernels' launches counted from 0 and held to
    ``expected`` (launches by kernel), each of ``kernels`` at least once;
    then score the frame and hold the scored metrics to the training ones.
    ``metrics`` names the metrics, each with its tolerance."""
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
    print(f"{what}: warm-up {warm_s:.2f} s, timed {seconds:.3f} s, "
          f"{ROWS * ntrees / seconds:.4g} rows*trees/s, kernel launches "
          f"{launches} {by_kernel}, node totals {totals}, peak device memory "
          f"{peak:.2f} GiB; {shown}; scoring {score_s:.3f} s")
    prof = profile_training(train, seconds)
    if by_kernel != expected or launches != sum(expected.values()) \
            or not all(by_kernel[k] for k in kernels) or totals != ntrees:
        raise AssertionError(f"{what}: kernels launched {by_kernel}, "
                             f"expected {expected}, each of {kernels}; "
                             f"node totals {totals}, expected {ntrees}")
    for m, tol in metrics.items():
        if not np.isfinite(trained[m]) or \
                abs(getattr(scored, m) - trained[m]) >= tol:
            raise AssertionError(f"{what}: scored {m} {getattr(scored, m)} "
                                 f"vs training {trained[m]}")
    probs = torch.stack([v.data for v in pred.vecs[1:]], 1)
    if probs.shape[0] != ROWS or not bool(torch.isfinite(probs).all()) \
            or not torch.allclose(probs.sum(1), torch.ones_like(probs[:, 0]),
                                  atol=1e-4):
        raise AssertionError(f"{what}: scores are not probabilities")
    return dict(seconds=seconds, launches=launches, by_kernel=by_kernel,
                node_totals=totals, score_s=score_s,
                rows_trees_per_s=ROWS * ntrees / seconds,
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


def phase_cross_device_new() -> dict:
    """Phase 3's new models, CPU (plain path) against the card: fault C.1's
    GBMs (cases (a), (b), (c) at 2M rows, depth 6, 64 bins, 3 trees) and a
    100k-row airlines-shaped GBM with group splits (Origin and Dest range-
    grouped into 64 bins), a monotone DepTime and interaction sets
    {Origin, Dest} and {DepTime, Distance}."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.gbm import GBM
    out = {}
    for case in "abc":
        cols = skewed_cols(case, 2_000_000)
        out[case] = cross_device_ties(
            f"C.1 case ({case}) GBM 2M x 28", lambda dev: Frame.from_arrays(
                cols, device=dev),
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
    phase_cross_device_new()
    fr = build_frame()
    main_path = phase_main_path(fr)
    times = phase_kernel_times()["levels"]
    tot_times = totals_times()
    new_paths = phase_new_paths(fr)
    glm_multi = phase_glm_multinomial(fr)
    del fr
    new_times = phase_new_path_times()
    air_fr, air_vf = airlines_frames()
    airlines = phase_airlines(air_fr, air_vf)
    glm_airlines = phase_glm_airlines(air_fr, air_vf)
    del air_fr, air_vf
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
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"glm": glm}, default=float))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
