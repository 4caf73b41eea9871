#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``h2o3_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. the card's name and power limit, the torch and CUDA versions, and the
   build of every CUDA kernel from ``h2o3_tpu_torch/csrc`` (timed);
2. the histogram kernel held against its plain PyTorch version on the card
   at small shapes (one with every row in node 0, one with inputs that
   start off their vector alignment), at 2^14 nodes, at 257 int16 bins,
   at the main path's 11M x 28 shapes (one with 11,000,003 rows), at the
   XGBoost level-0 shape (257 int16 bins) and a deep DRF level (1024
   nodes); then class batches (K = 3, w shared and per class, at small
   shapes and at the 11M x 28 multinomial level-0 shape), and a K = 1
   batch against the 2-D call;
3. small models trained on the CPU (plain path) and on the card (kernel),
   which must agree on every split, on the training metric and on the
   margins: a 100k-row binomial GBM, multinomial GBM (K = 3) and XGBoost
   (256 bins), sampling off;
4. the main path at full width: binomial GBM on the 11M x 28 HIGGS-shaped
   frame (64 bins, depth 6, 20 trees, learn rate 0.1) trained once to warm
   up and once timed, then scored — the kernel must launch exactly 120
   times in the timed training — and once more under torch.profiler for
   the device's busy share and its costliest kernels;
5. the kernel timed at each level's shape of the main path, beside the
   first kernel's time (from PERF.md), its plain version, one
   ``index_add_`` call computing the same function, its memory bound, and
   two measurement instances of the same kernel: with its slab updates
   compiled out (staging, listing and decoding) and with only its tile
   staging, with the launch plan of each level;
6. the three further paths on phase 4's frame, each warmed up, timed
   (launches counted), profiled and scored (the scored metric must equal
   the training one): XGBoost as bench.py's bench_xgboost (10 trees, depth
   6, 256 bins, eta 0.3; exactly 60 launches), multinomial GBM on a
   3-class label drawn from the same X (K = 3, 64 bins, depth 6, 20
   rounds; exactly 120 launches, one per level for all three classes) and
   DRF at its defaults (depth 14, 64 bins, sample_rate 0.632, mtries 5),
   cut from 50 trees to 5 (exactly 70 launches); then the kernel timed at
   each path's level shapes as in phase 5 (multinomial and XGBoost levels
   0-5, DRF's levels 11 and 13 at 1024 and 4096 nodes).

The line before the last is the ``kernels`` JSON object (the main path's
object, then one per further path with its ``path``); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits
non-zero and prints no result. It imports nothing of JAX or ``h2o3_tpu``.
"""

from __future__ import annotations

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
# the DRF path at DRF's defaults, cut from 50 trees to 5 to hold the
# script's time
DRF_TREES, DRF_DEPTH, DRF_MTRIES = 5, 14, 5

#: the first kernel's ms per launch at levels 0-5 of the main path (one
#: feature per block, shared atomics; PERF.md section 6, NVIDIA H100 80GB
#: HBM3 at 700.00 W), for comparison
FIRST_KERNEL_MS = (3.570, 3.223, 3.221, 3.208, 3.207, 3.201)


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


def phase_kernel_checks() -> dict:
    """Phase 2: kernel against the plain version, 2-D calls and class
    batches; returns the max abs err of each path's shapes."""
    from h2o3_tpu_torch.ops.hist import level_histograms, level_histograms_plain
    gen = torch.Generator(device="cuda").manual_seed(7)
    Bt = NBINS + 1
    shapes = [  # (R, F, bins incl. NA, N, dtype, what, path)
        (4096, 7, 17, 8, torch.int16, "", "binomial"),
        (2048, 3, 257, 128, torch.int16, "", "xgboost_257"),
        (4099, 5, Bt, 1, torch.int8, "node0", "binomial"),  # one node
        (4099, 5, Bt, 4, torch.int8, "skew", "binomial"),   # off alignment
        (4099, 5, Bt, 4, torch.int16, "skew", "binomial"),
        (1 << 20, 4, Bt, 1 << 14, torch.int8, "", "drf_depth14"),
        (ROWS, NFEAT, Bt, 1, torch.int8, "", "binomial"),
        (ROWS + 3, NFEAT, Bt, 1, torch.int8, "", "binomial"),  # rows % 4
        (ROWS, NFEAT, Bt, 2, torch.int8, "", "binomial"),
        (ROWS, NFEAT, Bt, 16, torch.int8, "", "binomial"),
        # the XGBoost level-0 shape (atomic kernel) and a deep DRF level
        (ROWS, NFEAT, XGB_BINS + 1, 1, torch.int16, "", "xgboost_257"),
        (ROWS, NFEAT, Bt, 1024, torch.int8, "", "drf_depth14"),
    ]
    worst: dict[str, float] = {}
    for R, F, Bt_, N, dt, what, path in shapes:
        node = (torch.zeros(R, dtype=torch.int32, device="cuda")
                if what == "node0" else None)
        args = hist_inputs(R, F, Bt_, N, dt, gen, node=node,
                           skew=1 if what == "skew" else 0)
        shape = f"R={R} F={F} Bt={Bt_} N={N} {str(dt)[6:]} {what}".strip()
        err = check_hist(level_histograms(*args, N, Bt_),
                         level_histograms_plain(*args, N, Bt_), shape)
        worst[path] = max(worst.get(path, 0.0), err)
        del args
    # class batches (K = 3): w shared and per class, the lane kernel with
    # rows a multiple of four and not, the atomic kernel, and the
    # multinomial level-0 shape at full width
    batches = [  # (R, F, bins incl. NA, N, dtype, K, w per class)
        (4096, 7, 17, 8, torch.int16, 3, False),
        (4096, 7, 17, 8, torch.int16, 3, True),
        (4099, 5, Bt, 4, torch.int8, 3, True),
        (2048, 3, 257, 128, torch.int16, 3, True),
        (ROWS, NFEAT, Bt, 1, torch.int8, 3, False),
    ]
    for R, F, Bt_, N, dt, K, wk in batches:
        args = batch_inputs(R, F, Bt_, N, dt, gen, K, wk)
        shape = (f"R={R} F={F} Bt={Bt_} N={N} {str(dt)[6:]} K={K} "
                 f"w {'per class' if wk else 'shared'}")
        err = check_hist(level_histograms(*args, N, Bt_),
                         level_histograms_plain(*args, N, Bt_), shape)
        worst["multinomial_k3"] = max(worst.get("multinomial_k3", 0.0), err)
        del args
    # a K = 1 batch against the 2-D call: both launch the same kernel and
    # flush with float atomicAdd, so they are held to the same tolerance
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
    from h2o3_tpu_torch.ops.hist import (hist_bytes, hist_flops, launch_plan,
                                         level_histograms,
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
        calls = level_histograms.launches
        ms = cuda_ms(lambda: level_histograms(binned_T, node, g, h, w, N, Bt),
                     reps=20)
        loads_ms = cuda_ms(lambda: level_histograms_loads_only(
            binned_T, node, g, h, w, N, Bt), reps=20)
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
        level_histograms.launches = calls   # timing launches are not counted
        nbytes = hist_bytes(ROWS, NFEAT, N, Bt, 1)
        flops = hist_flops(active, NFEAT)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / F32_FLOPS_PER_S else "operations")
        row = dict(level=level, N=N, active_rows=active, ms=ms,
                   loads_only_ms=loads_ms, staging_only_ms=staging_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / ms, gbps=nbytes / ms / 1e6,
                   bytes=nbytes, flops=flops)
        print(f"hist level {level} N={N} active={active}: kernel {ms:.4f} ms "
              f"(first kernel {FIRST_KERNEL_MS[level]:.3f} ms), "
              f"{100 * bound_ms / ms:.1f}% of bound {bound_ms:.4f} ms "
              f"({bound_by}, {nbytes / 1e6:.1f} MB), "
              f"{nbytes / ms / 1e6:.1f} GB/s; updates out {loads_ms:.4f} ms, "
              f"staging only {staging_ms:.4f} ms; "
              f"plain {plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms; plan "
              f"{plan['kernel']} Fb={plan['features_per_group']} "
              f"groups={plan['groups']} Nb={plan['nodes_per_block']} "
              f"node_blocks={plan['node_blocks']} copies={plan['copies']} "
              f"owners={plan['owners']} smem={plan['smem_bytes']} B "
              f"blocks={plan['blocks']}")
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


def cross_device(what: str, cols: dict, make, metric: str) -> None:
    """One small model trained on the CPU (plain path) and on the card
    (kernel): every split must agree, the training ``metric`` within 1e-4
    and the margins within atol 1e-4 (float32 sums in another order)."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.tree import HEAP_FIELDS
    models, margins = {}, {}
    for dev in ("cpu", "cuda"):
        fr = Frame.from_arrays(cols, device=dev)
        t0 = time.perf_counter()
        models[dev] = make().train(x=[f"x{i}" for i in range(NFEAT)], y="y",
                                   training_frame=fr)
        margins[dev] = _margins(models[dev], fr).cpu()
        print(f"cross-device {what} on {dev}: "
              f"{time.perf_counter() - t0:.2f} s, {metric} "
              f"{getattr(models[dev].training_metrics, metric):.6f}")
    pairs = [(a, b) for sa, sb in zip(_tree_sets(models["cpu"]),
                                      _tree_sets(models["cuda"]))
             for a, b in zip(sa, sb)]
    same = lambda keys: sum(all(torch.equal(getattr(a, k).cpu(),
                                            getattr(b, k).cpu())
                                for k in keys) for a, b in pairs)
    d_metric = abs(getattr(models["cpu"].training_metrics, metric)
                   - getattr(models["cuda"].training_metrics, metric))
    d_margin = float((margins["cpu"] - margins["cuda"]).abs().max())
    n_split = same(("feat", "thresh_bin", "na_left", "is_split"))
    print(f"cross-device {what}: {same(HEAP_FIELDS)}/{len(pairs)} trees with "
          f"identical heap arrays, {n_split}/{len(pairs)} with identical "
          f"splits, |d{metric}| {d_metric:.2e}, max |dmargin| "
          f"{d_margin:.2e}")
    if n_split != len(pairs) or d_metric >= 1e-4 \
            or not torch.allclose(margins["cpu"], margins["cuda"], atol=1e-4):
        raise AssertionError(f"card and CPU {what} disagree")


def phase_cross_device() -> None:
    """Phase 3: small binomial GBM, multinomial GBM (K = 3) and XGBoost
    (256 bins) on the CPU and on the card, sampling off."""
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


def run_path(what: str, train, warm, fr, ntrees: int, expected: int,
             metrics) -> dict:
    """Train once to warm up (``warm``: fewer trees at the same shapes) and
    once timed, with the kernel's launches counted from 0; then score the
    frame and hold the scored metrics to the training ones. ``metrics``
    names the metrics, each with its tolerance."""
    from h2o3_tpu_torch.ops.hist import level_histograms
    t0 = time.perf_counter()
    warm()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    level_histograms.launches = 0
    t0 = time.perf_counter()
    model = train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = level_histograms.launches
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
          f"{launches}, peak device memory {peak:.2f} GiB; {shown}; "
          f"scoring {score_s:.3f} s")
    prof = profile_training(train, seconds)
    if launches != expected:
        raise AssertionError(f"{what}: kernel launched {launches} times, "
                             f"expected {expected}")
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
    return dict(seconds=seconds, launches=launches, score_s=score_s,
                rows_trees_per_s=ROWS * ntrees / seconds, peak_gib=peak,
                **trained, **prof)


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
        XGB_TREES * DEPTH, {"auc": 1e-4})

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
        NTREES * DEPTH, {"logloss": 1e-4, "mean_per_class_error": 1e-4})
    del frm, codes

    def drf(n):
        return lambda: DRF(ntrees=n, max_depth=DRF_DEPTH, nbins=NBINS,
                           mtries=DRF_MTRIES, seed=42).train(
                               x=x, y="y", training_frame=fr)

    out["drf_depth14"] = run_path(
        f"DRF {ROWS} x {NFEAT}, {DRF_TREES} trees depth {DRF_DEPTH} {NBINS} "
        f"bins, sample_rate 0.632, mtries {DRF_MTRIES}", drf(DRF_TREES),
        drf(1), fr, DRF_TREES, DRF_TREES * DRF_DEPTH, {"auc": 1e-9})
    torch.cuda.empty_cache()
    return out


def phase_main_path(fr) -> dict:
    """Phase 4: bench_gbm's configuration on the full 11M x 28 frame."""
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.ops.hist import level_histograms

    def train():
        return GBM(ntrees=NTREES, max_depth=DEPTH, nbins=NBINS,
                   learn_rate=0.1, seed=42).train(y="y", training_frame=fr)

    t0 = time.perf_counter()
    train()                                   # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    level_histograms.launches = 0
    t0 = time.perf_counter()
    model = train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = level_histograms.launches
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
          f"{auc:.6f}, kernel launches {launches}, peak device memory "
          f"{peak:.2f} GiB")
    print(f"scoring {ROWS} rows: {score_s:.3f} s, scored AUC {scored_auc:.6f}")
    expected = NTREES * DEPTH   # one histogram per level of every tree
    if launches != expected:
        raise AssertionError(f"kernel launched {launches} times, "
                             f"expected {expected}")
    if not (np.isfinite(auc) and auc > 0.5):
        raise AssertionError(f"training AUC {auc}")
    if ps.shape != (ROWS,) or not bool(torch.isfinite(ps).all()) \
            or not bool(((ps >= 0) & (ps <= 1)).all()):
        raise AssertionError("scores are not finite probabilities")
    if abs(scored_auc - auc) >= 1e-4:
        raise AssertionError(f"scored AUC {scored_auc} vs training {auc}")
    return dict(seconds=seconds, launches=launches, auc=auc,
                rows_trees_per_s=ROWS * NTREES / seconds, score_s=score_s,
                peak_gib=peak, **prof)


def cuda_ms_auto(fn, budget_ms: float = 300.0, max_reps: int = 20) -> float:
    """:func:`cuda_ms` with as many repetitions as fit ``budget_ms`` (at
    least 2, at most ``max_reps``), from one timed warm-up call."""
    est = cuda_ms(fn, reps=1, warmup=1)
    return cuda_ms(fn, reps=int(min(max_reps, max(2, budget_ms // est))),
                   warmup=0)


def time_levels(what: str, binned_T, g, h, w, Bt: int, layouts) -> list:
    """The kernel, its plain version and one ``index_add_`` computing the
    same function, timed at each ``(level, N, node)`` layout of a path,
    beside the bound (each input once: the bins once for all classes)."""
    from h2o3_tpu_torch.ops.hist import (hist_bytes, hist_flops, launch_plan,
                                         level_histograms,
                                         level_histograms_plain)
    F, R = binned_T.shape
    K = g.shape[0] if g.dim() == 2 else 1
    rows = []
    for level, N, node in layouts:
        active = int((node >= 0).sum())
        calls = level_histograms.launches
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
        level_histograms.launches = calls   # timing launches are not counted
        nbytes = hist_bytes(R, F, N, Bt, binned_T.element_size(), K,
                            w.dim() == 2)
        flops = hist_flops(active, F)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / F32_FLOPS_PER_S else "operations")
        plan = launch_plan(binned_T, N, Bt, K=K)
        print(f"hist {what} level {level} N={N} K={K} active={active}: kernel "
              f"{ms:.4f} ms, {100 * bound_ms / ms:.1f}% of bound "
              f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB); plain "
              f"{plain_ms:.3f} ms, index_add_ {library_ms:.3f} ms; plan "
              f"{plan['kernel']} groups={plan['groups']} "
              f"Nb={plan['nodes_per_block']} "
              f"node_blocks={plan['node_blocks']} copies={plan['copies']} "
              f"owners={plan['owners']} smem={plan['smem_bytes']} B "
              f"blocks={plan['blocks']}")
        rows.append(dict(level=level, N=N, active_rows=active, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         bound_share=bound_ms / ms))
    return rows


def phase_new_path_times() -> dict:
    """Phase 6's kernel times at each new path's level shapes: the
    multinomial levels (K = 3, shared w) and the XGBoost levels (257 int16
    bins) of one tree, and DRF's deepest levels (1024 and 4096 nodes)."""
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
        [(level, *level_nodes(ROWS, level, gen)) for level in (11, 13)])
    del binned_T
    binned_T = torch.randint(0, XGB_BINS + 1, (NFEAT, ROWS), generator=gen,
                             device="cuda").to(torch.int16)
    out["xgboost_257"] = time_levels(
        "XGBoost", binned_T, g, h, w, XGB_BINS + 1,
        [(level, *level_nodes(ROWS, level, gen)) for level in range(DEPTH)])
    del binned_T, g, h, w
    torch.cuda.empty_cache()
    return out


def kernel_entry(launches: int, max_err: float, times: list, **extra) -> dict:
    """One object of the ``kernels`` line: per launch, averaged over the
    path's timed level shapes."""
    mean = lambda k: sum(r[k] for r in times) / len(times)
    return dict(
        name="level_histograms", route="cuda",
        source="h2o3_tpu_torch/csrc/hist.cu",
        replaces="h2o3_tpu/ops/pallas_hist.py:179",
        launches=launches, max_abs_err=max_err,
        ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in times)
        else "operations", library_ms=mean("library_ms"),
        bound_share=mean("bound_ms") / mean("ms"), **extra,
        levels=[{k: r[k] for k in r if k not in ("bound_by", "bytes",
                                                  "flops", "gbps")}
                for r in times])


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
    max_err = phase_kernel_checks()
    phase_cross_device()
    fr = build_frame()
    main_path = phase_main_path(fr)
    times = phase_kernel_times()["levels"]
    new_paths = phase_new_paths(fr)
    del fr
    new_times = phase_new_path_times()
    kernels = [kernel_entry(main_path["launches"], max_err["binomial"],
                            times)]
    kernels += [kernel_entry(new_paths[path]["launches"], max_err[path],
                             new_times[path], path=path)
                for path in ("multinomial_k3", "xgboost_257", "drf_depth14")]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
