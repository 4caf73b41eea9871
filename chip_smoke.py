#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``h2o3_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. the card's name and power limit, the torch and CUDA versions, and the
   build of every CUDA kernel from ``h2o3_tpu_torch/csrc`` (timed);
2. the histogram kernel held against its plain PyTorch version on the card
   at small shapes (one with every row in node 0, one with inputs that
   start off their vector alignment), at 2^14 nodes, at 257 int16 bins,
   and at the main path's 11M x 28 shapes (one with 11,000,003 rows);
3. a 100k-row GBM trained on the CPU (plain path) and on the card (kernel),
   which must agree on every split, on training AUC and on margins;
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
   staging, with the launch plan of each level.

The line before the last is the ``kernels`` JSON object; the last line is
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


def phase_kernel_checks() -> float:
    """Phase 2: kernel against the plain version; returns the max abs err."""
    from h2o3_tpu_torch.ops.hist import level_histograms, level_histograms_plain
    gen = torch.Generator(device="cuda").manual_seed(7)
    Bt = NBINS + 1
    shapes = [  # (R, F, bins incl. NA, N, dtype, what)
        (4096, 7, 17, 8, torch.int16, ""),
        (2048, 3, 257, 128, torch.int16, ""),
        (4099, 5, Bt, 1, torch.int8, "node0"),    # every row in one node
        (4099, 5, Bt, 4, torch.int8, "skew"),     # views off alignment
        (4099, 5, Bt, 4, torch.int16, "skew"),
        (1 << 20, 4, Bt, 1 << 14, torch.int8, ""),
        (ROWS, NFEAT, Bt, 1, torch.int8, ""),
        (ROWS + 3, NFEAT, Bt, 1, torch.int8, ""),  # rows not a multiple of 4
        (ROWS, NFEAT, Bt, 2, torch.int8, ""),
        (ROWS, NFEAT, Bt, 16, torch.int8, ""),
    ]
    worst = 0.0
    for R, F, Bt, N, dt, what in shapes:
        node = (torch.zeros(R, dtype=torch.int32, device="cuda")
                if what == "node0" else None)
        args = hist_inputs(R, F, Bt, N, dt, gen, node=node,
                           skew=1 if what == "skew" else 0)
        got = level_histograms(*args, N, Bt)
        want = level_histograms_plain(*args, N, Bt)
        torch.cuda.synchronize()
        err = (got - want).abs()
        scale = float(want.abs().max())
        max_abs = float(err.max())
        rel = float((err / want.abs().clamp_min(1e-30)).max())
        # atomics add in another order than the plain version's index_add_:
        # the only difference is float32 rounding of long sums
        ok = bool((err <= 1e-5 * scale + 1e-5 * want.abs()).all())
        shape = f"R={R} F={F} Bt={Bt} N={N} {str(dt)[6:]} {what}".strip()
        print(f"hist {shape}: max abs err {max_abs:.3e} max rel err "
              f"{rel:.3e} max|hist| {scale:.4g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees at {shape}")
        worst = max(worst, max_abs)
        del args, got, want, err
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


def _margins(model, frame):
    return model.output["f0"] + model.output["learn_rate"] * \
        model._tree_raw_sum(frame)


def phase_cross_device() -> None:
    """Phase 3: one small GBM on the CPU (plain path) and on the card."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.models.tree import HEAP_FIELDS
    cols = higgs_arrays(100_000)
    params = dict(ntrees=5, max_depth=6, nbins=64, learn_rate=0.1, seed=42)
    models, margins = {}, {}
    for dev in ("cpu", "cuda"):
        fr = Frame.from_arrays(cols, device=dev)
        t0 = time.perf_counter()
        models[dev] = GBM(**params).train(y="y", training_frame=fr)
        margins[dev] = _margins(models[dev], fr).cpu()
        print(f"cross-device GBM 100k x 28 on {dev}: "
              f"{time.perf_counter() - t0:.2f} s, "
              f"AUC {models[dev].training_metrics.auc:.6f}")
    pairs = list(zip(models["cpu"].output["trees"],
                     models["cuda"].output["trees"]))
    same = lambda keys: sum(all(torch.equal(getattr(a, k).cpu(),
                                            getattr(b, k).cpu())
                                for k in keys) for a, b in pairs)
    d_auc = abs(models["cpu"].training_metrics.auc
                - models["cuda"].training_metrics.auc)
    d_margin = float((margins["cpu"] - margins["cuda"]).abs().max())
    print(f"cross-device: {same(HEAP_FIELDS)}/5 trees with identical heap "
          f"arrays, {same(('feat', 'thresh_bin', 'na_left', 'is_split'))}/5 "
          f"with identical splits, |dAUC| {d_auc:.2e}, max |dmargin| "
          f"{d_margin:.2e}")
    if (same(("feat", "thresh_bin", "na_left", "is_split")) != len(pairs)
            or d_auc >= 1e-4
            or not torch.allclose(margins["cpu"], margins["cuda"], atol=1e-4)):
        raise AssertionError("card and CPU GBMs disagree")


def phase_main_path() -> dict:
    """Phase 4: bench_gbm's configuration on the full 11M x 28 frame."""
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.gbm import GBM
    from h2o3_tpu_torch.ops.hist import level_histograms
    t0 = time.perf_counter()
    cols = higgs_arrays(ROWS)
    fr = Frame.from_arrays(cols)
    del cols
    torch.cuda.synchronize()
    print(f"frame {ROWS} x {NFEAT} on the card: "
          f"{time.perf_counter() - t0:.2f} s")

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
    main_path = phase_main_path()
    times = phase_kernel_times()["levels"]
    mean = lambda k: sum(r[k] for r in times) / len(times)
    kernel = dict(
        name="level_histograms", route="cuda",
        source="h2o3_tpu_torch/csrc/hist.cu",
        replaces="h2o3_tpu/ops/pallas_hist.py:179",
        launches=main_path["launches"], max_abs_err=max_err,
        # per launch, averaged over the six level shapes of one tree
        ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in times)
        else "operations", library_ms=mean("library_ms"),
        bound_share=mean("bound_ms") / mean("ms"),
        levels=[{k: r[k] for k in ("level", "N", "active_rows", "ms",
                                   "loads_only_ms", "staging_only_ms",
                                   "plain_ms", "library_ms", "bound_ms",
                                   "bound_share")}
                for r in times])
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
