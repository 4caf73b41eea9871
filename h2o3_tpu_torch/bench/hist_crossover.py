"""The kernels of ``level_histograms`` over node counts, bins and classes:
the measurement behind the plan's switch (``ops/hist.py``:
``_KERNEL_SWITCH``, the kernel each bin and node count takes, and
``_GLOBAL_L2_BYTES`` for the global kernel's passes).

    python3 -m h2o3_tpu_torch.bench.hist_crossover

On one CUDA card, at 11M rows x 28 features: int8 bins (Bt = 65) at N = 1 to
2^14 nodes, int16 bins (Bt = 129 and 257) at N = 1 to 1024 and (Bt = 1025,
H2O's nbins_top_level) at N = 1 to 64, and a batch of K = 3 classes with one
shared weight row at N = 16 to 256 and 1024 (Bt = 65). At each shape it
launches every kernel of ``level_histograms.kernel_launches``, each on its
own plan,
checks each result against float64 sums (the plain version on float64
stats) within rtol 1e-5 + 1e-5 x max|hist|, and times each with CUDA
events: the mean of up to 5 launches after one (fewer
where one launch takes over 100 ms), at four placements of the kernels'
outputs in device memory, of which the median counts, with no other output
held (where the output is small and every row adds into it, as at two nodes
of 257 bins, the global kernel's time moves by up to 10% with where its
output lands). Rows are laid out as at a level of tree growth: 2N children
at random, the N even ones active (their siblings come by subtraction);
N = 0 stands for level 0, one node that holds every row.
Then it times the global kernel at its deep shapes with the features in
more or fewer passes (``_GLOBAL_L2_BYTES`` from 4 MiB to all features in
one pass). Prints the card's name and power limit, one line per shape
(with the kernels that disagree, which are never the fastest), and the rows
as one JSON object last; exits non-zero if the planned kernel disagrees.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from h2o3_tpu_torch.ops import hist

ROWS, NFEAT = 11_000_000, 28
KERNELS = tuple(hist.level_histograms.kernel_launches)
#: (bin dtype, bins incl. NA, classes, node counts)
CASES = ((torch.int8, 65, 1, (0,) + tuple(2 ** i for i in range(15))),
         (torch.int16, 129, 1, (0,) + tuple(2 ** i for i in range(11))),
         (torch.int16, 257, 1, (0,) + tuple(2 ** i for i in range(11))),
         (torch.int16, 1025, 1, (0,) + tuple(2 ** i for i in range(7))),
         (torch.int8, 65, 3, (16, 32, 64, 128, 256, 1024)))
#: the global kernel's passes: (bin dtype, bins, nodes) x L2 budgets (MiB)
PASS_CASES = ((torch.int8, 65, 1024), (torch.int8, 65, 4096),
              (torch.int8, 65, 16384), (torch.int16, 257, 1024))
L2_BUDGETS_MIB = (4, 8, 16, 32, 1 << 20)
#: 128-byte lines held before a timing, so that the outputs the kernels
#: allocate land elsewhere
PAD_LINES = (0, 33, 1000, 65537)


def _ms(fn, budget_ms: float = 100.0, max_reps: int = 5) -> float:
    """Mean ms of ``fn()`` with CUDA events: one timed call first, then as
    many as fit ``budget_ms`` (at least one, at most ``max_reps``)."""
    def timed(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    first = timed(1)
    reps = int(min(max_reps, budget_ms // first))
    return timed(reps) if reps >= 1 else first


def _median_ms(fn) -> float:
    """:func:`_ms` at each placement of ``PAD_LINES``: the median."""
    times = []
    for lines in PAD_LINES:
        pad = torch.empty(lines * 128, dtype=torch.uint8, device="cuda")
        times.append(_ms(fn))
        del pad
        torch.cuda.empty_cache()
    return statistics.median(times)


def _level(R: int, N: int, K: int, gen: torch.Generator) -> torch.Tensor:
    """Node ids [K, R] (or [R]) of a level of N nodes, or of level 0 for
    N = 0."""
    if N == 0:
        node = torch.zeros((K, R), dtype=torch.int32, device="cuda")
    else:
        child = torch.randint(0, 2 * N, (K, R), generator=gen, device="cuda",
                              dtype=torch.int32)
        node = torch.where(child % 2 == 0, child // 2, -1)
    return node if K > 1 else node[0]


def _agree(got: torch.Tensor, want: torch.Tensor) -> bool:
    a = want.abs()
    return bool(((got - want).abs() <= 1e-5 * a.max() + 1e-5 * a).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("hist_crossover: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, passes, ok = [], [], True
    for dtype, Bt, K, counts in CASES:
        binned_T = torch.randint(0, Bt, (NFEAT, ROWS), generator=gen,
                                 device="cuda").to(dtype)
        shape = (K, ROWS) if K > 1 else (ROWS,)
        g = torch.randn(shape, generator=gen, device="cuda")
        h = torch.rand(shape, generator=gen, device="cuda") + 0.1
        w = torch.ones(ROWS, device="cuda")
        for level0 in counts:
            node = _level(ROWS, level0, K, gen)
            N = max(level0, 1)
            planned = hist.launch_plan(binned_T, N, Bt, K=K)["kernel"]
            row = dict(bins=str(dtype)[6:], Bt=Bt, K=K, N=N,
                       all_rows=level0 == 0, planned=planned)
            kernels = list(KERNELS)
            launch = {k: (lambda k=k: hist._launch(binned_T, node, g, h, w, N,
                                                   Bt, k)) for k in kernels}
            # checked first, and freed before any timing: held outputs move
            # where the timed kernels' outputs land
            want = hist.level_histograms_plain(binned_T, node, g.double(),
                                               h.double(), w.double(), N, Bt)
            agree = {k: _agree(launch[k](), want) for k in kernels}
            ok &= agree[planned]
            row["agree"] = agree
            del want
            for kernel in kernels:
                p = hist.launch_plan(binned_T, N, Bt, kernel, K)
                row[f"{kernel}_ms"] = _median_ms(launch[kernel])
                row[f"{kernel}_plan"] = {k: p[k] for k in (
                    "groups", "node_blocks", "warps", "blocks")}
            row["fastest"] = min((k for k in kernels if agree[k]),
                                 key=lambda k: row[f"{k}_ms"])
            print(f"{row['bins']} Bt={Bt} K={K} N={N}"
                  f"{' (all rows)' if level0 == 0 else ''}: " + ", ".join(
                f"{k} {row[f'{k}_ms']:.4f} ms {row[f'{k}_plan']}"
                for k in kernels) + f"; fastest {row['fastest']}, planned "
                f"{row['planned']}; disagree: "
                f"{[k for k in kernels if not agree[k]] or 'none'}")
            rows.append(row)
            del node, launch
        del binned_T, g, h, w
        torch.cuda.empty_cache()
    budget = hist._GLOBAL_L2_BYTES
    for dtype, Bt, N in PASS_CASES:
        binned_T = torch.randint(0, Bt, (NFEAT, ROWS), generator=gen,
                                 device="cuda").to(dtype)
        g = torch.randn(ROWS, generator=gen, device="cuda")
        h = torch.rand(ROWS, generator=gen, device="cuda") + 0.1
        w = torch.ones(ROWS, device="cuda")
        node = _level(ROWS, N, 1, gen)
        for mib in L2_BUDGETS_MIB:
            hist._GLOBAL_L2_BYTES = mib * 2 ** 20
            hist._kernel_plan.cache_clear()
            hist._plan.cache_clear()
            p = hist.launch_plan(binned_T, N, Bt, "global")
            ms = _median_ms(lambda: hist._launch(binned_T, node, g, h, w, N,
                                                 Bt, "global"))
            passes.append(dict(bins=str(dtype)[6:], Bt=Bt, N=N, l2_mib=mib,
                               passes=p["groups"],
                               features_per_pass=p["features_per_group"],
                               ms=ms))
            print(f"global {str(dtype)[6:]} Bt={Bt} N={N}: {p['groups']} "
                  f"passes of {p['features_per_group']} features "
                  f"(budget {mib} MiB): {ms:.4f} ms")
        del binned_T, g, h, w, node
        torch.cuda.empty_cache()
    hist._GLOBAL_L2_BYTES = budget
    hist._kernel_plan.cache_clear()
    hist._plan.cache_clear()
    print(json.dumps(dict(card=smi.stdout.strip(), rows=rows,
                          passes=passes)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
