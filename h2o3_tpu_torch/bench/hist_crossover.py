"""The two kernels of ``level_histograms`` around the plan's switch from the
lane kernel to the atomic kernel (``ops/hist.py:_LANE_MAX_NODE_BLOCKS``).

    python3 -m h2o3_tpu_torch.bench.hist_crossover

On one CUDA card, at 11M rows x 28 features with int8 bins (Bt = 65) and
with int16 bins (Bt = 129 and 257), and at node counts N for which the lane
kernel takes from one node block to many, it launches the lane kernel and the
atomic kernel, each on its own plan, checks that they agree within rtol
1e-5 + 1e-5 x max|hist|, and times each with CUDA events (mean of 5
launches after one). Rows are laid out as at a level of tree growth: 2N
children at random, the N even ones active (their siblings come by
subtraction). Prints the card's name and power limit, one line per shape,
and the rows as one JSON list last; exits non-zero if the kernels disagree.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from h2o3_tpu_torch.ops import hist

ROWS, NFEAT = 11_000_000, 28
#: (bin dtype, bins incl. NA, node counts)
CASES = ((torch.int8, 65, (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)),
         (torch.int16, 129, (1, 2, 4, 8, 16, 32)),
         (torch.int16, 257, (1, 2, 4, 8, 16, 32, 64)))


def _ms(fn, reps: int = 5) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("hist_crossover: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows, ok = [], True
    for dtype, Bt, counts in CASES:
        binned_T = torch.randint(0, Bt, (NFEAT, ROWS), generator=gen,
                                 device=dev).to(dtype)
        g = torch.randn(ROWS, generator=gen, device=dev)
        h = torch.rand(ROWS, generator=gen, device=dev) + 0.1
        w = torch.ones(ROWS, device=dev)
        for N in counts:
            child = torch.randint(0, 2 * N, (ROWS,), generator=gen,
                                  device=dev, dtype=torch.int32)
            node = torch.where(child % 2 == 0, child // 2, -1)
            row = dict(bins=str(dtype)[6:], Bt=Bt, N=N,
                       planned=hist.launch_plan(binned_T, N, Bt)["kernel"])
            outs = {}
            for kernel in ("lanes", "atomic"):
                p = hist.launch_plan(binned_T, N, Bt, kernel)

                def launch(kernel=kernel):
                    return hist._launch(binned_T, node, g, h, w, N, Bt,
                                        kernel)

                outs[kernel] = launch()
                row[f"{kernel}_ms"] = _ms(launch)
                row[f"{kernel}_node_blocks"] = p["node_blocks"]
                row[f"{kernel}_blocks"] = p["blocks"]
                row[f"{kernel}_warps"] = p["warps"]
            want = outs["atomic"].abs()
            agree = bool(((outs["lanes"] - outs["atomic"]).abs()
                          <= 1e-5 * want.max() + 1e-5 * want).all())
            ok &= agree
            print(f"{row['bins']} Bt={Bt} N={N}: lanes {row['lanes_ms']:.4f} "
                  f"ms ({row['lanes_node_blocks']} node blocks, "
                  f"{row['lanes_warps']} warps, "
                  f"{row['lanes_blocks']} blocks), atomic "
                  f"{row['atomic_ms']:.4f} ms ({row['atomic_node_blocks']} "
                  f"node blocks, {row['atomic_blocks']} blocks); planned "
                  f"{row['planned']}; {'agree' if agree else 'DISAGREE'}")
            rows.append(row)
            del node, child, outs
        del binned_T, g, h, w
        torch.cuda.empty_cache()
    print(json.dumps(rows))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
