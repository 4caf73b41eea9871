"""Card-only cases of the fixed histogram kernel's distributed modes
(``-m cuda``; they skip where there is no card). This file imports no JAX:
the kernel is held against its plain PyTorch version.

- The scale-only mode's exponent counts equal :func:`fixed_counts_plain`'s
  exactly, and the accumulator mode's int64 sums equal
  :func:`fixed_acc_plain`'s exactly, at chip_smoke.py phase 2's small
  shapes (int8 and int16 bins, one node and several, rows not a multiple
  of four, K = 3 with w shared), and for the node totals (F = Bt = 1).
- The counts and accumulators of two row halves, summed, equal one launch
  over all the rows bit for bit, and scaled back they equal the one-launch
  fixed kernel's float32 histograms bit for bit at that launch's qbits:
  what lets W ranks reproduce one rank's trees.
"""

import pytest
import torch

from h2o3_tpu_torch.ops import hist as H


@pytest.fixture
def cuda_device():
    """The card; skips without one (the kernels have no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


SHAPES = [  # (R, F, bins incl. NA, N, dtype, K)
    (4096, 7, 17, 8, torch.int16, 1),
    (4099, 5, 65, 1, torch.int8, 1),
    (4099, 5, 65, 4, torch.int8, 1),
    (2048, 3, 257, 8, torch.int16, 1),
    (4096, 7, 17, 8, torch.int16, 3),
]


def _inputs(R, F, Bt, N, dtype, K, gen, dev):
    binned_T = torch.randint(0, Bt, (F, R), generator=gen, device=dev).to(dtype)
    node = torch.randint(-1, N, (K, R), generator=gen, device=dev,
                         dtype=torch.int32)
    g = torch.randn((K, R), generator=gen, device=dev)
    g[0, :3] *= 1e5          # outliers above the bulk
    h = torch.rand((K, R), generator=gen, device=dev) + 0.1
    w = torch.ones(R, device=dev)
    return binned_T, node, g, h, w


@pytest.mark.cuda
@pytest.mark.parametrize("R,F,Bt,N,dtype,K", SHAPES)
def test_distributed_modes_equal_their_plain_versions(cuda_device, R, F, Bt,
                                                      N, dtype, K):
    gen = torch.Generator(device=cuda_device).manual_seed(R + F + Bt + K)
    binned_T, node, g, h, w = _inputs(R, F, Bt, N, dtype, K, gen,
                                      cuda_device)
    q = H._card_plan(cuda_device.index or 0, R, F, N, Bt,
                     binned_T.element_size(), K)["qbits"]
    p = H.mesh_plan(binned_T, node, N, Bt, q)
    counts = H.fixed_counts(node, g, h, w, N, p)
    assert torch.equal(counts.cpu(), H.fixed_counts_plain(
        node.cpu(), g.cpu(), h.cpu(), w.cpu(), N))
    exps, bad = H.exponents_from_counts(counts, q)
    acc = H.fixed_acc(binned_T, node, g, h, w, N, Bt, exps, bad, p)
    assert torch.equal(acc.cpu(), H.fixed_acc_plain(
        binned_T.cpu(), node.cpu(), g.cpu(), h.cpu(), w.cpu(), N, Bt,
        exps.tolist(), bad.tolist()))
    # the totals' modes (F = Bt = 1, no bins)
    pt = H.mesh_plan(None, node, N, 1, H._TOTALS_QBITS, H._TOTALS_QBITS)
    et, bt = H.exponents_from_counts(H.fixed_counts(node, g, h, w, N, pt),
                                     H._TOTALS_QBITS)
    tot = H.fixed_acc(None, node, g, h, w, N, 1, et, bt, pt)
    assert torch.equal(tot.cpu(), H.fixed_acc_plain(
        torch.zeros((1, R), dtype=torch.int8), node.cpu(), g.cpu(), h.cpu(),
        w.cpu(), N, 1, et.tolist(), bt.tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("R,F,Bt,N,dtype,K", SHAPES)
def test_two_halves_summed_equal_one_launch(cuda_device, R, F, Bt, N, dtype,
                                            K):
    gen = torch.Generator(device=cuda_device).manual_seed(R * K + N)
    binned_T, node, g, h, w = _inputs(R, F, Bt, N, dtype, K, gen,
                                      cuda_device)
    q = H._card_plan(cuda_device.index or 0, R, F, N, Bt,
                     binned_T.element_size(), K)["qbits"]
    cut = R // 2 + 1
    parts = [(binned_T[:, a:b].contiguous(), node[:, a:b].contiguous(),
              g[:, a:b].contiguous(), h[:, a:b].contiguous(),
              w[a:b].contiguous()) for a, b in ((0, cut), (cut, R))]
    counts = sum(H.fixed_counts(pn, pg, ph, pw, N,
                                H.mesh_plan(pb, pn, N, Bt, q))
                 for pb, pn, pg, ph, pw in parts)
    whole = H.fixed_counts(node, g, h, w, N,
                           H.mesh_plan(binned_T, node, N, Bt, q))
    assert torch.equal(counts, whole)
    exps, bad = H.exponents_from_counts(counts, q)
    acc = sum(H.fixed_acc(pb, pn, pg, ph, pw, N, Bt, exps, bad,
                          H.mesh_plan(pb, pn, N, Bt, q))
              for pb, pn, pg, ph, pw in parts)
    one = H.fixed_acc(binned_T, node, g, h, w, N, Bt, exps, bad,
                      H.mesh_plan(binned_T, node, N, Bt, q))
    assert torch.equal(acc, one)
    # scaled back: the one-launch kernel's own float32 sums, bit for bit
    launches = dict(H.level_histograms.kernel_launches)
    ref = H._launch(binned_T, node, g, h, w, N, Bt, "fixed")
    H.level_histograms.kernel_launches = launches
    assert H.launch_plan(binned_T, N, Bt, "fixed", K)["qbits"] == q
    got = H.fixed_from_acc(acc, exps, bad)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
