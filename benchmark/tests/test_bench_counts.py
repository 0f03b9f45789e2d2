"""The pair, operation and byte counters against hand counts."""

import pytest
import torch

from benchmark import counts, pairs
from benchmark.reference import nets, smpl


def test_pairs_of_a_box_are_the_pixel_centres_inside_it():
    boxes = torch.tensor([[0.5, 2.5, 0.0, 1.0],      # x 1, 2; y 0, 1
                          [-3.0, 0.0, 2.2, 2.9],     # x 0; no y centre
                          [2.0, 9.0, 3.0, 3.0],      # x 2, 3; y 3
                          [float("nan"), 1.0, 0.0, 1.0]])
    assert pairs.count_pairs(boxes, 4) == 4 + 0 + 2 + 0
    k, x, y = pairs.enumerate_pairs(boxes, 4)
    got = sorted(zip(k.tolist(), x.tolist(), y.tolist()))
    assert got == [(0, 1, 0), (0, 1, 1), (0, 2, 0), (0, 2, 1),
                   (2, 2, 3), (2, 3, 3)]


def test_support_pairs_of_a_tiny_mesh():
    # Two triangles; the front one (largest signed area) is kept.
    verts = torch.tensor([[[2.0, 2.0], [6.0, 2.0], [2.0, 5.0],
                           [2.0, 2.0]]])
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]])
    sigma = 1.0 / ((8 / 2.0) ** 2)        # σ_px = 1 at 8²
    r = (20.1 ** 0.5)                      # 4.48 px
    # x in [2 - r, 6 + r] → 0..7 (8), y in [2 - r, 5 + r] → 0..7 (8).
    assert counts.support_pairs(verts, faces, 8, sigma) == 64
    assert r == pytest.approx(4.4833, abs=1e-4)


def test_conv_and_dense_operations_from_shapes():
    w = {"params/c/kernel": torch.empty(3, 3, 2, 4),
         "params/c/bias": torch.empty(4),
         "params/d/kernel": torch.empty(6, 5),
         "params/d/bias": torch.empty(5)}

    def net(w, x, v):
        nets.conv(w, "c", x)
        nets.dense(w, "d", v)

    assert nets.count_flops(net, w, (1, 2, 5, 5), (7, 6)) == \
        2 * 4 * 25 * 3 * 3 * 2 + 2 * 7 * 6 * 5


def test_smpl_operations_and_rooflines():
    v3 = 6890 * 3
    per = 2 * (v3 * 10 + 207 * v3 + 24 * v3 + 6890 * 288 + 6890 * 12
               + 45 * v3)
    assert counts.smpl_forward_flops(3) == 3 * per
    assert smpl.NUM_FACES == 13776
    assert counts.roofline_ms(67e9, 0.0) == pytest.approx(1.0)
    assert counts.roofline_ms(1.0, 3.35e9) == pytest.approx(1.0)
    b = counts.silhouette_bytes(2, 8, backward=True)
    faces = 2 * int(13776 * 0.6)
    assert b == faces * 20 * 4 + 2 * 64 * 4 + faces * 24
