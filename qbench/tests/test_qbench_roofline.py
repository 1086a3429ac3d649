"""The propagate byte count on hand-worked cases."""
import pytest
import torch

from qbench import roofline

DEG = torch.tensor([2, 1, 0, 3])
FRONTIER = torch.tensor([[True, False, False, False], [True, False, False, True]])


def test_a_label_copy_reads_no_weight():
    x = torch.zeros((2, 4), dtype=torch.int32)
    # arcs of sources 0 and 3: 5 x (4 + 4); x at 3 (lane, source) pairs x 4;
    # the frontier 2 x 4 x 1; the output 2 x 4 x 4
    assert int(roofline.propagate_bytes(DEG, "min_right", x, FRONTIER)) == 40 + 12 + 8 + 32


def test_a_weighted_semiring_reads_each_lit_arcs_weight():
    x = torch.zeros((2, 4), dtype=torch.float32)
    assert int(roofline.propagate_bytes(DEG, "min_plus", x, FRONTIER)) == 60 + 12 + 8 + 32


def test_no_frontier_lights_every_source_in_every_lane():
    x = torch.zeros((2, 4), dtype=torch.int32)
    assert int(roofline.propagate_bytes(DEG, "min_right", x, None)) == 48 + 32 + 0 + 32


def test_a_broadcast_frontier_counts_per_lane():
    x = torch.zeros((2, 4), dtype=torch.int32)
    one = torch.tensor([False, True, False, False])
    assert int(roofline.propagate_bytes(DEG, "max_right", x, one)) == 8 + 8 + 8 + 32


def test_the_h100_peak_is_tabled():
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == pytest.approx(3.35e12)
    assert roofline.peaks("no such card") is None
