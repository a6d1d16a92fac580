"""The yardstick's counts against hand-worked small cases, and the
reference's greedy NMS against the served package's plain one."""

from __future__ import annotations

import torch

from portbench import counts
from portbench.reference import detect as RD


def test_nms_ops_counts_kept_rows_against_later_valid_rows():
    # One image, 5 candidates of which 4 valid; kept at positions 0 and 2:
    # row 0 meets rows 1..3 (3 pairs), row 2 meets row 3 (1 pair).
    keep = torch.tensor([[True, False, True, False, False]])
    valid = torch.tensor([[True, True, True, True, False]])
    assert counts.nms_ops(keep, valid) == 14 * 4
    assert counts.nms_bytes(1, 5) == 5 * 18


def test_match_ops_counts_tiles_the_truth_meets():
    # Priors in two tiles of 2: tile 0 spans x in [0, 0.2], tile 1 [0.8, 1].
    priors = torch.tensor([[0.05, 0.5, 0.1, 0.1], [0.15, 0.5, 0.1, 0.1],
                           [0.85, 0.5, 0.1, 0.1], [0.95, 0.5, 0.1, 0.1]])
    truths = torch.tensor([[[0.0, 0.4, 0.12, 0.6], [0.5, 0.4, 0.6, 0.6], [0.0, 0.0, 1.0, 1.0]]])
    valid = torch.tensor([[True, True, False]])
    # GT 0 meets tile 0 only (2 priors); GT 1 meets none; GT 2 is padding.
    assert counts.match_ops(truths, valid, priors, tile=2) == 13 * 2 + 8 * 2 * 2
    # A last tile of one prior counts one prior.
    assert counts.match_ops(truths[:, :1], valid[:, :1], priors[:3], tile=2) == 13 * 2 + 8 * 1 * 2
    assert counts.match_bytes(1, 3, 4) == 3 * 17 + 4 * 16 + 4 * 12 + 3 * 8


def test_model_flops_of_one_conv():
    def conv():
        return torch.nn.Conv2d(8, 4, 3, padding=1, bias=False)

    # 2 * B * Cout * H * W * Cin * k * k; backward adds the weight's
    # gradient only (the input needs none).
    fwd = 2 * 1 * 4 * 16 * 16 * 8 * 9
    assert counts.model_flops(conv, (1, 8, 16, 16), backward=False) == fwd
    assert counts.model_flops(lambda: _Tuple(conv()), (1, 8, 16, 16), backward=True) == 2 * fwd

    def depthwise():
        return torch.nn.Conv2d(8, 8, 3, padding=1, groups=8, bias=False)

    assert counts.model_flops(depthwise, (1, 8, 16, 16), backward=False) == 2 * 8 * 16 * 16 * 9


class _Tuple(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return (self.inner(x),)


def test_bound_is_the_larger_of_operations_and_bytes():
    assert counts.bound_s(int(67e12), 0) == 1.0
    assert counts.bound_s(0, int(3.35e12)) == 1.0


def test_reference_greedy_nms_equals_the_served_plain_nms():
    from jabd_tpu_torch.ops import nms as N

    g = torch.Generator().manual_seed(0)
    for k, block in ((300, 256), (700, 64), (50, 256)):
        xy = torch.rand((3, k, 2), generator=g)
        wh = 0.02 + 0.2 * torch.rand((3, k, 2), generator=g)
        boxes = torch.cat([xy, xy + wh], -1)
        valid = torch.arange(k)[None] < torch.tensor([[k], [k // 2], [0]])
        want = N.nms_keep_sorted(boxes, valid, 0.3)
        assert torch.equal(RD.greedy_keep(boxes, valid, 0.3, block=block), want)
