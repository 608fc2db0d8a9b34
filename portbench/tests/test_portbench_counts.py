"""(c) The frozen pair and FLOP counts against hand counts on a scene of
a few splats."""

import torch

from portbench import bounds
from vidu4d_tpu_torch.ops.rasterize import common, tile_backward


def one_splat_batch(n_extra=0):
    """One large, faint splat facing the camera at the centre of one
    16 x 16 tile: every pixel's only candidate, composited everywhere."""
    xyz = torch.tensor([[0.0, 0.0, 1.0]])
    rot = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    scale = torch.tensor([[0.5, 0.5]])
    intrins = torch.tensor([16.0, 16.0, 8.0, 8.0])
    proj = common.project_splats(xyz[None], rot[None], scale, torch.eye(4), intrins[None])
    colors = torch.full((1, 1, 3 + n_extra), 0.5)
    opac = torch.tensor([0.5])
    return tile_backward.prepare_batch(proj, colors, opac, torch.zeros(3), 16, 16)


def test_pairs_and_bounds_by_hand():
    b = one_splat_batch()
    assert int(b["tile_count"].sum()) == 1
    pairs = bounds.needed_pairs(b, bounds.plain_aux(b))
    # one entry, 256 pixels: each visits it, composites it, differentiates it
    assert pairs == {"fwd_visited": 256, "included": 256, "bwd_responses": 256,
                     "bwd_walked": 256, "count_eff_entries": 1}
    kb = bounds.kernel_bounds(b, pairs)
    assert kb["tile_forward"]["ops"] == 34 * 256 + 29 * 256
    assert kb["tile_backward"]["ops"] == 34 * 256 + 105 * 256
    assert kb["tile_forward"]["bytes"] == 1 * 128 + 8 + 3 * 4 + 256 * 15 * 4
    assert kb["tile_backward"]["bytes"] == 2 * 128 + 8 + 256 * 14 * 4


def test_matmul_flops_leave_out_the_excluded():
    a, b = torch.randn(4, 5), torch.randn(5, 3)
    counter = bounds.MatmulFlops()
    inner = counter.exclude(lambda x, y: x @ y)
    with counter:
        a @ b
        inner(a, b)
        torch.bmm(a[None], b[None])
    assert counter.flops == 2 * (2 * 4 * 5 * 3)
