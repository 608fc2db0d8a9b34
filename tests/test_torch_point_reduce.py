"""The split-point reduction (`ops/point_reduce.py`, csrc/point_reduce.cu)
and the warp stack's entry points that take it in their backward.

On the CPU: the plain version against ``torch.einsum`` in float64 at the
two kinds of contraction over points (the bone blends' 25 x 4, the bone
rotations' 75 x 3); the wrapper's refusals (an output wider than one
block's thread tiles among them); the kernel's plan mirrored (every term of
the sum taken once, shared memory inside its bound) on a small card for
float32 and float64 and at the cells' shapes; ``gradcheck`` and
``gradgradcheck`` of each autograd Function in float64;
`dual_quaternion_skinning` and `get_bone_coords` on a small bob warp
against their einsum formulation (the forward bit for bit, the gradients
within 1e-6 of the largest); a toy Stage-3 step counting plain calls only.

On a card (marker ``cuda``; the file imports nothing of JAX, so
``python3 -m pytest --noconftest -o addopts= -m cuda
tests/test_torch_point_reduce.py``): the kernel against the float64 plain
version at the cells' shapes (Stage 3: batch 2 x 400,000 points and the
cycle's and the reprojection's fewer; Stage 2: 512 x 1,024), in float32 and
in float64, the same bits on two calls, odd shapes, and a toy Stage-3 step
launching as many kernels as the CPU's step makes plain calls, with no
plain call.
"""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
from vidu4d_tpu_torch import kernels
from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields import mlp, skinning
from vidu4d_tpu_torch.models.fields.warping import SkinningWarp
from vidu4d_tpu_torch.ops import point_reduce as pr
from vidu4d_tpu_torch.ops import quaternion

# the two kinds of contraction: (p, q) = bone blend, bone rotation
KINDS = {"blend": (25, 4), "rotate": (75, 3)}
# (batch, n, p, q) of the cells' contractions: Stage 3's 2 frames x 400,000
# slots (the surfels' and the flow's warps), 100,000 (the cycle's) and 8,192
# (the reprojection's); Stage 2's 512 items x 1,024 samples
CELL_SHAPES = {
    "s3 blend": (2, 400_000, 25, 4), "s3 rotate": (2, 400_000, 75, 3),
    "s3 cycle blend": (2, 100_000, 25, 4), "s3 reprojection rotate": (2, 8192, 75, 3),
    "s2 blend": (512, 1024, 25, 4), "s2 rotate": (512, 1024, 75, 3),
}
T = 6
FI = FrameInfo(frame_offset=(0, T), frame_mapping=tuple(range(T)), frame_offset_raw=(0, T))


def _rand(*shape, seed=0, dtype=torch.float64):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape)).to(dtype)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_matches_einsum_float64(kind):
    p, q = KINDS[kind]
    a, b = _rand(3, 500, p, seed=1), _rand(3, 500, q, seed=2)
    before = dict(kernels.COUNTS)
    got = pr.point_reduce(a, b)
    assert kernels.COUNTS["point_reduce_plain"] == before["point_reduce_plain"] + 1
    assert kernels.COUNTS["point_reduce"] == before["point_reduce"]
    want = torch.einsum("knp,knq->kpq", a, b)
    assert got.shape == (3, p, q) and got.dtype == torch.float64
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_wrapper_rejects_mismatched_shapes_and_devices():
    with pytest.raises(ValueError):
        pr.point_reduce(torch.zeros(2, 5, 3), torch.zeros(2, 4, 3))
    with pytest.raises(ValueError):
        pr.point_reduce(torch.zeros(5, 3), torch.zeros(5, 3))
    with pytest.raises(ValueError):
        pr.point_reduce(torch.zeros(1, 5, 3, device="meta"), torch.zeros(1, 5, 3, device="meta"))
    # 16 x 51 thread tiles: wider than one block covers
    with pytest.raises(ValueError, match="thread tiles"):
        pr.point_reduce(torch.zeros(1, 5, 64), torch.zeros(1, 5, 203))
    with pytest.raises(ValueError, match="thread tiles"):
        pr.plan(1, 5, 64, 203, 4, 4, lambda smem: 2)


def _covered(batch, n, p, q, elem_bytes, plan):
    """How often the kernel's threads take each term (row, i, j) of one
    batch entry, mirroring pr_partial's indexing; also checks each shared
    read and the group tiles against the shared bytes."""
    tile = pr.TILE
    cover = np.zeros((n, p, q), np.int64)
    rpc = -(-n // plan.chunks)
    tp_n, tq_n = -(-p // tile), -(-q // tile)
    pitch = (tp_n + tq_n) * tile
    t_out = tp_n * tq_n
    groups = pr.THREADS // t_out
    assert groups >= 1
    if groups > 1:
        assert t_out * tile * tile * elem_bytes <= plan.smem
    assert 2 * plan.slab * pitch * elem_bytes <= plan.smem <= pr.MAX_SMEM
    for t in range(groups * t_out):
        g, o = divmod(t, t_out)
        tpi, tqi = divmod(o, tq_n)
        rows_i = [i for i in range(tile * tpi, tile * tpi + tile) if i < p]
        cols_j = [j for j in range(tile * tqi, tile * tqi + tile) if j < q]
        for c in range(plan.chunks):
            lo, hi = c * rpc, min(n, (c + 1) * rpc)
            for s in range(lo, hi, plan.slab):
                rows = min(plan.slab, hi - s)
                pts = [s + r for r in range(g, rows, groups)]
                if pts and rows_i and cols_j:
                    cover[np.ix_(pts, rows_i, cols_j)] += 1
    return cover


@pytest.mark.parametrize("elem_bytes", [4, 8])
@pytest.mark.parametrize("shape", [(2, 700, 25, 4), (2, 700, 75, 3), (3, 300, 3, 75),
                                   (1, 900, 60, 64), (2, 50, 1, 1)])
def test_plan_takes_every_term_once(shape, elem_bytes):
    """The kernel's plan on a 4-SM card, two resident blocks each, for
    float32 and float64 elements; (60, 64) is the widest output one block
    covers (15 x 16 = 240 thread tiles, one row group)."""
    batch, n, p, q = shape
    plan = pr.plan(batch, n, p, q, elem_bytes, 4, lambda smem: 2)
    assert plan.chunks >= 1 and plan.slab >= 1
    assert np.all(_covered(batch, n, p, q, elem_bytes, plan) == 1)


@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
def test_plan_at_the_cells_shapes(cell):
    """At the cells' shapes on an H100 (132 SMs): about a wave of blocks,
    shared memory within the kernel's bound, chunks of at least `MIN_ROWS`
    rows; Stage 3 in hundreds of chunks, Stage 2's 512 items in a few."""
    batch, n, p, q = CELL_SHAPES[cell]
    plan = pr.plan(batch, n, p, q, 4, 132, lambda smem: 4)
    assert plan.smem <= pr.MAX_SMEM
    assert -(-n // plan.chunks) >= pr.MIN_ROWS
    if cell.startswith("s3"):
        assert min(100, batch * -(-n // pr.MIN_ROWS)) <= plan.chunks * batch <= 600
    else:
        assert 1 <= plan.chunks <= 4


def _check_grads(fn, inputs):
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-7)
    assert torch.autograd.gradgradcheck(fn, inputs, eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("fn", ["point_reduce", "blend", "rotate"])
def test_functions_gradcheck_float64(fn):
    """Each autograd Function's backward, and the backward of its backward
    (`DynNeRF.compute_normal` takes the gradient through the warp with
    ``create_graph``), in float64."""
    req = lambda x: x.requires_grad_(True)
    if fn == "point_reduce":
        _check_grads(pr.PointReduce.apply,
                     (req(_rand(2, 7, 3, seed=3)), req(_rand(2, 7, 4, seed=4))))
    elif fn == "blend":
        _check_grads(quaternion._BoneBlend.apply,
                     (req(_rand(2, 6, 5, seed=5)), req(_rand(2, 5, 4, seed=6)),
                      req(_rand(2, 5, 4, seed=7))))
    else:
        _check_grads(skinning._BoneRotate.apply,
                     (req(_rand(2, 4, 3, 3, seed=8)), req(_rand(2, 6, 3, seed=9))))


@contextlib.contextmanager
def _einsum_formulation():
    """The entry points as the einsums they replace."""
    quaternion._BoneBlend.apply = lambda w, qr, qd: (
        torch.einsum("mnb,mbd->mnd", w, qr), torch.einsum("mnb,mbd->mnd", w, qd))
    skinning._BoneRotate.apply = lambda rmat, xyz: torch.einsum("mbij,mnj->mnbi", rmat, xyz)
    try:
        yield
    finally:
        # the inherited `Function.apply` comes back
        del quaternion._BoneBlend.apply, skinning._BoneRotate.apply


def _bob_warp():
    torch.manual_seed(0)
    warp = SkinningWarp(FI)
    g = torch.Generator().manual_seed(1)
    mlp.flax_default_init_(warp, g)
    with torch.no_grad():
        # a delta-skin MLP that is not zero, so its every layer has a gradient
        for p in warp.skinning_model.delta_field.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return warp


def _run(entry, formulation):
    """Outputs and gradients of one entry point of a small bob warp: the
    whole warp (the blends, the bone rotations and the delta-skin MLP
    between them), or the bone coordinates alone."""
    warp = _bob_warp()
    xyz = _rand(2, 40, 3, 3, seed=13, dtype=torch.float32).mul_(0.3).requires_grad_(True)
    frame_id = torch.tensor([1, 4])
    ctx = _einsum_formulation() if formulation == "einsum" else contextlib.nullcontext()
    with ctx:
        if entry == "skinning":
            (q, t), aux = warp(xyz, frame_id, None, return_qt=True)
            out = torch.cat([q, t], -1)
            loss = (out * _rand(*out.shape, seed=14, dtype=torch.float32)).sum() \
                + aux["skin_entropy"].sum() + aux["delta_skin"].sum()
        else:
            t_art, _ = warp.articulation.vals_and_mean(frame_id)
            bones = (t_art[0][:, None, None], t_art[1][:, None, None])
            out = skinning.get_bone_coords(xyz, bones)
            loss = (out * _rand(*out.shape, seed=15, dtype=torch.float32)).sum()
        leaves = {"xyz": xyz, **dict(warp.named_parameters())}
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return out.detach(), {k: g for k, g in zip(leaves, grads) if g is not None}


@pytest.mark.parametrize("entry", ["skinning", "bone_coords"])
def test_entry_points_match_einsum_formulation(entry):
    """Forward bit for bit; every gradient within 1e-6 of its largest
    element (the sums over points run in another order only)."""
    before = dict(kernels.COUNTS)
    out, grads = _run(entry, "point_reduce")
    calls = kernels.COUNTS["point_reduce_plain"] - before["point_reduce_plain"]
    assert calls == {"skinning": 3, "bone_coords": 1}[entry]
    ref_out, ref_grads = _run(entry, "einsum")
    assert torch.equal(out, ref_out)
    assert grads.keys() == ref_grads.keys() and len(grads) > 1
    if entry == "skinning":  # the bones' parameters and the delta-skin MLP's
        assert {"articulation.so3_head.out.weight", "articulation.trans_head.out.weight",
                "skinning_model.delta_field.mlp.linear_1.weight"} <= grads.keys()
    for k, g in grads.items():
        scale = float(ref_grads[k].abs().max())
        assert scale > 0, k
        assert float((g - ref_grads[k]).abs().max()) <= 1e-6 * scale, k


def _toy_stage3(tmp_path, device):
    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer

    db = chip_smoke.load_test_module("helpers").make_fake_db(
        str(tmp_path), num_vids=1, T=8, H=16, W=16)
    tr = Stage3Trainer({"dataroot": db, "seqname": "toy", "logname": "pr",
                        "logroot": str(tmp_path / "logdir"), "data_prefix": "crop",
                        "train_res": 16, "fg_motion": "gs-bob", "pixels_per_image": -1,
                        "imgs_per_gpu": 1, "gs_capacity": 128, "gs_init_samples": 96,
                        "sh_degree": 1, "feat_reproj_px": 64}, device)
    return tr


def _step_counts(tmp_path, device):
    tr = _toy_stage3(tmp_path, device)
    batch = tr._next_batch()
    kernels.reset_counts()
    tr.train_step(batch)
    if device != "cpu":
        torch.cuda.synchronize()
    return dict(kernels.COUNTS)


def test_toy_stage3_step_counts_plain_calls(tmp_path):
    """On the CPU a Stage-3 step takes the plain version: three contractions
    a skinning warp (two blends, the bone rotations)."""
    counts = _step_counts(tmp_path, "cpu")
    assert counts["point_reduce"] == 0
    assert counts["point_reduce_plain"] > 0 and counts["point_reduce_plain"] % 3 == 0


# ---- on the card

needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
def test_cuda_kernel_matches_float64_at_the_cells_shapes(cell, dtype):
    """Against the float64 plain version: within 1e-5 of the largest |a|^T|b|
    term sum (float32 rounding over up to 8e5 terms; 1e-13 in float64), and
    the same bits on a second call."""
    batch, n, p, q = CELL_SHAPES[cell]
    g = torch.Generator(device="cuda").manual_seed(7)
    a = torch.randn((batch, n, p), device="cuda", generator=g, dtype=dtype)
    b = torch.randn((batch, n, q), device="cuda", generator=g, dtype=dtype)
    before = dict(kernels.COUNTS)
    got = pr.point_reduce(a, b)
    again = pr.point_reduce(a, b)
    torch.cuda.synchronize()
    assert kernels.COUNTS["point_reduce"] == before["point_reduce"] + 2
    assert kernels.COUNTS["point_reduce_plain"] == before["point_reduce_plain"]
    assert torch.equal(got, again)
    want = torch.bmm(a.double().transpose(1, 2), b.double())
    scale = torch.bmm(a.double().abs().transpose(1, 2), b.double().abs())
    err = float(((got.double() - want).abs() / scale).max())
    assert got.dtype == dtype and err <= (1e-5 if dtype == torch.float32 else 1e-13), err


@pytest.mark.cuda
@needs_cuda
def test_cuda_kernel_takes_odd_shapes():
    """Ragged chunks, the widest output a block covers, n under a chunk, an
    empty sum, a batch past the grid's y and z limits."""
    g = torch.Generator(device="cuda").manual_seed(8)
    for batch, n, p, q in [(3, 1000, 60, 64), (2, 7, 25, 4), (1, 3001, 1, 1), (2, 0, 4, 4),
                           (70_000, 3, 4, 2)]:
        a = torch.randn((batch, n, p), device="cuda", generator=g)
        b = torch.randn((batch, n, q), device="cuda", generator=g)
        got = pr.point_reduce(a, b)
        want = torch.bmm(a.double().transpose(1, 2), b.double())
        assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4), (batch, n, p, q)


@pytest.mark.cuda
@needs_cuda
def test_cuda_float64_launches_the_kernel():
    """Float64 on the card (the Stage-2 checks' dtype) launches the kernel,
    through `reduce_points` as through `point_reduce`; other dtypes, and
    inputs of two dtypes, raise."""
    a = torch.randn((2, 300, 25), device="cuda", dtype=torch.float64)
    b = torch.randn((2, 300, 4), device="cuda", dtype=torch.float64)
    before = dict(kernels.COUNTS)
    got = pr.reduce_points(a, b)
    assert kernels.COUNTS["point_reduce"] == before["point_reduce"] + 1
    assert kernels.COUNTS["point_reduce_plain"] == before["point_reduce_plain"]
    assert got.dtype == torch.float64
    assert torch.allclose(got, torch.einsum("knp,knq->kpq", a, b), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="dtype"):
        pr.point_reduce(a.half(), b.half())
    with pytest.raises(ValueError, match="dtype"):
        pr.point_reduce(a, b.float())


@pytest.mark.cuda
@needs_cuda
def test_cuda_toy_stage3_step_launches_the_kernel(tmp_path):
    """The card's step launches the kernel once for each plain call of the
    CPU's step, and makes no plain call."""
    cpu = _step_counts(tmp_path / "cpu", "cpu")
    card = _step_counts(tmp_path / "card", "cuda")
    assert card["point_reduce_plain"] == 0
    assert card["point_reduce"] == cpu["point_reduce_plain"] > 0
