"""The work-item split of the tile kernels (csrc/tile_forward.cu,
csrc/tile_backward.cu) on the CPU.

The kernels cut every tile's entry list into items of at most SEG entries
and run one block per item: forward passes F1 (per-item transmittance P),
F2 (composite from T_start = product of the earlier items' P, per-item
partials) and F3 (combine the partials in item order); backward passes B1
(per-item P and L = sum gw * alpha * prefix product) and B2 (T and the
suffix sum at the item's end from the later items' P and L, then the
reference's back-to-front walk). The CUDA code cannot run here, so this
file holds

* the wrapper's work-list builder (plain torch) on ragged counts, empty
  tiles, counts that are multiples of SEG, and entry_cap;
* a PyTorch mirror of the F1-F3 and B1-B2 algebra, with SEG = 128 to force
  many items, against the unsplit plain versions forward_tiles_plain and
  backward_tiles_plain;
* on a card (marker ``cuda``), the kernels themselves against the plain
  versions on the same scenes. The file imports nothing of JAX, so on a
  machine without it the case runs as
  ``python -m pytest --noconftest -m cuda tests/test_torch_tile_split.py``.

Tolerances are chip_smoke.py's kernel-vs-plain checks and bounds: forward 5e-4 on the
smooth channels and >= 99.9% agreement on median depth / weight and
n_contrib (a stop or T > 0.5 decision can flip on one rounding); backward
per grad-slab column 1e-3 * max |g_col| + 1e-6 * max |g| (T is rebuilt from
per-item products, and sums run in another order).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from vidu4d_tpu_torch.ops.rasterize import common as tc
from vidu4d_tpu_torch.ops.rasterize import tile_backward as tb
from vidu4d_tpu_torch.ops.rasterize import tile_forward as tf

SEG = 128  # the mirror's item size; the kernels' is tf.SEG


# ---- the work list


@pytest.mark.parametrize("counts,n_rows", [
    ([300, 0, 128, 1, 0, 129, 1024, 5], 4096),   # ragged, empty, multiples
    ([0, 0, 0], 0),                              # nothing to do
    ([128, 256, 384], 768),                      # every count a multiple
    ([1000], 1000),                              # one deep tile, slab exactly full
])
def test_work_list_covers_every_entry_once(counts, n_rows):
    c = torch.tensor(counts, dtype=torch.int32)
    item_off, grid = tf.work_list(c, n_rows, SEG)
    assert item_off.dtype == torch.int32 and item_off.shape == (len(counts) + 1,)
    per_tile = [-(-x // SEG) for x in counts]
    assert item_off.tolist() == list(np.concatenate([[0], np.cumsum(per_tile)]))
    assert int(item_off[-1]) <= grid == len(counts) + -(-n_rows // SEG)
    tile, first, n = tf.decode_items(item_off, c, SEG)
    assert (n >= 1).all() and (n <= SEG).all()
    assert (first % SEG == 0).all()
    covered = [[] for _ in counts]
    for t, f, k in zip(tile.tolist(), first.tolist(), n.tolist()):
        covered[t] += list(range(f, f + k))
    assert covered == [list(range(x)) for x in counts]


@pytest.mark.parametrize("entry_cap", [0, 128])
def test_work_list_bound_holds_under_entry_cap(entry_cap):
    """Binned frames (entry_cap truncating or not): the item count stays
    within the host-known grid of the slab's rows, for the forward's counts
    and the backward's count_eff."""
    rng = np.random.default_rng(3)
    proj, colors, opac, bg = chip_smoke.random_scene(rng, n=3000, res=64, frames=2,
                                                    n_extra=0, device="cpu")
    b = tb.prepare_batch(proj, colors, opac, bg, 64, 64, entry_cap=entry_cap)
    counts = b["tile_count"]
    if entry_cap:
        full = tb.prepare_batch(proj, colors, opac, bg, 64, 64)
        assert int(counts.sum()) < int(full["tile_count"].sum())
    _, aux = tf.forward_tiles_plain(b["slab"], b["tile_start"], counts, b["bg"],
                                    b["tiles_x"], b["tiles_per_frame"], 0)
    eff = tb.effective_counts(counts, aux[..., 8:12])
    assert (eff <= counts).all()
    for cnt in (counts, eff):
        for seg in (SEG, tf.SEG):
            item_off, grid = tf.work_list(cnt, b["slab"].shape[0], seg)
            assert int(item_off[-1]) <= grid
            _, _, n = tf.decode_items(item_off, cnt, seg)
            assert int(n.sum()) == int(cnt.sum()) and (n <= seg).all()


# ---- the mirror of the kernels' algebra


def _items(b, counts, seg):
    """The work list and each item's rows, candidates and per-item index."""
    item_off, _ = tf.work_list(counts, b["slab"].shape[0], seg)
    tile, first, n = tf.decode_items(item_off, counts, seg)
    ni = (item_off[1:] - item_off[:-1])[tile]
    s = torch.arange(tile.shape[0]) - item_off[tile]
    k = torch.arange(seg)
    rank = first[:, None] + k[None, :]
    valid = k[None, :] < n[:, None]
    idx = torch.clamp(b["tile_start"][tile][:, None].long() + rank, max=b["slab"].shape[0] - 1)
    rows = b["slab"][idx]
    pxf, pyf = tf._pixel_centers(b["tile_start"].shape[0], b["tiles_x"],
                                 b["tiles_per_frame"], "cpu")
    px, py = pxf[tile][:, None, :], pyf[tile][:, None, :]
    r = tf.splat_response(rows, px, py)
    alpha = torch.clamp(r["alpha_raw"], max=tc.ALPHA_CLAMP)
    cand = (r["pz_ok"] & (r["depth"] >= tc.NEAR_PLANE) & (alpha >= tc.ALPHA_EPS)
            & valid[..., None])
    return dict(item_off=item_off, tile=tile, s=s, ni=ni, rank=rank, valid=valid, idx=idx,
                rows=rows, px=px, py=py, r=r, alpha=alpha, cand=cand)


def _earlier(x, it, fn):
    """For each item, fn-fold x over the tile's earlier items (in order)."""
    out = torch.ones_like(x)
    for j in range(int(it["s"].max()) if len(it["s"]) else 0, 0, -1):
        sel = torch.nonzero(it["s"] >= j).flatten()
        out[sel] = fn(out[sel], x[sel - j])
    return out


def mirror_forward(b, seg):
    """F1-F3 in plain torch: (color, aux) as forward_tiles returns them."""
    nt, x = b["tile_start"].shape[0], b["n_extra"]
    it = _items(b, b["tile_count"], seg)
    rows, cand = it["rows"], it["cand"]
    alpha = torch.where(cand, it["alpha"], 0.0)
    depth = torch.where(cand, it["r"]["depth"], 0.0)
    cp = torch.cumprod(1.0 - alpha, dim=1)
    # F1: each item's transmittance; F2: T_start from the earlier items
    p_item = cp[:, -1]
    t_start = _earlier(p_item, it, torch.mul)
    live = t_start >= tc.T_EARLY_STOP
    t_incl = t_start[:, None] * cp
    t_pre = t_start[:, None] * torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], 1)
    incl = cand & (t_incl >= tc.T_EARLY_STOP) & live[:, None]
    stopped = live & (cand & (t_incl < tc.T_EARLY_STOP)).any(1)
    w = alpha * t_pre * incl
    chan = list(range(tf.RGB, tf.RGB + 3)) + list(range(tf.EXTRA, tf.EXTRA + x))
    m = tf.ndc_depth(torch.clamp(depth, min=1e-6))
    part = {
        "col": torch.einsum("nkp,nkc->npc", w, rows[..., chan]),
        "nrm": torch.einsum("nkp,nkc->npc", w, rows[..., tf.NRM:tf.NRM + 3]),
        "d": (w * depth).sum(1), "s1": (w * m).sum(1), "s2": (w * m * m).sum(1),
    }
    kk = torch.arange(seg)[None, :, None]
    last = torch.amax(torch.where(incl & (t_pre > 0.5), kk, -1), dim=1)
    sel = torch.clamp(last, min=0)[:, None]
    med_d, med_w = torch.gather(depth, 1, sel)[:, 0], torch.gather(w, 1, sel)[:, 0]
    ncon = torch.amax(torch.where(incl, (it["rank"] + 1.0)[..., None], 0.0), dim=1)
    t_end = torch.where(incl.any(1), torch.amin(torch.where(incl, t_incl, np.inf), 1),
                        t_start)
    # F3: in item order, up to the first dead or stopped item
    tot = {k: torch.zeros((nt,) + v.shape[1:]) for k, v in part.items()}
    o_med_d, o_med_w, o_ncon = (torch.zeros(nt, 256) for _ in range(3))
    o_t = torch.ones(nt, 256)
    done = torch.zeros(nt, 256, dtype=torch.bool)
    off = it["item_off"]
    for j in range(int((off[1:] - off[:-1]).max()) if nt else 0):
        tiles = torch.nonzero(off[1:] - off[:-1] > j).flatten()
        i = off[tiles] + j
        use = live[i] & ~done[tiles]
        for k, v in part.items():
            u = use if v.dim() == 2 else use[..., None]
            tot[k][tiles] += torch.where(u, v[i], 0.0)
        has = use & (last[i] >= 0)
        o_med_d[tiles] = torch.where(has, med_d[i], o_med_d[tiles])
        o_med_w[tiles] = torch.where(has, med_w[i], o_med_w[tiles])
        o_ncon[tiles] = torch.where(use & (ncon[i] > 0), ncon[i], o_ncon[tiles])
        o_t[tiles] = torch.where(use, t_end[i], o_t[tiles])
        done[tiles] |= ~live[i] | stopped[i]
    color = tot["col"] + o_t[..., None] * b["bg"][:3 + x]
    s1, s2 = tot["s1"], tot["s2"]
    aux = torch.stack([tot["d"], 1.0 - o_t, tot["nrm"][..., 0], tot["nrm"][..., 1],
                       tot["nrm"][..., 2], o_med_d, s2 * (1.0 - o_t) - s1 * s1, o_med_w,
                       o_t, o_ncon, s1, s2], dim=-1)
    return color, aux


def mirror_backward(b, cot, resid, seg):
    """B1-B2 in plain torch: the (E, 32) grad slab as backward_tiles
    returns it."""
    x = b["n_extra"]
    it = _items(b, tb.effective_counts(b["tile_count"], resid), seg)
    rows, r, tile = it["rows"], it["r"], it["tile"]
    t_fin, n_contrib, s1_tot, s2_tot = (v[tile][:, None, :] for v in resid.unbind(-1))
    a_tot = 1.0 - t_fin
    c = cot[tile]
    g_c, g_n, g_x = c[..., 0:3], c[..., 5:8], c[..., 10:]
    g_d, g_dist = c[..., 3][:, None], c[..., 9][:, None]
    g_tfin = (-c[..., 4] + c[..., 8])[:, None]
    clamped = r["alpha_raw"] > tc.ALPHA_CLAMP
    ok = it["cand"] & (it["rank"].float()[..., None] < n_contrib)
    alpha = torch.where(ok, it["alpha"], 0.0)
    depth = torch.where(ok, r["depth"], 0.0)
    om = 1.0 - alpha
    depth_pos = torch.clamp(depth, min=1e-6)
    m = tf.ndc_depth(depth_pos)
    col = lambda ch: rows[..., ch:ch + 1]
    gw = (col(tf.RGB) * g_c[:, None, :, 0] + col(tf.RGB + 1) * g_c[:, None, :, 1]
          + col(tf.RGB + 2) * g_c[:, None, :, 2] + depth * g_d
          + col(tf.NRM) * g_n[:, None, :, 0] + col(tf.NRM + 1) * g_n[:, None, :, 1]
          + col(tf.NRM + 2) * g_n[:, None, :, 2]
          + g_dist * (m * m * a_tot + s2_tot - 2.0 * m * s1_tot))
    for e in range(x):
        gw = gw + col(tf.EXTRA + e) * g_x[:, None, :, e]
    # B1: P and L of each item
    cp = torch.cumprod(om, dim=1)
    p_item = cp[:, -1]
    l_item = (gw * alpha * torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], 1)).sum(1)
    # B2: T and S at each item's end, walking the later items back to front
    t_after, s_gw = t_fin[:, 0].clone(), torch.zeros_like(p_item)
    after = it["ni"] - 1 - it["s"]
    for q in range(int(after.max()) if len(after) else 0):
        ii = torch.nonzero(after > q).flatten()
        jj = ii + after[ii] - q
        ts = t_after[ii] / p_item[jj]
        s_gw[ii] += ts * l_item[jj]
        t_after[ii] = ts
    # then the reference's walk inside the item
    sp_incl = torch.flip(torch.cumprod(torch.flip(om, [1]), 1), [1])
    t_before = t_after[:, None, :] / sp_incl
    w = alpha * t_before
    gww = gw * w
    suf = torch.flip(torch.cumsum(torch.flip(gww, [1]), 1), [1]) - gww + s_gw[:, None, :]
    g_alpha = gw * t_before - (suf + g_tfin * t_fin) / torch.clamp(om, min=1e-3)
    g_alpha = torch.where(ok & ~clamped, g_alpha, 0.0)
    g_opac = g_alpha * r["g"]
    g_rho = g_alpha * col(tf.OPAC) * r["g"] * (-0.5)
    g_m = g_dist * 2.0 * w * (m * a_tot - s1_tot)
    dmdd = torch.where(depth > 1e-6, (tc.FAR_PLANE * tc.NEAR_PLANE)
                       / ((tc.FAR_PLANE - tc.NEAR_PLANE) * depth_pos * depth_pos), 0.0)
    g_depth = torch.where(ok, w * g_d + g_m * dmdd, 0.0)
    use3d = r["use3d"]
    ipz = torch.where(ok, r["ipz"], 0.0)
    rho3d = torch.where(ok, r["rho3d"], 0.0)
    g_rho3 = torch.where(use3d, g_rho, 0.0)
    g_c2 = torch.where(use3d, 0.0, 2.0 * tc.FILTER_INV_SQUARE * g_rho)
    g_d3, g_d2 = torch.where(use3d, g_depth, 0.0), torch.where(use3d, 0.0, g_depth)
    g_px = 2.0 * r["px"] * ipz * ipz * g_rho3
    g_py = 2.0 * r["py"] * ipz * ipz * g_rho3
    g_pz = -(2.0 * rho3d * g_rho3 + depth * g_d3) * ipz
    px, py = it["px"], it["py"]
    out = torch.zeros(rows.shape)
    psum = lambda v: torch.where(ok, v, 0.0).sum(2)
    for ch, v in ((tf.PA, g_px), (tf.PA + 1, g_py), (tf.PA + 2, g_pz),
                  (tf.PB, px * g_px), (tf.PB + 1, px * g_py), (tf.PB + 2, px * g_pz),
                  (tf.PC, py * g_px), (tf.PC + 1, py * g_py), (tf.PC + 2, py * g_pz),
                  (tf.QD, ipz * g_d3), (tf.TW2, g_d2), (tf.CX, r["dx"] * g_c2),
                  (tf.CY, r["dy"] * g_c2), (tf.OPAC, g_opac)):
        out[..., ch] = psum(v)
    for i in range(3):
        out[..., tf.RGB + i] = psum(w * g_c[:, None, :, i])
        out[..., tf.NRM + i] = psum(w * g_n[:, None, :, i])
    for e in range(x):
        out[..., tf.EXTRA + e] = psum(w * g_x[:, None, :, e])
    grad = torch.zeros_like(b["slab"])
    grad[it["idx"][it["valid"]]] = out[it["valid"]]
    return grad


def _scene(case, device="cpu", seg=SEG):
    """Kernel inputs of one named case (seeded)."""
    rng = np.random.default_rng(7)
    if case == "boundary chain X=2":
        return chip_smoke.chain_batch(rng, seg, 2, device)
    kw = {"64x64 2 frames X=0": dict(n=3000, res=64, frames=2, n_extra=0),
          "64x64 2 frames X=2": dict(n=3000, res=64, frames=2, n_extra=2),
          "deep chain 2k splats / one tile": dict(n=2000, res=64, frames=1, n_extra=0,
                                                  deep=True)}[case]
    with torch.no_grad():
        proj, colors, opac, bg = chip_smoke.random_scene(rng, device=device, **kw)
        return tb.prepare_batch(proj, colors, opac, bg, kw["res"], kw["res"])


CASES = ["64x64 2 frames X=0", "64x64 2 frames X=2", "deep chain 2k splats / one tile",
         "boundary chain X=2"]


def _geo(b):
    return b["tiles_x"], b["tiles_per_frame"], b["n_extra"]


def _cotangent(b, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b["tile_start"].shape[0], 256, 10 + b["n_extra"]), generator=g)


@pytest.mark.parametrize("case", CASES)
def test_split_forward_matches_plain(case):
    b = _scene(case)
    args = (b["slab"], b["tile_start"], b["tile_count"], b["bg"])
    it = tf.work_list(b["tile_count"], b["slab"].shape[0], SEG)[0]
    assert int((it[1:] - it[:-1]).max()) >= 2  # the case splits some tile
    ref = tf.forward_tiles_plain(*args, *_geo(b))
    chip_smoke.check_forward(ref, mirror_forward(b, SEG), case)
    if case == "boundary chain X=2":  # the stops the scene places
        ncon = ref[1][..., 9]
        assert (ncon[0] == SEG).all() and (ncon[1] == SEG - 1).all()
        assert int(b["tile_count"][2]) == 2 * SEG and (ncon[2] > SEG).all()
        assert (ncon[3] == 4).all()


@pytest.mark.parametrize("case", CASES)
def test_split_backward_matches_plain(case):
    b = _scene(case)
    _, aux = tf.forward_tiles_plain(b["slab"], b["tile_start"], b["tile_count"], b["bg"],
                                    *_geo(b))
    cot, resid = _cotangent(b), aux[..., 8:12].contiguous()
    ref = tb.backward_tiles_plain(b["slab"], b["tile_start"], b["tile_count"], cot, resid,
                                  *_geo(b))
    assert float(ref.abs().max()) > 0
    chip_smoke.check_backward(ref, mirror_backward(b, cot, resid, SEG), case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_split_kernels_match_plain(case):
    """The kernels (items of tf.SEG entries) vs the plain versions on the
    card (needs nvcc + a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    b = _scene(case, device="cuda", seg=tf.SEG)
    args = (b["slab"], b["tile_start"], b["tile_count"], b["bg"])
    got = tf.forward_tiles(*args, *_geo(b))
    ref = tf.forward_tiles_plain(*args, *_geo(b))
    chip_smoke.check_forward(ref, got, case)
    cot, resid = _cotangent(b).cuda(), got[1][..., 8:12].contiguous()
    bw = (b["slab"], b["tile_start"], b["tile_count"], cot, resid)
    chip_smoke.check_backward(tb.backward_tiles_plain(*bw, *_geo(b)),
                              tb.backward_tiles(*bw, *_geo(b)), case)


def _far_corner(device, tile):
    """tests/test_torch_c1.py's scene (16 small, distant splats in the far
    corner of a 512^2 frame, where the response's 2D branch is evaluated
    ~500 px from the origin), binned at ``tile``."""
    scene = chip_smoke.c1_scene(np.random.default_rng(0), 16, 512, 512, (400, 504, 400, 504))
    _, _, _, opac, colors, _ = scene
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    with torch.no_grad():
        proj = chip_smoke.c1_project(scene, torch.float32, device)
        return tb.prepare_batch(proj, t(colors)[None], t(opac), t(np.zeros(3)), 512, 512,
                                tile=tile)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", tf.TILE_SIDES)
def test_cuda_kernels_match_plain_far_from_origin(tile):
    """K1 and K2 against their plain versions on the far-corner scene at
    each tile side (needs nvcc + a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    b = _far_corner("cuda", tile)
    geo = (*_geo(b), tile)
    args = (b["slab"], b["tile_start"], b["tile_count"], b["bg"])
    got = tf.forward_tiles(*args, *geo)
    name = f"far corner tile {tile}"
    chip_smoke.check_forward(tf.forward_tiles_plain(*args, *geo), got, name)
    g = torch.Generator().manual_seed(0)
    cot = torch.randn((b["tile_start"].shape[0], tile * tile, 10 + b["n_extra"]),
                      generator=g).cuda()
    bw = (b["slab"], b["tile_start"], b["tile_count"], cot, got[1][..., 8:12].contiguous())
    g_p = tb.backward_tiles_plain(*bw, *geo)
    assert float(g_p[:, tf.CX:tf.CY + 1].abs().max()) > 0  # the 2D branch's rows
    chip_smoke.check_backward(g_p, tb.backward_tiles(*bw, *geo), name)
