"""The device-resident frame store (`data.frame_store`) against the
memory-map path it replaces, for Stage 3's whole images and Stage 2's
sampled pixels: every (frame, delta) the loader can draw reads the same
keys, dtypes, shapes and values (exactly); a stream of batches draws the
same pairs and pixels and leaves the rngs where the map path leaves them;
and both trainers take the store whenever it fits (`vidloader.COUNTS`)."""

import os
import shutil

import numpy as np
import pytest
import torch

from tests.helpers import make_fake_db
from vidu4d_tpu_torch.data import data_utils, vidloader
from vidu4d_tpu_torch.data.frame_store import FrameStore, store_bytes

RES = 16


def _datasets(db, seed, pixels_per_image=-1):
    opts = {"dataroot": db, "seqname": "toy", "data_prefix": "crop", "train_res": RES,
            "pixels_per_image": pixels_per_image}
    return data_utils.build_datasets(opts, rng=np.random.default_rng(seed + 1))


def _drawable(ds):
    """Every (first frame, delta) `VidDataset.sample_delta` can draw."""
    return [(t, d) for t in range(len(ds)) for d in [1] + [
        d for d in vidloader.DELTAS
        if t % d == 0 and t + d < ds.num_frames and d in ds.flow["fw"]]]


def _assert_same(got, want):
    """A store batch (torch) equals a map-path batch (numpy): keys in order,
    dtypes, shapes, values."""
    assert list(got) == list(want)
    for k, v in want.items():
        w = torch.from_numpy(np.asarray(v))
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("num_vids,seed,missing", [
    (1, 0, None), (2, 5, None), (2, 1, "FlowFW_1"), (1, 2, "FlowBW_2"),
    (2, 3, "Features")])
def test_store_reads_every_drawable_pair_as_read_raw(tmp_path, num_vids, seed, missing):
    """For every (frame, delta) the loader can draw, the store's pair is
    `read_raw`'s (a missing flow table reads zeros, a missing feature file
    the zeros map), with `compute_frameid`'s global ids."""
    db = make_fake_db(tmp_path, num_vids=num_vids, T=10, H=RES, W=RES, seed=seed)
    if missing:
        sub = "Features" if missing == "Features" else missing
        shutil.rmtree(os.path.join(db, "processed", sub, "Full-Resolution", "toy-0000"))
    datasets = _datasets(db, seed)
    info = data_utils.get_data_info(datasets)
    store = FrameStore.build(datasets, info["frame_info"].frame_offset_raw, "cpu")
    assert store is not None
    assert store.nbytes == sum(store_bytes(ds) for ds in datasets) > 0
    for vid, ds in enumerate(datasets):
        pairs = _drawable(ds)
        assert any(d > 1 for _, d in pairs)
        got = store.batch([(vid, t, d, None, None) for t, d in pairs])
        frames = [f for t, d in pairs for f in (ds.read_raw(t, d), ds.read_raw(t + d, -d))]
        want = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
        want = data_utils.compute_frameid(want, info["frame_info"])
        _assert_same(got, want)
    if missing == "Features":
        assert not torch.any(store.videos[0].feature)
    elif missing:
        way = "fw" if missing.startswith("FlowFW") else "bw"
        assert int(missing[-1]) not in store.videos[0].flow[way]


@pytest.mark.parametrize("num_vids,seed,imgs", [(1, 0, 1), (2, 4, 3), (2, 9, 2)])
def test_store_batches_and_rng_stream_match_the_map_path(tmp_path, num_vids, seed, imgs):
    """Over several batches the store path (`PairBatcher.draw` + the
    store) gives `compute_frameid(flatten_pairs(next_batch()))`, as fresh
    tensors, and both paths leave both rngs in the same state."""
    db = make_fake_db(tmp_path, num_vids=num_vids, T=10, H=RES, W=RES, seed=seed)
    maps, stored = _datasets(db, seed), _datasets(db, seed)
    info = data_utils.get_data_info(maps)
    store = FrameStore.build(stored, info["frame_info"].frame_offset_raw, "cpu")
    ref = data_utils.PairBatcher(maps, imgs, seed=seed, num_hosts=1, host_id=0)
    got = data_utils.PairBatcher(stored, imgs, seed=seed, num_hosts=1, host_id=0)
    for _ in range(6):
        want = data_utils.compute_frameid(data_utils.flatten_pairs(ref.next_batch()),
                                          info["frame_info"])
        batch = store.batch(got.draw())
        _assert_same(batch, want)
        for v in batch.values():  # nothing of the store is handed out
            assert not any(v.data_ptr() == t.data_ptr()
                           for video in store.videos for t in video.tensors())
    assert np.array_equal(ref.rng.integers(0, 2 ** 31, 8), got.rng.integers(0, 2 ** 31, 8))
    assert np.array_equal(maps[0].rng.random(8), stored[0].rng.random(8))


def _assert_fresh(batch, store):
    """No tensor of ``batch`` shares memory with the store."""
    held = {t.untyped_storage().data_ptr() for video in store.videos for t in video.tensors()}
    assert not any(v.untyped_storage().data_ptr() in held for v in batch.values())


@pytest.mark.parametrize("num_vids,seed,imgs,pixels,missing", [
    (1, 0, 3, 4, None), (2, 4, 5, 7, None), (2, 1, 4, 16, "FlowFW_1"),
    (1, 2, 3, 1, "FlowBW_2"), (2, 3, 6, 5, "Features")])
def test_sampled_store_batches_and_rng_stream_match_the_map_path(
        tmp_path, num_vids, seed, imgs, pixels, missing):
    """Sampled pixels: over several batches the store path
    (`PairBatcher.draw` + `FrameStore.sampled_batch`) gives
    `compute_frameid(flatten_pairs(next_batch()))` exactly, items in draw
    order across videos, a missing flow table as zeros and a missing
    feature file as the zeros map, as fresh tensors; both paths leave both
    rngs in the same state."""
    db = make_fake_db(tmp_path, num_vids=num_vids, T=10, H=RES, W=RES, seed=seed)
    if missing:
        shutil.rmtree(os.path.join(db, "processed", missing, "Full-Resolution", "toy-0000"))
    maps, stored = _datasets(db, seed, pixels), _datasets(db, seed, pixels)
    info = data_utils.get_data_info(maps)
    store = FrameStore.build(stored, info["frame_info"].frame_offset_raw, "cpu")
    assert store.nbytes == sum(store_bytes(ds) for ds in stored)
    ref = data_utils.PairBatcher(maps, imgs, seed=seed, num_hosts=1, host_id=0)
    got = data_utils.PairBatcher(stored, imgs, seed=seed, num_hosts=1, host_id=0)
    vidloader.reset_counts()
    vids = set()
    for _ in range(6):
        want = data_utils.compute_frameid(data_utils.flatten_pairs(ref.next_batch()),
                                          info["frame_info"])
        draws = got.draw()
        vids |= {vid for vid, *_ in draws}
        batch = store.sampled_batch(draws)
        _assert_same(batch, want)
        assert all(v.is_contiguous() for v in batch.values())
        _assert_fresh(batch, store)
    assert vids == set(range(num_vids))
    assert vidloader.COUNTS == {"maps": 6 * 2 * imgs, "store": 6 * 2 * imgs}
    assert np.array_equal(ref.rng.integers(0, 2 ** 31, 8), got.rng.integers(0, 2 ** 31, 8))
    assert np.array_equal(maps[0].rng.random(8), stored[0].rng.random(8))


def test_store_is_for_whole_images_that_fit(tmp_path, monkeypatch):
    """Whole images and sampled pixels both build a store where it fits in
    its share of the free memory; above it, both keep the memory-map
    path."""
    from vidu4d_tpu_torch.data import frame_store

    db = make_fake_db(tmp_path, num_vids=1, T=8, H=RES, W=RES)
    offsets = (0, 8)
    for pixels in (-1, 4):
        datasets = _datasets(db, 0, pixels)
        need = store_bytes(datasets[0])
        monkeypatch.setattr(frame_store, "free_bytes", lambda device: 4 * need - 4)
        assert FrameStore.build(datasets, offsets, "cpu") is None
        monkeypatch.setattr(frame_store, "free_bytes", lambda device: 4 * need)
        assert FrameStore.build(datasets, offsets, "cpu").nbytes == need


def _s2_trainer(base, logname):
    from vidu4d_tpu_torch.engine.trainer import Stage2Trainer

    return Stage2Trainer({**base, "logname": logname, "pixels_per_image": 4, "imgs_per_gpu": 2,
                          "fg_motion": "bob", "field_depth": 2, "field_width": 32,
                          "train_depth_samples": 8, "num_rounds": 2, "iters_per_round": 2},
                         "cpu")


def _base(tmp_path, db):
    return {"dataroot": db, "seqname": "toy", "logroot": os.path.join(str(tmp_path), "logdir"),
            "data_prefix": "crop", "train_res": RES}


@pytest.mark.parametrize("stage,path", [(3, "store"), (3, "maps"), (2, "store"),
                                        (2, "maps")])
def test_trainers_count_frames_from_the_store_and_the_maps(tmp_path, monkeypatch, stage,
                                                          path):
    """A trainer (Stage 3: whole images; Stage 2: sampled pixels) takes
    finite steps on each step's frames from the store and none from the
    maps, or, where its store does not fit, on every frame read from the
    maps."""
    from vidu4d_tpu_torch.data import frame_store
    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer

    db = make_fake_db(tmp_path, num_vids=1, T=8, H=RES, W=RES)
    base = _base(tmp_path, db)
    if path == "maps":
        monkeypatch.setattr(frame_store, "free_bytes", lambda device: 0)
    if stage == 3:
        tr = Stage3Trainer({**base, "logname": "s3", "pixels_per_image": -1,
                            "imgs_per_gpu": 1, "fg_motion": "gs-bob", "gs_capacity": 128,
                            "gs_init_samples": 96}, "cpu")
    else:
        tr = _s2_trainer(base, "s2")
    vidloader.reset_counts()
    steps = 2
    for _ in range(steps):
        m = tr.train_step()
        assert all(np.isfinite(float(v)) for v in m.values())
    assert (tr.frame_store is None) == (path == "maps")
    frames = 2 * tr.batcher.imgs_per_batch * steps
    assert vidloader.COUNTS == {"store": 0, "maps": 0, path: frames}


@pytest.mark.parametrize("num_vids", [1, 2])
def test_stage2_trainer_draws_the_map_paths_batches(tmp_path, monkeypatch, num_vids):
    """A Stage-2 trainer's initial draw reads nothing, and its first
    training batches from the store are those of a trainer on the map path
    built with the same seed, and of a `PairBatcher` that reads the
    initial batch and then the training ones."""
    from vidu4d_tpu_torch.data import frame_store

    db = make_fake_db(tmp_path, num_vids=num_vids, T=8, H=RES, W=RES, seed=num_vids)
    base = _base(tmp_path, db)
    vidloader.reset_counts()
    stored = _s2_trainer(base, "stored")
    assert vidloader.COUNTS == {"store": 0, "maps": 0}
    assert stored.frame_store is not None
    datasets = _datasets(db, 0, 4)
    ref = data_utils.PairBatcher(datasets, 2, seed=0, num_hosts=1, host_id=0)
    ref.next_batch()
    monkeypatch.setattr(frame_store, "free_bytes", lambda device: 0)
    maps = _s2_trainer(base, "maps")
    for _ in range(3):
        want = data_utils.compute_frameid(data_utils.flatten_pairs(ref.next_batch()),
                                          stored.frame_info)
        got = stored._next_batch()
        _assert_same(got, want)
        _assert_same(maps._next_batch(), want)
    assert maps.frame_store is None
