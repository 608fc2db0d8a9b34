"""The port's own data path (vidu4d_tpu_torch.data) vs the JAX package's.

Both read the same synthetic database with the same seeds; every array is
compared exactly (the two are the same numpy code on the same files).
"""

import numpy as np
import pytest

from tests.helpers import make_fake_db
from vidu4d_tpu.data import data_utils as jdata
from vidu4d_tpu_torch.data import data_utils as tdata
from vidu4d_tpu_torch.data.frame_info import FrameInfo


@pytest.mark.parametrize("num_vids,seed", [(1, 0), (2, 5)])
def test_data_path_matches_jax_package(tmp_path, num_vids, seed):
    """build_datasets + get_data_info + PairBatcher batches (flattened,
    with global frame ids) equal the JAX package's data_utils + PairBatcher
    draws (one host)."""
    db = make_fake_db(tmp_path, num_vids=num_vids, T=10, H=16, W=16)
    opts = {"dataroot": db, "seqname": "toy", "data_prefix": "crop", "train_res": 16,
            "pixels_per_image": -1, "seed": seed}
    # the JAX package's single-host rng (seed + 1), as the trainer passes it
    jds = jdata.build_datasets(opts, rng=np.random.default_rng(seed + 1))
    tds = tdata.build_datasets(opts, rng=np.random.default_rng(seed + 1))
    ji, ti = jdata.get_data_info(jds), tdata.get_data_info(tds)
    assert tuple(ji["frame_info"]) == tuple(ti["frame_info"])
    assert isinstance(ti["frame_info"], FrameInfo)
    for k in ("intrinsics", "rtmat", "raw_size"):
        assert np.array_equal(ji[k], ti[k]), k
    assert ji["total_frames"] == ti["total_frames"]
    assert ji["geom_path"] == ti["geom_path"]
    feats = np.random.default_rng(0).normal(size=(5, 16))
    assert np.array_equal(ji["apply_pca_fn"](feats), ti["apply_pca_fn"](feats))

    ref = jdata.PairBatcher(jds, 2, seed=seed, num_hosts=1, host_id=0)
    got = tdata.PairBatcher(tds, 2, seed=seed)
    for _ in range(4):
        a = jdata.compute_frameid(jdata.flatten_pairs(ref.next_batch()), ji["frame_info"])
        b = tdata.compute_frameid(tdata.flatten_pairs(got.next_batch()), ti["frame_info"])
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
