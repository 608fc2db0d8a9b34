"""The round shell both trainers share (`engine.rounds.RoundTrainer`), on
the CPU at toy size, for Stage 2 and Stage 3: the gradient-spike rollback
restores, in place, what each trainer restores (Stage 2: the model's
parameters and buffers and AdamW's count and moments, not the field
states; Stage 3: the deformer, the surfel store with its statistics and
both optimisers' counts and moments), and no snapshot is taken without
``rollback_on_grad_spike``."""

import functools
import os

import pytest
import torch

from tests.helpers import make_fake_db

RES = 16


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return make_fake_db(tmp_path_factory.mktemp("rounds"), num_vids=1, T=8, H=RES, W=RES)


def _trainer(db, tmp_path, stage, **extra):
    base = {"dataroot": db, "seqname": "toy", "logname": f"s{stage}",
            "logroot": os.path.join(str(tmp_path), "logdir"), "data_prefix": "crop",
            "train_res": RES, "save_freq": 100, **extra}
    if stage == 2:
        from vidu4d_tpu_torch.engine.trainer import Stage2Trainer

        tr = Stage2Trainer({**base, "fg_motion": "bob", "pixels_per_image": 4,
                            "imgs_per_gpu": 2, "field_depth": 2, "field_width": 32,
                            "train_depth_samples": 8}, "cpu")
        # a round's proxy mesh on a 12^3 grid: a few hundred vertices to export
        tr.update_geometry_aux = functools.partial(tr.update_geometry_aux, grid_size=12)
        return tr
    from vidu4d_tpu_torch.engine.gs4d_trainer import Stage3Trainer

    return Stage3Trainer({**base, "fg_motion": "gs-bob", "pixels_per_image": -1,
                          "imgs_per_gpu": 1, "gs_capacity": 128, "gs_init_samples": 96,
                          "sh_degree": 1, "feat_reproj_px": 64}, "cpu")


def _restored(tr):
    """Clones of what a rollback restores, by name, with the counts."""
    clone = lambda d, prefix: {f"{prefix}.{k}": v.detach().clone() for k, v in d.items()}
    if hasattr(tr, "optimizer"):  # Stage 2
        opt = tr.optimizer
        return {**clone(tr.model.state_dict(), "model"), **clone(opt.mu, "mu"),
                **clone(opt.nu, "nu"), "count": torch.tensor(opt.count)}
    s, a, w = tr.surfels, tr.gs_adam, tr.warp_opt
    out = {f"surfels.{i}": x.detach().clone() for i, x in enumerate((*s.params, *s[1:]))}
    out.update({f"adam.{i}": x.clone() for i, x in enumerate((*a.mu, *a.nu))})
    out.update({**clone(tr.deformer.state_dict(), "deformer"), **clone(w.mu, "warp.mu"),
                **clone(w.nu, "warp.nu")})
    out.update({"adam.count": torch.tensor(a.count), "warp.count": torch.tensor(w.count)})
    return out


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("stage", [2, 3])
def test_rollback_restores_the_state_of_two_rounds_before(db, tmp_path, stage):
    """With rollback_on_grad_spike, `train` forces one step a chunk and
    queues a snapshot a round; a gnorm above grad_spike_thresh restores the
    one taken at the start of the round before last, and it stays intact
    for a second rollback: the cache holds copies, not the live tensors."""
    tt = _trainer(db, tmp_path, stage, rollback_on_grad_spike=True, grad_spike_thresh=1e9,
                  num_rounds=2, iters_per_round=2, iters_per_dispatch=3)
    assert tt._maybe_rollback(1e12) is False  # nothing cached yet
    start = _restored(tt)
    tt.train()
    assert tt.current_steps == 4 and int(_restored(tt)["count" if stage == 2
                                                       else "warp.count"]) == 4
    assert not _equal(_restored(tt), start)
    tt.opts["grad_spike_thresh"] = 1e-12
    assert tt._maybe_rollback(0.0) is False
    batch = tt._next_batch()
    m = tt.train_step(batch)
    assert tt._maybe_rollback(m["gnorm"])
    assert _equal(_restored(tt), start)
    tt.train_step(batch)
    assert tt._maybe_rollback(m["gnorm"]) and _equal(_restored(tt), start)


@pytest.mark.parametrize("stage", [2, 3])
def test_no_snapshot_without_rollback(db, tmp_path, stage):
    """Without rollback_on_grad_spike `train` takes no snapshot (nothing
    reads one), and a spike restores nothing."""
    tt = _trainer(db, tmp_path, stage, num_rounds=2, iters_per_round=1)
    taken = []
    snapshot = tt._snapshot
    tt._snapshot = lambda: taken.append(1) or snapshot()
    tt.train()
    assert tt.current_steps == 2 and taken == [] and tt._rollback_cache == [None, None]
    assert tt._maybe_rollback(1e12) is False
