"""The round shell the port's two trainers (`Stage2Trainer`,
`Stage3Trainer`) share: set-up, the ranks' state, the batch path, the
gradient-spike rollback, the round loop and `train`."""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vidu4d_tpu_torch.data import data_utils
from vidu4d_tpu_torch.data.frame_store import FrameStore
from vidu4d_tpu_torch.parallel import sharding
from vidu4d_tpu_torch.utils.logging import ScalarLogger, dump_opts_json
from vidu4d_tpu_torch.utils.profiler import round_trace, span


class RoundTrainer:
    """A trainer on ``device``, in the run's directory
    ``<logroot>/<seqname>-<logname>`` (with ``opts.json``). ``group``: this
    rank's `sharding.Mesh` when ``opts["ngpu"]`` > 1 (its world size must
    be ngpu); None builds it from an initialised process group or a
    launcher's environment (`sharding.trainer_group`), and raises without
    one. A subclass supplies its model, `train_step` (which reads its batch
    through ``self._next_batch`` and advances ``current_steps``),
    `state_tensors`, `save_checkpoint`, and the hooks `_rollback_state`,
    `_set_counts`, `_before_round` and `_round_note`."""

    UNLOGGED: tuple = ()  # the metrics a log call leaves out

    def __init__(self, opts: Dict, device, datasets, data_info,
                 group: Optional[sharding.Mesh], imgs_per_gpu: int):
        self.device = torch.device(device)
        self.opts = opts = dict(opts)
        self.group = sharding.trainer_group(opts.get("ngpu", 1) or 1, self.device, group)
        self.is_root = self.group is None or self.group.rank == 0
        # every rank, on every node, draws the whole global batch as one
        # host does (`sharding.shard_batch` alone splits it)
        self.datasets = (datasets if datasets is not None
                         else data_utils.build_datasets(opts, process_index=0))
        self.data_info = data_info or data_utils.get_data_info(self.datasets)
        self.frame_info = self.data_info["frame_info"]
        self.save_dir = os.path.join(opts.get("logroot", "logdir"),
                                     f"{opts['seqname']}-{opts['logname']}")
        if self.is_root:
            os.makedirs(self.save_dir, exist_ok=True)
            dump_opts_json(self.save_dir, opts)
        self.current_steps = 0
        self.current_round = 0
        # wall seconds of each round of `train` (its "Round NNN: time=")
        self.round_seconds: List[float] = []
        # the snapshots of the last two rounds (rollback_on_grad_spike)
        self._rollback_cache = [None, None]
        self.batcher = data_utils.PairBatcher(
            self.datasets, opts.get("imgs_per_gpu", imgs_per_gpu),
            seed=max(opts.get("seed", 0), 0), num_hosts=1, host_id=0)

    def broadcast_state(self) -> None:
        """Rank 0's `state_tensors` on every rank (after the init and every
        load: GPU non-determinism must not split the ranks)."""
        sharding.broadcast_tensors_(self.state_tensors(), self.group)

    def ranks_agree(self) -> bool:
        """Whether every rank holds the same `state_tensors` (a checksum
        all-reduce); True for one process."""
        return sharding.checksum_agrees(self.state_tensors(), self.group)

    @functools.cached_property
    def frame_store(self) -> Optional[FrameStore]:
        """Every frame read once into the device's memory (at the first
        batch: a trainer that only renders or exports never builds it),
        each batch then gathered there; None: the memory-map path."""
        return FrameStore.build(self.datasets, self.frame_info.frame_offset_raw, self.device)

    @span("data.batch")
    def _next_batch(self) -> Dict[str, torch.Tensor]:
        """The next global batch on the device: from the store, whole images
        or sampled pixels as the draws' items are; else read from the
        memory maps and copied over."""
        store = self.frame_store
        if store is not None:
            draws = self.batcher.draw()
            whole = draws[0][3] is None
            return store.batch(draws) if whole else store.sampled_batch(draws)
        batch = data_utils.flatten_pairs(self.batcher.next_batch())
        batch = data_utils.compute_frameid(batch, self.frame_info)
        with span("data.copy"):
            return {k: torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in batch.items()}

    def _snapshot(self) -> tuple:
        """Clones of the tensors of `_rollback_state`, and its counts."""
        tensors, counts = self._rollback_state()
        return [x.detach().clone() for x in tensors], counts

    @torch.no_grad()
    def _restore(self, snap: tuple) -> None:
        """Copy a `_snapshot` into the live tensors (the optimisers keep
        their parameter tensors; the snapshot stays as it is) and set its
        counts (`_set_counts`)."""
        for dst, src in zip(self._rollback_state()[0], snap[0], strict=True):
            dst.copy_(src)
        self._set_counts(snap[1])

    def _update_rollback_cache(self) -> None:
        """The two-deep per-round snapshot queue (`trainer.py:366`), taken
        only with ``rollback_on_grad_spike``: `_maybe_rollback` alone reads
        it."""
        if self.opts.get("rollback_on_grad_spike", False):
            self._rollback_cache = [self._rollback_cache[1], self._snapshot()]

    def _maybe_rollback(self, gnorm) -> bool:
        """Restore the state of two rounds ago when gnorm >
        ``grad_spike_thresh`` (`trainer.py:372`)."""
        thresh = self.opts.get("grad_spike_thresh", 5.0)
        if float(gnorm) <= thresh or self._rollback_cache[0] is None:
            return False
        print(f"large grad: {float(gnorm):.2f}, resume from cached weights")
        self._restore(self._rollback_cache[0])
        return True

    def _after_chunk(self, steps: int) -> None:
        """Runs after each chunk of ``steps`` steps."""

    def _round_result(self, metrics: Dict):
        return metrics

    def train_one_round(self, log_fn: Optional[Callable] = None):
        """``iters_per_round`` steps in chunks of ``iters_per_dispatch`` = k,
        as the JAX trainers' scanned chunks: `_after_chunk` runs after each
        (a short final one too) with its length, and ``log_fn(step, {name:
        float})`` gets the chunk's last metrics, less ``UNLOGGED``, when it
        passes a multiple of 100 steps. ``rollback_on_grad_spike`` forces
        k = 1 and discards a step whose gnorm spikes; nothing else reads the
        device. Returns `_round_result` of the last step's metrics."""
        rollback = self.opts.get("rollback_on_grad_spike", False)
        iters = self.opts.get("iters_per_round", 200)
        k = 1 if rollback else int(self.opts.get("iters_per_dispatch", 1) or 1)
        metrics, done = None, 0
        while done < iters:
            kk = min(k, iters - done)
            for _ in range(kk):
                metrics = self.train_step()
            if rollback and self._maybe_rollback(metrics["gnorm"]):
                self.current_steps -= 1  # the step is discarded
                continue
            done += kk
            self._after_chunk(kk)
            if log_fn is not None and self.current_steps % 100 < kk:
                log_fn(self.current_steps, {n: float(v) for n, v in metrics.items()
                                            if n not in self.UNLOGGED})
        return self._round_result(metrics)

    def train(self, log_fn: Optional[Callable] = None) -> None:
        """Rounds ``current_round`` .. ``num_rounds`` - 1: `_before_round`,
        `train_one_round` (traced with ``opts["profile"]``), a checkpoint
        every ``save_freq`` rounds and after the last, and a ``Round NNN:``
        line ended by `_round_note`; each round's wall seconds go to
        ``round_seconds``. log_fn defaults to a `ScalarLogger`'s. Of a
        group's ranks, rank 0 alone logs, traces, writes and prints."""
        root = self.is_root
        logger = ScalarLogger(self.save_dir) if root else None
        log_fn = (log_fn or logger.log_loss_dict) if root else None
        num_rounds = self.opts.get("num_rounds", 60)
        try:
            for rnd in range(self.current_round, num_rounds):
                self._update_rollback_cache()
                t0 = time.time()
                before = self._before_round(rnd, logger)
                with round_trace(self.save_dir, rnd,
                                 enabled=root and self.opts.get("profile", False),
                                 device=self.device):
                    result = self.train_one_round(log_fn=log_fn)
                self.current_round = rnd + 1
                if (self.current_round % self.opts.get("save_freq", 10) == 0
                        or self.current_round == num_rounds):
                    self.save_checkpoint(self.current_round)
                note = self._round_note(result, before)
                self.round_seconds.append(time.time() - t0)
                if root:
                    print(f"Round {rnd:03d}: time={self.round_seconds[-1]:.3f}s{note}")
        finally:
            if logger is not None:
                logger.close()
