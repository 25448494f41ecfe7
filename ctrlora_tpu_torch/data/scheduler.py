"""Deterministic multi-task batch schedules (the port's copy of
``ctrlora_tpu/data/scheduler.py``; numpy only).

Role of the reference's BatchSchedulerSampler
(datasets/multi_task_scheduler.py:18-80): every mini-batch is drawn from ONE
task, tasks rotate in a per-round random permutation, small tasks resample.
Each schedule is a pure function of (seed, step) through numpy's
``default_rng``, so every host computes the same task and the same global
example indices and takes its own slice, and the port draws exactly the
JAX package's batches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MultiTaskSchedule:
    sizes: Tuple[int, ...]  # per-task dataset sizes
    batch_size: int  # GLOBAL batch size
    seed: int = 0
    shuffle: bool = True

    @property
    def n_tasks(self) -> int:
        return len(self.sizes)

    def _round_perm(self, rnd: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.n_tasks)
        return np.random.default_rng((self.seed, 0x7A5C, rnd)).permutation(self.n_tasks)

    def task_for_step(self, step: int) -> int:
        rnd, pos = divmod(step, self.n_tasks)
        return int(self._round_perm(rnd)[pos])

    def _appearances_before(self, task: int, step: int) -> int:
        """How many batches of `task` were drawn in steps < step."""
        rnd, pos = divmod(step, self.n_tasks)
        perm = self._round_perm(rnd)
        return rnd + int(int(np.where(perm == task)[0][0]) < pos)

    def _task_stream(self, task: int, start: int, n: int) -> np.ndarray:
        """Elements [start, start+n) of the task's infinite shuffled stream
        (concatenated seeded permutations; small tasks recycle)."""
        size = self.sizes[task]
        out = np.empty(n, np.int64)
        i = 0
        while i < n:
            epoch, pos = divmod(start + i, size)
            perm = (np.random.default_rng((self.seed, 0x11D, task, epoch)).permutation(size)
                    if self.shuffle else np.arange(size))
            take = min(n - i, size - pos)
            out[i:i + take] = perm[pos:pos + take]
            i += take
        return out

    def batch_for_step(self, step: int) -> Tuple[int, np.ndarray]:
        """(task_idx, global example indices [batch_size]), the same on
        every host for a given step."""
        task = self.task_for_step(step)
        start = self._appearances_before(task, step) * self.batch_size
        return task, self._task_stream(task, start, self.batch_size)

    def steps_per_epoch(self) -> int:
        """Reference epoch semantics: largest task size x n_tasks samples
        (multi_task_scheduler.py:54)."""
        return math.ceil(max(self.sizes) / self.batch_size) * self.n_tasks


@dataclasses.dataclass(frozen=True)
class SingleTaskSchedule:
    """Plain seeded shuffled batches for single-dataset finetuning."""

    size: int
    batch_size: int
    seed: int = 0
    shuffle: bool = True

    def batch_for_step(self, step: int) -> Tuple[int, np.ndarray]:
        sched = MultiTaskSchedule((self.size,), self.batch_size, seed=self.seed,
                                  shuffle=self.shuffle)
        return 0, sched._task_stream(0, step * self.batch_size, self.batch_size)
