"""Threaded prefetching loader of training batches (the port's counterpart
of ``ctrlora_tpu/data/loader.py``).

Worker threads read, crop and resize the examples while the card trains
(the native image prep and cv2 release the GIL); prompts are tokenized on
the host; each host builds only its slice of the global batch, with the
same per-example numpy draws as the JAX loader, so both give the same
batches. Collate keeps the numeric fields only: the prompt (``txt``) and
MultiGen's task name (``task``) are strings and are dropped (the JAX
loader stacks ``task`` too, and its MultiGen training fails there).

Batch: jpg [B, H, W, 3] f32, hint [B, H, W, 3] f32 (or jpg_moments /
hint_moments [B, h, w, 8] f32 from a latent-cached dataset), token_ids
[B, L] int64, task_idx [B] int32; ``to_device`` moves one to the card.
"""

from __future__ import annotations

import queue
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ctrlora_tpu_torch.utils.tokenizer import CLIPTokenizer, default_tokenizer


class Loader:
    """Batches of `datasets` (one per task) in the order `schedule`
    (``data.scheduler``) gives. ``wait_s`` sums the seconds the consumer
    waited for a batch that was not ready; ``last_step`` is the step of the
    last batch handed out."""

    def __init__(self, datasets: Sequence, schedule, tokenizer: Optional[CLIPTokenizer] = None,
                 num_workers: int = 8, prefetch: int = 4, seed: int = 0, host_id: int = 0,
                 host_count: int = 1, max_length: Optional[int] = None, micro: int = 1):
        self.datasets = list(datasets)
        self.schedule = schedule
        self.tokenizer = tokenizer or default_tokenizer()
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.host_id = host_id
        self.host_count = host_count
        self.max_length = max_length
        if schedule.batch_size % (host_count * micro):
            raise ValueError(f"global batch {schedule.batch_size} does not divide across "
                             f"{host_count} hosts in {micro} micro-batches")
        self.local_batch = schedule.batch_size // host_count
        # the global positions this host reads: its block of each of the
        # `micro` micro-batches the global batch is split into
        per, rows = schedule.batch_size // micro, self.local_batch // micro
        self.positions = [m * per + host_id * rows + j for m in range(micro)
                          for j in range(rows)]
        self.wait_s = 0.0
        self.last_step: Optional[int] = None

    def load_batch(self, step: int) -> Dict[str, np.ndarray]:
        task, indices = self.schedule.batch_for_step(step)
        ds = self.datasets[task]
        # per-example draws: a function of (seed, step, global position)
        examples = [ds.get(int(indices[pos]), np.random.default_rng((self.seed, 0xDA7A, step, pos)))
                    for pos in self.positions]
        batch = {k: np.stack([e[k] for e in examples]) for k, v in examples[0].items()
                 if isinstance(v, np.ndarray)}
        batch["token_ids"] = self.tokenizer([e["txt"] for e in examples],
                                            max_length=self.max_length)
        batch["task_idx"] = np.full((len(examples),), task, np.int32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iterate(0)

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Endless batches from `start_step` on (resume at the train
        state's step), `prefetch` of them loading ahead."""
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        pending: "queue.Queue" = queue.Queue()
        step = start_step
        try:
            for _ in range(self.prefetch):
                pending.put((step, pool.submit(self.load_batch, step)))
                step += 1
            while True:
                s, fut = pending.get()
                pending.put((step, pool.submit(self.load_batch, step)))
                step += 1
                t0 = time.perf_counter()
                batch = fut.result()
                self.wait_s += time.perf_counter() - t0
                self.last_step = s
                yield batch
        finally:
            try:
                pool.shutdown(wait=False, cancel_futures=True)
            except TypeError:
                # a generator finalised at interpreter exit finds
                # concurrent.futures' module globals already None
                pass


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on `device` (the one-device role of JAX's
    ``shard_batch``): for a CUDA device each array goes through pinned host
    memory and is copied with non_blocking=True."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}
