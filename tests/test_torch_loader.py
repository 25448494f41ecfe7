"""The port's Loader against the JAX package's, on the CPU: the batches of
steps 0-5 from the same datasets and schedules (CustomDataset: every
field; MultiGen-20M: every numeric field, where the JAX batch also stacks
the string ``task``, the defect that stops its MultiGen training and that
the port's collate drops), the host slice of the global batch, resuming
with ``iterate(start_step)``, and ``to_device``.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from ctrlora_tpu.data import datasets as jax_datasets
from ctrlora_tpu.data import loader as jax_loader
from ctrlora_tpu.data import scheduler as jax_scheduler

from ctrlora_tpu_torch.data import datasets, loader, scheduler


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A CustomDataset directory of five pairs and a two-task MultiGen
    directory of three items a task, images of mixed orientation."""
    root = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(6)
    custom = root / "custom"
    (custom / "source").mkdir(parents=True)
    (custom / "target").mkdir()
    with open(custom / "prompt.json", "w") as f:
        for i in range(5):
            shape = (20, 24) if i % 2 else (24, 20)
            for sub in ("source", "target"):
                cv2.imwrite(str(custom / sub / f"{i}.png"),
                            rng.integers(0, 256, (*shape, 3), np.uint8))
            f.write(json.dumps({"source": f"source/{i}.png", "target": f"target/{i}.png",
                                "prompt": f"a picture of item {i}"}) + "\n")
    mg = root / "multigen"
    (mg / "images").mkdir(parents=True)
    (mg / "conditions").mkdir()
    for task in ("canny", "depth"):
        with open(mg / f"{task}.json", "w") as f:
            for i in range(3):
                shape = (28, 20) if i % 2 else (20, 28)
                cv2.imwrite(str(mg / "images" / f"{task}{i}.png"),
                            rng.integers(0, 256, (*shape, 3), np.uint8))
                cv2.imwrite(str(mg / "conditions" / f"{task}{i}.png"),
                            rng.integers(0, 256, (*shape, 3), np.uint8))
                f.write(json.dumps({"source": f"./{task}{i}.png", f"control_{task}":
                                    f"{task}{i}.png", "prompt": f"{task} {i}"}) + "\n")
    return str(custom), str(mg)


def _custom(mod, root):
    return [mod.CustomDataset(root, drop_rate=0.3, resolution=16)]


def _multigen(mod, root):
    return [mod.MultiGen20M(os.path.join(root, f"{t}.json"), root, t, drop_rate=0.3,
                            resolution=16) for t in ("canny", "depth")]


def _steps(ld, n=6):
    it = ld.iterate(0)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def test_custom_batches_match_jax(dirs):
    ours = loader.Loader(_custom(datasets, dirs[0]), scheduler.SingleTaskSchedule(5, 3, seed=2),
                         num_workers=2, seed=9, max_length=16)
    ref = jax_loader.Loader(_custom(jax_datasets, dirs[0]),
                            jax_scheduler.SingleTaskSchedule(5, 3, seed=2), num_workers=2,
                            seed=9, max_length=16)
    for a, b in zip(_steps(ours), _steps(ref)):
        assert a.keys() == b.keys() == {"jpg", "hint", "token_ids", "task_idx"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert a["jpg"].shape == (3, 16, 16, 3) and a["token_ids"].shape == (3, 16)
    assert ours.last_step == 5 and ours.wait_s >= 0.0


def test_multigen_numeric_fields_match_jax(dirs):
    ours = loader.Loader(_multigen(datasets, dirs[1]),
                         scheduler.MultiTaskSchedule((3, 3), 2, seed=4), num_workers=2, seed=1)
    ref = jax_loader.Loader(_multigen(jax_datasets, dirs[1]),
                            jax_scheduler.MultiTaskSchedule((3, 3), 2, seed=4), num_workers=2,
                            seed=1)
    tasks = set()
    for a, b in zip(_steps(ours), _steps(ref)):
        assert set(a) == {"jpg", "hint", "token_ids", "task_idx"}
        assert b["task"].dtype.kind == "U"  # the JAX loader stacks the string field
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        tasks.add(int(a["task_idx"][0]))
        assert a["task_idx"].dtype == np.int32 and len(set(a["task_idx"].tolist())) == 1
    assert tasks == {0, 1}


def test_host_slices_make_the_global_batch(dirs):
    sched = scheduler.SingleTaskSchedule(5, 4, seed=0)
    whole = loader.Loader(_custom(datasets, dirs[0]), sched, num_workers=1)
    parts = [loader.Loader(_custom(datasets, dirs[0]), sched, num_workers=1, host_id=h,
                           host_count=2) for h in range(2)]
    for step in (0, 3):
        full = whole.load_batch(step)
        halves = [p.load_batch(step) for p in parts]
        for k in full:
            np.testing.assert_array_equal(full[k], np.concatenate([h[k] for h in halves]))
    ref = jax_loader.Loader(_custom(jax_datasets, dirs[0]),
                            jax_scheduler.SingleTaskSchedule(5, 4, seed=0), num_workers=1,
                            host_id=1, host_count=2)
    for k, v in parts[1].load_batch(2).items():
        np.testing.assert_array_equal(v, ref._load_batch(2)[k])
    with pytest.raises(ValueError, match="divide"):
        loader.Loader(_custom(datasets, dirs[0]), sched, host_count=3)


def test_iterate_resumes_exactly(dirs):
    ld = loader.Loader(_multigen(datasets, dirs[1]), scheduler.MultiTaskSchedule((3, 3), 2, seed=4),
                       num_workers=2, seed=1)
    straight = _steps(ld)
    it = ld.iterate(3)
    resumed = [next(it) for _ in range(3)]
    it.close()
    assert ld.last_step == 5
    for a, b in zip(straight[3:], resumed):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_to_device(dirs):
    ld = loader.Loader(_custom(datasets, dirs[0]), scheduler.SingleTaskSchedule(5, 2), num_workers=1)
    host = ld.load_batch(0)
    dev = loader.to_device(host, "cpu")
    assert dev.keys() == host.keys()
    for k, v in dev.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), host[k])
    assert dev["task_idx"].dtype == torch.int32 and dev["jpg"].dtype == torch.float32
