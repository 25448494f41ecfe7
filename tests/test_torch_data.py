"""The port's data layer against the JAX package's, on the CPU:

* ``data.scheduler``: MultiTaskSchedule and SingleTaskSchedule give JAX's
  tasks and example indices exactly (pure numpy functions of seed and step);
* ``data.datasets.MultiGen20M.get``: the same arrays, prompt and task key
  from the same draws, for non-square images in both orientations, the
  centred crop, and the skip loop over a sample whose condition is missing;
* the native image prep (``CTRLORA_NATIVE_DATA=1``): ``CustomDataset.get``
  equal bit for bit to the JAX package's native path, the port's own build
  under ``ctrlora_tpu_torch/_build/``, and a failed build raising instead of
  falling back to cv2.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from ctrlora_tpu.data import datasets as jax_datasets
from ctrlora_tpu.data import native as jax_native
from ctrlora_tpu.data import scheduler as jax_scheduler

from ctrlora_tpu_torch.data import datasets, native, scheduler


@pytest.mark.parametrize("shuffle", [True, False])
def test_multitask_schedule_matches_jax(shuffle):
    ours = scheduler.MultiTaskSchedule((5, 11, 2), 4, seed=3, shuffle=shuffle)
    ref = jax_scheduler.MultiTaskSchedule((5, 11, 2), 4, seed=3, shuffle=shuffle)
    for step in range(60):
        t1, i1 = ours.batch_for_step(step)
        t2, i2 = ref.batch_for_step(step)
        assert t1 == t2 and i1.dtype == i2.dtype
        np.testing.assert_array_equal(i1, i2)
    assert ours.steps_per_epoch() == ref.steps_per_epoch() == 9


@pytest.mark.parametrize("shuffle", [True, False])
def test_single_task_schedule_matches_jax(shuffle):
    ours = scheduler.SingleTaskSchedule(7, 3, seed=5, shuffle=shuffle)
    ref = jax_scheduler.SingleTaskSchedule(7, 3, seed=5, shuffle=shuffle)
    for step in range(60):
        t1, i1 = ours.batch_for_step(step)
        t2, i2 = ref.batch_for_step(step)
        assert t1 == t2 == 0
        np.testing.assert_array_equal(i1, i2)


# ---------------------------------------------------------------------------
# MultiGen-20M
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def multigen_dir(tmp_path_factory):
    """Six hed items: conditions and images landscape and portrait, of other
    sizes than each other; item 2's condition file is missing and item 4
    has no prompt (both are skipped for the next item)."""
    root = tmp_path_factory.mktemp("multigen")
    (root / "images").mkdir()
    (root / "conditions").mkdir()
    rng = np.random.default_rng(2)
    shapes = [((40, 56), (80, 112)), ((56, 40), (70, 50)), ((40, 56), (40, 56)),
              ((24, 20), (36, 30)), ((30, 44), (30, 44)), ((48, 32), (96, 64))]
    with open(root / "hed.json", "w") as f:
        for i, (cshape, ishape) in enumerate(shapes):
            if i != 2:
                cv2.imwrite(str(root / "conditions" / f"c{i}.png"),
                            rng.integers(0, 256, (*cshape, 3), np.uint8))
            cv2.imwrite(str(root / "images" / f"i{i}.png"),
                        rng.integers(0, 256, (*ishape, 3), np.uint8))
            item = {"source": f"./i{i}.png", "control_hed": f"c{i}.png"}
            if i != 4:
                item["prompt"] = f"an image number {i}"
            f.write(json.dumps(item) + "\n")
    return str(root)


@pytest.mark.parametrize("random_cropping,drop_rate,resolution",
                         [(True, 0.5, 32), (False, 0.0, 32), (True, 0.0, 64)])
def test_multigen_get_matches_jax(multigen_dir, random_cropping, drop_rate, resolution):
    args = (os.path.join(multigen_dir, "hed.json"), multigen_dir, "hed")
    kw = dict(drop_rate=drop_rate, random_cropping=random_cropping, resolution=resolution)
    ours, ref = datasets.MultiGen20M(*args, **kw), jax_datasets.MultiGen20M(*args, **kw)
    assert len(ours) == len(ref) == 6 and ours.key == ref.key == "control_hed"
    for i in range(len(ours)):
        for seed in range(3):
            a = ours.get(i, np.random.default_rng((seed, i)))
            b = ref.get(i, np.random.default_rng((seed, i)))
            assert a.keys() == b.keys() and a["txt"] == b["txt"] and a["task"] == b["task"]
            for k in ("jpg", "hint"):
                assert a[k].shape == (resolution, resolution, 3) and a[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])
    # the skip loop: item 2 (no condition) gives item 3, item 4 (no prompt) item 5
    assert ours.get(2, np.random.default_rng(0))["txt"] in ("an image number 3", "")
    assert ours.get(4, np.random.default_rng(0))["txt"] in ("an image number 5", "")


def test_multigen_rejects_unknown_task(multigen_dir):
    with pytest.raises(ValueError, match="unknown multigen task"):
        datasets.MultiGen20M(os.path.join(multigen_dir, "hed.json"), multigen_dir, "lineart")
    assert datasets.MULTIGEN_TASK_KEYS == jax_datasets.MULTIGEN_TASK_KEYS


# ---------------------------------------------------------------------------
# the native image prep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def custom_dir(tmp_path_factory):
    """Four pairs: square up- and down-scaled, landscape and portrait."""
    root = tmp_path_factory.mktemp("custom")
    (root / "source").mkdir()
    (root / "target").mkdir()
    rng = np.random.default_rng(4)
    with open(root / "prompt.json", "w") as f:
        for i, shape in enumerate([(20, 20), (48, 48), (40, 56), (56, 40)]):
            cv2.imwrite(str(root / "source" / f"{i}.png"), rng.integers(0, 256, (*shape, 3),
                                                                        np.uint8))
            cv2.imwrite(str(root / "target" / f"{i}.png"), rng.integers(0, 256, (*shape, 3),
                                                                        np.uint8))
            f.write(json.dumps({"source": f"source/{i}.png", "target": f"target/{i}.png",
                                "prompt": f"pair {i}"}) + "\n")
    return str(root)


def test_native_custom_dataset_matches_jax_native(custom_dir, monkeypatch):
    """The JAX package's native branch and ctypes binding run on the library
    the port built (the same source and flags as native/Makefile), so no
    second build races the JAX tests' `make -C native`."""
    native.lib()
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(native.library_path()))
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setenv("CTRLORA_NATIVE_DATA", "1")
    ours = datasets.CustomDataset(custom_dir, drop_rate=0.5, resolution=32)
    ref = jax_datasets.CustomDataset(custom_dir, drop_rate=0.5, resolution=32)
    for i in range(len(ours)):
        a, b = ours.get(i, np.random.default_rng(i)), ref.get(i, np.random.default_rng(i))
        assert a.keys() == b.keys() and a["txt"] == b["txt"]
        for k in ("jpg", "hint"):
            assert a[k].shape == (32, 32, 3) and a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    # the port's library lives in its own build directory, keyed on the source
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and native.library_path().exists()
    assert native.version() == 1


def test_native_batch_equals_single(custom_dir):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (30 + i, 40 - i, 3), np.uint8) for i in range(5)]
    crops = [(i, 0, 24, 30) for i in range(5)]
    batch = native.batch_resize_norm(imgs, crops, (16, 20), 1 / 255.0, 0.0)
    assert batch.shape == (5, 16, 20, 3)
    for img, crop, got in zip(imgs, crops, batch):
        np.testing.assert_array_equal(got, native.resize_norm(img, crop, (16, 20), 1 / 255.0,
                                                              0.0))


def test_native_rejects_boxes_outside_the_image():
    img = np.zeros((20, 30, 3), np.uint8)
    for crop in [(0, 0, 21, 30), (5, 5, 10, 26), (-1, 0, 5, 5), (0, 0, 0, 5)]:
        with pytest.raises(ValueError, match="crop"):
            native.resize_norm(img, crop, (8, 8), 1.0, 0.0)
    with pytest.raises(ValueError, match="uint8"):
        native.resize_norm(np.zeros((20, 30), np.uint8), (0, 0, 5, 5), (8, 8), 1.0, 0.0)


def test_native_builds_once_under_threads(tmp_path, monkeypatch):
    """The loader's threads reach the first build together: one library is
    built and loaded, and every thread gets it."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            libs = list(pool.map(lambda _: native.lib(), range(32), timeout=300))
    finally:
        sys.setswitchinterval(interval)
    assert all(lib is libs[0] for lib in libs)
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [
        native.library_path().name]


def test_native_build_failure_raises(custom_dir, tmp_path, monkeypatch):
    """With CTRLORA_NATIVE_DATA set and no compiler, get raises; nothing falls
    back to cv2."""
    monkeypatch.setenv("CTRLORA_NATIVE_DATA", "1")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    ds = datasets.CustomDataset(custom_dir, resolution=32)
    with pytest.raises(RuntimeError, match="native image prep"):
        ds.get(0, np.random.default_rng(0))
    assert not (tmp_path / "_build").exists() or not any((tmp_path / "_build").iterdir())
