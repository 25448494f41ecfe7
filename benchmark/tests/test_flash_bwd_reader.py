"""The reader of ``flash_bwd_roofline.train`` on the CPU: its census of the
flash backward's calls equals the calls a traced training step of the
program makes (a tiny cell in bf16 at a size the kernel's rule admits, where
the CPU takes the kernels' plain versions through the same autograd
Functions), its frozen dispatch rule is the program's, and it reads the
census's least time over the device time of the kernels by name."""

import json
import os

import pytest

from benchmark import readers, run, trace, work
from benchmark.spec import Spec

NAME = "flash_bwd_roofline.train"
FULL_STEP = {(16, 8, 4096, 4096, 40, 2): 5, (16, 8, 1024, 1024, 80, 2): 5,
             (16, 8, 256, 256, 160, 2): 5}


@pytest.fixture
def bf16_root(tiny_root):
    """The tiny training cell with bf16 towers taking the flash entries, at
    64^2: its 16x16 latent levels hold 256 tokens at D = 32."""
    path = os.path.join(tiny_root, "tb", "configs", "tiny_train.json")
    with open(path) as f:
        cfg = json.load(f)
    for section in (cfg["model"]["unet"], cfg["model"]["control"]["unet"]):
        section.update(dtype="bfloat16", use_flash_attention=True)
    with open(path, "w") as f:
        json.dump(cfg, f)
    path = os.path.join(tiny_root, "tb", "traffic", "tiny_train.json")
    with open(path) as f:
        traffic = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(traffic, resolution=64), f)
    return tiny_root


def test_the_census_is_the_steps_calls(bf16_root):
    spec = Spec(bf16_root)
    w = spec.workload("tiny.train")
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    cell = spec.driver(traffic["kind"]).Cell(cfg, traffic, 2 ** 31 + 3, "cpu")
    cell.setup()
    tr, units = cell.traced()
    seen = {shape: calls / units["steps"] for shape, calls, _ in tr.spans_of("attn_bwd")}
    want = spec.reader(NAME).census(cfg["model"], cfg["train"], traffic)
    assert want and seen == want
    # the control's input block and middle, the UNet's two decoder blocks; the
    # UNet's middle attention runs before the control's taps join, with no gradient
    assert sum(want.values()) == 4


def test_the_full_cell_census():
    spec = Spec()
    w = spec.workload("finetune.b16")
    cfg = spec.config(w["config"])
    assert spec.reader(NAME).census(cfg["model"], cfg["train"],
                                    spec.traffic(w["traffic"])) == FULL_STEP


@pytest.mark.parametrize("d", [8, 16, 32, 40, 64, 80, 128, 160, 512])
def test_the_frozen_rule_is_the_programs(d):
    import torch

    from ctrlora_tpu_torch.ops import flash_attention as fa

    reader = Spec().reader(NAME)
    for bf16 in (True, False):
        dtypes = (torch.bfloat16 if bf16 else torch.float32,) * 3
        for sq in (64, 77, 128, 256, 384, 1024, 4096):
            for sk in (64, 77, 128, 256, 384, 1024, 4096):
                assert reader.takes_kernel(bf16, sq, sk, d) == fa.flash_kernel_ok(
                    dtypes, sq, sk, d, grad=True), (bf16, sq, sk, d)


def _trace(op_seconds):
    return trace.Trace(1.0, 0.5, len(op_seconds), {}, op_seconds, [])


def test_reads_the_kernels_by_name():
    reader = Spec().reader(NAME)
    least = sum(n * work.least_seconds(*readers.WORK["attn_bwd"](*shape))
                for shape, n in FULL_STEP.items())
    ops = {"void ctrlora::(anonymous namespace)::flash_bwd<40, false>(CUtensorMap_st)": 0.02,
           "_ZN7ctrlora12_GLOBAL__N_19flash_bwdILi40ELb1EEEv14CUtensorMap_st": 0.03,
           "void ctrlora::(anonymous namespace)::flash_fwd_wgmma<40>(CUtensorMap_st)": 0.5,
           "void at::native::reduce_kernel<512, 1>(float)": 0.25}
    ctx = run.Context("finetune.b16", "train", _trace(ops), {"steps": 4}, 0.0)
    assert reader.read(ctx) == pytest.approx(100.0 * 4 * least / 0.05)
    assert reader.read(run.Context("finetune.b16", "sample", _trace(ops), {"steps": 4},
                                   0.0)) is None
    no_kernel = {k: v for k, v in ops.items() if "flash_bwd" not in k}
    assert reader.read(run.Context("finetune.b16", "train", _trace(no_kernel), {"steps": 4},
                                   0.0)) is None
