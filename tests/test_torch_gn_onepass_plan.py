"""Kernel A2's launch plan on the CPU (no GPU or nvcc).

``group_norm_onepass_plan`` mirrors the plan ``csrc/group_norm.cu`` chooses
for the one-pass GroupNorm (chip_smoke.py's build phase holds the two
against each other on the card). Here it is checked at every GroupNorm shape
of the three paths that ``gn1=1`` admits (``_onepass_ok``), read off the
models themselves: a forward on the meta device records each GroupNorm's
input. At the sampling batch (8) and the finetune batch (4), in bf16 and in
fp32 where admitted, the plan always stages (x read once), keeps a block's
shared memory within the H100's 232,448 bytes, uses clusters of at most 16
blocks whose rows cover the sample, gives each slab whole groups and runs
of >= 128 contiguous bytes, and fits the grid in one wave by its own rule.
"""

import dataclasses
from unittest import mock

import pytest
import torch

from ctrlora_tpu_torch import configs
from ctrlora_tpu_torch.models.unet import UNet
from ctrlora_tpu_torch.models.vae import AutoencoderKL
from ctrlora_tpu_torch.ops import group_norm as gn
from ctrlora_tpu_torch.ops import kernel_flags

H100_SMEM = 232448
SMS = 132
DTYPES = (torch.bfloat16, torch.float32)


def _recorded_samples(run):
    """(HW, C, groups) of every GroupNorm that run() reaches."""
    seen = []

    def record(x, scale, bias, num_groups=32, eps=1e-5, silu=False, add_row=None):
        seen.append((x.numel() // (x.shape[0] * x.shape[-1]), x.shape[-1], num_groups))
        return torch.empty_like(x)

    with torch.device("meta"), mock.patch.object(gn, "group_norm", record):
        run()
    return set(seen)


@pytest.fixture(scope="module")
def admitted():
    """(HW, C, groups, dtype) of every GroupNorm of the UNet (the
    ControlNet repeats its encoder's) on 64^2 latents and of the VAE at
    512^2 that gn1=1 sends to A2."""
    cfg = configs.ctrlora_inference_config(lora_num=1, lora_rank=128)
    ucfg = dataclasses.replace(cfg.unet, dtype="float32", use_flash_attention=False)

    def run():
        UNet(ucfg)(torch.empty(2, 64, 64, 4), torch.zeros(2, dtype=torch.int32),
                   torch.empty(2, 77, ucfg.context_dim))
        vae = AutoencoderKL(dataclasses.replace(cfg.vae, dtype="float32"))
        vae.encode(torch.empty(1, 512, 512, 3))
        vae.decode(torch.empty(1, 64, 64, 4))

    samples = _recorded_samples(run)
    with kernel_flags.override(gn_onepass=True):
        return sorted(((hw, c, g, dt) for hw, c, g in samples for dt in DTYPES
                       if gn._onepass_ok(hw, c, dt, g)), key=lambda s: (*s[:3], s[3].itemsize))


def test_gn1_admits_the_five_sampling_shapes(admitted):
    bf16 = {(hw, c) for hw, c, _, dt in admitted if dt == torch.bfloat16}
    assert bf16 == {(64 * 64, 320), (32 * 32, 640), (32 * 32, 960), (32 * 32, 1280),
                    (16 * 16, 2560)}
    fp32 = {(hw, c) for hw, c, _, dt in admitted if dt == torch.float32}
    assert fp32 == {(32 * 32, 640), (16 * 16, 2560)}


@pytest.mark.parametrize("batch", [8, 4])
def test_always_staged_within_the_card(admitted, batch):
    for hw, c, groups, dt in admitted:
        plan = gn.group_norm_onepass_plan(batch, hw, c, groups, dt.itemsize, SMS)
        assert plan.staged, (batch, hw, c, dt, plan)
        assert plan.smem <= H100_SMEM
        assert plan.smem >= plan.rows * plan.slab * dt.itemsize
        assert 1 <= plan.cluster <= gn.GN_ONEPASS_MAX_CLUSTER == 16


@pytest.mark.parametrize("batch", [8, 4])
def test_blocks_cover_the_sample(admitted, batch):
    """Every row of every slab belongs to one block of its cluster, none
    idle but the last, and the slabs tile the row."""
    for hw, c, groups, dt in admitted:
        plan = gn.group_norm_onepass_plan(batch, hw, c, groups, dt.itemsize, SMS)
        assert plan.cluster * plan.rows >= hw > (plan.cluster - 1) * plan.rows
        assert plan.slab * plan.slabs == c
        assert plan.blocks(batch) == batch * plan.slabs * plan.cluster


@pytest.mark.parametrize("batch", [8, 4])
def test_slabs_hold_whole_groups_and_long_runs(admitted, batch):
    for hw, c, groups, dt in admitted:
        plan = gn.group_norm_onepass_plan(batch, hw, c, groups, dt.itemsize, SMS)
        assert plan.slab == plan.groups * (c // groups) and groups % plan.groups == 0
        run = plan.slab * dt.itemsize
        assert run >= 128 or plan.slab == c
        assert run % gn.GN_VEC_BYTES == 0 and run // gn.GN_VEC_BYTES <= gn.GN_THREADS


@pytest.mark.parametrize("batch", [8, 4])
def test_grid_fits_one_wave(admitted, batch):
    """Two blocks a SM where the rows fit half an SM, else one; the grid
    within that (7/8 of it for clusters of 3 or more blocks)."""
    for hw, c, groups, dt in admitted:
        plan = gn.group_norm_onepass_plan(batch, hw, c, groups, dt.itemsize, SMS)
        per_sm = 2 if plan.smem <= 233472 // 2 - 1024 else 1
        cap = per_sm * SMS if plan.cluster <= 2 else per_sm * SMS * 7 // 8
        assert plan.blocks(batch) <= cap, (batch, hw, c, dt, plan)


def test_the_64sq_site_is_one_wave_where_kernel_a_takes_two():
    """At [8, 64^2, 320] bf16 kernel A's 32 clusters of 4 exceed the 30 the
    H100 holds at once; A2 takes clusters of 7 blocks, two a SM."""
    a = gn.group_norm_plan(8, 4096, 320, 32, 2, SMS)
    a2 = gn.group_norm_onepass_plan(8, 4096, 320, 32, 2, SMS)
    assert (a.cluster, a.blocks(8)) == (4, 128)
    assert (a2.cluster, a2.blocks(8), a2.slab) == (7, 224, a.slab)
    assert a2.smem <= 233472 // 2 - 1024


def test_plan_raises_over_3_mib_and_where_nothing_stages():
    with pytest.raises(ValueError, match="at most"):
        gn.group_norm_onepass_plan(8, 64 * 64, 640, 32, 2, SMS)  # 5 MiB bf16
    with pytest.raises(ValueError):
        gn.group_norm_onepass_plan(8, 64 * 64, 320, 32, 4, SMS)  # 5 MiB fp32
    with pytest.raises(ValueError):
        gn.group_norm_onepass_plan(2, 64, 48, 32, 2, SMS)  # 48 channels in 32 groups
    with pytest.raises(ValueError, match="no staged plan"):
        # 8-byte rows: not a whole number of 16-byte copies
        gn.group_norm_onepass_plan(1, 3 << 17, 4, 1, 2, SMS)
    assert len(gn.group_norm_onepass_plan(8, 4096, 320, 32, 2, SMS).as_list()) == 8


def test_cpu_tensor_takes_the_plain_version():
    rng = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 8, 64, generator=rng)
    scale, bias, row = (torch.randn(64, generator=rng) for _ in range(3))
    gn.group_norm_onepass.launches = 0
    got = gn.group_norm_onepass(x, scale, bias, 32, 1e-5, True, row)
    assert gn.group_norm_onepass.launches == 0
    torch.testing.assert_close(got, gn.group_norm_plain(x, scale, bias, 32, 1e-5, True, row),
                               rtol=0, atol=0)


def test_non_cuda_device_raises_before_any_launch():
    x = torch.empty(8, 64, 64, 320, device="meta")
    with pytest.raises(ValueError):
        gn.group_norm_onepass(x, torch.ones(320, device="meta"),
                              torch.zeros(320, device="meta"), 32)
