"""Kernel A's launch plan on the CPU (no GPU, nvcc or Triton).

``group_norm_plan`` mirrors the cluster size, slab and path that
``csrc/group_norm.cu`` chooses (chip_smoke.py holds the two against each
other on the card). Here it is checked at every GroupNorm shape of the three
paths, the VAE and ControlNet-XS (its 64/128/256-channel control stream and
the 384/768/1536 channels of its `cat` infusion), read off the models
themselves: a forward on the meta
device records each GroupNorm's input (the app's one-sample path too: the
UNet at the CFG batch of 2, the VAE at one sample). At each shape, in bf16 and fp32:
each slab holds whole groups and a run of >= 128 contiguous bytes (or the
whole row), the block's shared memory stays within the H100's 232,448 bytes,
a cluster has at most 8 blocks, the blocks' rows cover the sample, and the
staged / re-read choice follows the bytes. At the sampling batch (8) and the
finetune batch (4) the grid covers >= 128 of the 132 SMs at the 64^2 and
32^2 UNet sites.
"""

import dataclasses
from unittest import mock

import pytest
import torch

from ctrlora_tpu_torch import configs
from ctrlora_tpu_torch.models.unet import UNet
from ctrlora_tpu_torch.models.vae import AutoencoderKL
from ctrlora_tpu_torch.models.xs import XSUNet
from ctrlora_tpu_torch.ops import group_norm as gn

H100_SMEM = 232448
SMS = 132
ITEMSIZES = (2, 4)  # bf16, fp32


def _recorded_shapes(run):
    """(B, HW, C, groups, has_row) of every GroupNorm that run() reaches."""
    seen = []

    def record(x, scale, bias, num_groups=32, eps=1e-5, silu=False, add_row=None):
        seen.append((x.shape[0], x.numel() // (x.shape[0] * x.shape[-1]), x.shape[-1],
                     num_groups, add_row is not None))
        return torch.empty_like(x)

    with torch.device("meta"), mock.patch.object(gn, "group_norm", record):
        run()
    return sorted(set(seen))


@pytest.fixture(scope="module")
def path_shapes():
    """GroupNorm shapes by path: the UNet (the ControlNet repeats its
    encoder's) at the sampling CFG batch of 8 and the finetune batch of 4 on
    64^2 latents, and the VAE encoding 512^2 images and decoding 64^2
    latents at batch 4 and (phase 4's fp32 decode) 1; ControlNet-XS's two
    streams at the sampling and training batches (8 and 4)."""
    cfg = configs.ctrlora_inference_config(lora_num=1, lora_rank=128)
    ucfg = dataclasses.replace(cfg.unet, dtype="float32", use_flash_attention=False)
    vcfg = dataclasses.replace(cfg.vae, dtype="float32")

    def unet(b):
        def run():
            UNet(ucfg)(torch.empty(b, 64, 64, 4), torch.zeros(b, dtype=torch.int32),
                       torch.empty(b, 77, ucfg.context_dim))
        return run

    def vae():
        model = AutoencoderKL(vcfg)
        model.encode(torch.empty(4, 512, 512, 3))
        for b in (4, 1):
            model.decode(torch.empty(b, 64, 64, 4))

    def xs():
        model = XSUNet(ucfg)
        for b in (8, 4):
            model(torch.empty(b, 64, 64, 4), torch.zeros(b, dtype=torch.int32),
                  torch.empty(b, 77, ucfg.context_dim), hint=torch.empty(b, 512, 512, 3))

    def app_vae():  # one sample: the hint's encode and the decode
        model = AutoencoderKL(vcfg)
        model.encode(torch.empty(1, 512, 512, 3))
        model.decode(torch.empty(1, 64, 64, 4))

    return {"sampling": _recorded_shapes(unet(8)), "finetune": _recorded_shapes(unet(4)),
            "vae": _recorded_shapes(vae), "xs": _recorded_shapes(xs),
            "app": _recorded_shapes(unet(2)) + _recorded_shapes(app_vae)}


def test_the_paths_reach_the_decoder_concat_widths(path_shapes):
    sampling = {(hw, c) for _, hw, c, _, _ in path_shapes["sampling"]}
    for site in ((64 * 64, 640), (64 * 64, 960), (32 * 32, 1920), (16 * 16, 1920),
                 (16 * 16, 2560), (8 * 8, 2560)):
        assert site in sampling
    assert (512 * 512, 128) in {(hw, c) for _, hw, c, _, _ in path_shapes["vae"]}


def test_xs_reaches_its_control_widths(path_shapes):
    widths = {c for _, _, c, _, _ in path_shapes["xs"]}
    assert {64, 128, 256, 384, 768, 1536} <= widths
    assert {(64 * 64, 384), (32 * 32, 768), (16 * 16, 1536), (8 * 8, 1536)} <= {
        (hw, c) for _, hw, c, _, _ in path_shapes["xs"]}


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("path", ["sampling", "finetune", "vae", "xs", "app"])
def test_slabs_hold_whole_groups(path_shapes, path, itemsize):
    for b, hw, c, groups, _ in path_shapes[path]:
        plan = gn.group_norm_plan(b, hw, c, groups, itemsize, SMS)
        cpg = c // groups
        assert plan.slab == plan.groups * cpg and plan.slabs * plan.groups == groups
        assert plan.slab * plan.slabs == c
        slab_bytes = plan.slab * itemsize
        assert slab_bytes >= 128 or plan.slab == c
        # the fewest such groups: the next smaller divisor of the groups
        # would make a run under 128 bytes
        smaller = [d for d in range(1, plan.groups) if groups % d == 0]
        assert not smaller or smaller[-1] * cpg * itemsize < 128
        assert slab_bytes % gn.GN_VEC_BYTES == 0


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("path", ["sampling", "finetune", "vae", "xs", "app"])
def test_cluster_and_shared_memory_fit_the_card(path_shapes, path, itemsize):
    for b, hw, c, groups, _ in path_shapes[path]:
        plan = gn.group_norm_plan(b, hw, c, groups, itemsize, SMS)
        assert plan.cluster in (1, 2, 4, gn.GN_MAX_CLUSTER) and plan.cluster <= 8
        assert plan.smem <= H100_SMEM
        # the cluster's blocks own every row once, none idle but the last
        assert plan.cluster * plan.rows >= hw > (plan.cluster - 1) * plan.rows


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("path", ["sampling", "finetune", "vae", "xs", "app"])
def test_staged_or_reread_follows_the_bytes(path_shapes, path, itemsize):
    """Staged: the block's rows of the slab sit in its shared memory. Re-read:
    not even a cluster of 8 would fit them, and the ring of chunks does."""
    for b, hw, c, groups, _ in path_shapes[path]:
        plan = gn.group_norm_plan(b, hw, c, groups, itemsize, SMS)
        sb = plan.slab * itemsize
        if plan.staged:
            assert plan.smem >= plan.rows * sb
        else:
            ring = 4 * plan.chunk_rows * sb
            fixed = plan.smem - gn._round16(ring)
            assert -(-hw // gn.GN_MAX_CLUSTER) * sb + fixed > H100_SMEM
            assert plan.chunk_rows * sb <= 2 * 16384


@pytest.mark.parametrize("path, batch", [("sampling", 8), ("finetune", 4)])
def test_grid_covers_the_sms_at_the_unet_sites(path_shapes, path, batch):
    sites = [s for s in path_shapes[path] if s[1] in (64 * 64, 32 * 32)]
    assert sites and all(b == batch for b, *_ in sites)
    for b, hw, c, groups, _ in sites:
        plan = gn.group_norm_plan(b, hw, c, groups, 2, SMS)
        assert plan.blocks(b) >= 128, (b, hw, c, plan)


def test_app_batch_fills_half_the_card_at_320_channels(path_shapes):
    """The app's CFG batch of 2: the 320-channel sites (64^2 and the 32^2
    decoder's) make 64 blocks (2 samples x 4 slabs of 8 groups x a cluster
    of 8), under half the 132 SMs; every other UNet site 128. The VAE at
    one sample and 512^2 x 128 re-reads with 16 blocks."""
    blocks = {(b, hw, c): gn.group_norm_plan(b, hw, c, groups, 2, SMS).blocks(b)
              for b, hw, c, groups, _ in path_shapes["app"]}
    assert blocks[(2, 64 * 64, 320)] == blocks[(2, 32 * 32, 320)] == 64
    assert all(n == (64 if c == 320 else 128) for (b, hw, c), n in blocks.items() if b == 2)
    assert blocks[(1, 512 * 512, 128)] == 16
    assert not gn.group_norm_plan(1, 512 * 512, 128, 32, 2, SMS).staged


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        gn.group_norm_plan(2, 64, 4, 2, 2, SMS)  # an 8-byte bf16 row
    with pytest.raises(ValueError):
        gn.group_norm_plan(2, 64, 48, 32, 2, SMS)  # 48 channels in 32 groups
    assert len(gn.group_norm_plan(8, 4096, 320, 32, 2, SMS).as_list()) == 8


def test_non_cuda_device_raises_before_any_launch():
    """A tensor on neither the CPU nor the card raises; the CPU tensor takes
    the plain version (tests/test_torch_ops.py holds it against JAX)."""
    x = torch.empty(2, 8, 8, 64, device="meta")
    with pytest.raises(ValueError):
        gn.group_norm(x, torch.ones(64, device="meta"), torch.zeros(64, device="meta"), 32)
