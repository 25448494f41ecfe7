"""The yardstick's frozen copies agree today with the program's originals:
the kernels' work counts at the cells' shapes, and the FLOP counter on the
reference and on the program at full width (meta tensors)."""

import pytest
import torch

from benchmark import common, work
from benchmark.flops import fn_flops
from benchmark.reference.diffusion import Reference
from benchmark.reference.sd15 import nchw
from benchmark.spec import Spec

# (b, h, sq, sk, d) the cells' attention calls take: sampling at CFG batch 16
# (the UNet's and ControlNet's sites, the 77-token cross-attention, the VAE's
# single head), training at batch 16
ATTN = [(16, 8, 4096, 4096, 40), (16, 8, 1024, 1024, 80), (16, 8, 256, 256, 160),
        (16, 8, 64, 64, 160), (16, 8, 4096, 77, 40), (16, 8, 1024, 77, 80),
        (16, 8, 256, 77, 160), (8, 1, 4096, 4096, 512)]
GEGLU = [(16 * 4096, 320, 1280), (16 * 1024, 640, 2560), (16 * 256, 1280, 5120),
         (16 * 64, 1280, 5120)]


@pytest.mark.parametrize("shape", ATTN)
def test_attention_work_counts(shape):
    from ctrlora_tpu_torch.ops import flash_attention as fa

    for isz in (2, 4):
        assert work.flash_forward_work(*shape, isz) == fa.flash_forward_work(*shape, isz)
        assert work.flash_bwd_dq_work(*shape, isz) == fa.flash_bwd_dq_work(*shape, isz)
        assert work.flash_bwd_dkv_work(*shape, isz) == fa.flash_bwd_dkv_work(*shape, isz)


@pytest.mark.parametrize("shape", GEGLU)
def test_geglu_work_counts(shape):
    from ctrlora_tpu_torch.ops import geglu_ffn as gg

    assert work.geglu_ffn_work(*shape) == gg.geglu_ffn_work(*shape)
    assert work.geglu_ffn_work(*shape, 4, 4) == gg.geglu_ffn_work(*shape, 4, 4)


def test_flop_counter_agrees_with_the_programs_at_full_width():
    """One guided model call at CFG batch 16 and 512^2: the frozen counter
    and the program's count the reference alike, and the reference's
    products are the program's."""
    from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline
    from ctrlora_tpu_torch.utils.flops import fn_flops as program_fn_flops

    cfg = Spec().config("ctrlora_sd15_1lora_r128")
    model_cfg = common.port_config(cfg["model"])
    meta = torch.device("meta")
    pipe = CtrLoraPipeline(model_cfg, meta)
    shapes = {"unet": common.shapes_of(pipe.unet),
              "control": common.unfused_control_shapes(model_cfg),
              "vae": common.shapes_of(pipe.vae), "clip": common.shapes_of(pipe.clip)}
    raw = {k: {n: torch.empty(s, device=meta) for n, s in v.items()} for k, v in shapes.items()}
    ref = Reference(cfg["model"], raw, fuse=True)
    x = torch.empty((16, 64, 64, 4), device=meta)
    ctx = torch.empty((16, 77, 768), device=meta)
    t = torch.zeros((16,), dtype=torch.int32, device=meta)
    call = lambda: ref.unet.controlled(nchw(x), t.long(), ctx, nchw(x))
    frozen = fn_flops(call)
    assert frozen == program_fn_flops(call)
    assert frozen == program_fn_flops(lambda: pipe.apply_model(x, t, ctx, [Conditioning(x)]))
    assert 17.0e12 < frozen < 17.3e12
