"""Share of its roofline that the flash forward reaches at D = 64 in the
traced SDXL sampling window, read by kernel name: the least time of the
calls of kernel B (``flash_fwd_wgmma<64>`` in
``ctrlora_tpu_torch/csrc/flash_attention.cu``) that the traced requests
make, over the device time of the kernels of that name.

It needs no host range around the calls, so a DDIM step replayed as a CUDA
graph would read as an eager one does. The calls come from the cell's
configuration and traffic (:func:`census`): the benchmark's plain reference
runs one guided model call on ``meta`` tensors with the program's weight
shapes, and each attention of head dim 64 is counted where the program's
dispatch rule, frozen below, gives it the kernel (the self-attentions at
4,096 and 1,024 tokens; the 77-key cross-attentions take the plain
version). Their operations and bytes are ``benchmark/work.py``'s.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Optional, Tuple

UNIT, LAYER, MOVES = "%", "kernels (ops/, csrc/)", "sample_images_per_s"

# the kernel's name, demangled (flash_fwd_wgmma<64>) or not (flash_fwd_wgmmaILi64E)
KERNEL = re.compile(r"flash_fwd_wgmma(<|ILi)64(>|E)")
HEAD_DIM = 64
# ``flash_kernel_ok`` of ctrlora_tpu_torch/ops/flash_attention.py at commit 655cb34,
# without a gradient: bf16 operands, the forward kernel's head dims, Sk >= 256 and
# both sequences tiling by 128
FORWARD_HEAD_DIMS = (8, 16, 32, 40, 64, 80, 128, 160, 512)
MIN_SK, SEQ_TILE, ITEMSIZE = 256, 128, 2


def takes_kernel(bf16: bool, sq: int, sk: int, d: int) -> bool:
    return (bf16 and d in FORWARD_HEAD_DIMS and sk >= MIN_SK
            and all(s >= SEQ_TILE and s % SEQ_TILE == 0 for s in (sq, sk)))


def census(model: dict, traffic: dict, head_dim: int = HEAD_DIM) -> Dict[Tuple[int, ...], int]:
    """{(b, h, sq, sk, d, itemsize): calls} of the D = 64 flash forward in
    one DDIM step of the cell: the attentions of the reference's guided
    model call (CFG batch, UNet and ControlNet) that the kernel takes."""
    import torch

    from benchmark import common
    from benchmark.reference.sdxl import SDXLReference, guided_eps_xl
    from ctrlora_tpu_torch.pipeline import CtrLoraPipeline

    meta = torch.device("meta")
    pipe = CtrLoraPipeline(common.port_config(model), meta)
    raw = {k: {n: torch.empty(s, device=meta)
               for n, s in common.shapes_of(getattr(pipe, k)).items()}
           for k in ("unet", "control", "vae", "clip", "clip2")}
    ref = SDXLReference(model, raw)
    calls: Counter = Counter()
    for tower, section in ((ref.unet.unet, model["unet"]),
                           (ref.unet.control, model["control"]["unet"])):
        bf16 = section["dtype"] == "bfloat16" and section["use_flash_attention"]

        def attention(q, k, v, mask=None, scale=None, _real=tower.attention, _bf16=bf16):
            b, h, sq, d = q.shape
            sk = k.shape[2]
            if d == head_dim and takes_kernel(_bf16, sq, sk, d):
                calls[(b, h, sq, sk, d, ITEMSIZE)] += 1
            return _real(q, k, v, mask, scale)

        tower.attention = attention
    b, r = traffic["batch"], traffic["resolution"]
    lat = r // 2 ** (len(model["vae"]["ch_mult"]) - 1)
    x = torch.empty((b, model["unet"]["in_channels"], lat, lat), device=meta)
    ctx = torch.empty((b, model["clip"]["max_length"], model["unet"]["context_dim"]),
                      device=meta)
    y = torch.empty((b, model["unet"]["adm_in_channels"]), device=meta)
    hint = torch.empty((b, 3, r, r), device=meta)
    guided_eps_xl(ref.unet, x, 981, ctx, ctx, y, y, hint, traffic["scale"],
                  traffic["strength"])
    return dict(calls)


def read(ctx, spec=None) -> Optional[float]:
    """`spec`: the benchmark whose cell ``ctx.workload`` is (the repo's by
    default). None outside SDXL sampling and where no such kernel ran."""
    if ctx.kind != "sample_sdxl":
        return None
    device_s = sum(s for name, s in ctx.trace.op_seconds.items() if KERNEL.search(name))
    if device_s <= 0.0:
        return None
    from benchmark import readers, work
    from benchmark.spec import Spec

    spec = spec or Spec()
    cell = spec.workload(ctx.workload)
    cfg = spec.config(cell["config"])
    per_step = census(cfg["model"], spec.traffic(cell["traffic"]))
    least = sum(n * work.least_seconds(*readers.WORK["attn_fwd"](*shape))
                for shape, n in per_step.items())
    return 100.0 * ctx.steps * least / device_s
