"""Share of its roofline that the flash backward kernels reach in the traced
training window, read by kernel name: the least time of the calls of dQ and
dK/dV (kernels B4 and B5, ``flash_bwd<D, DKV>`` in
``ctrlora_tpu_torch/csrc/flash_attention_bwd.cu``) that the traced steps
make, over the device time of the kernels of that name.

It needs no host range around the calls, so a step that replays a CUDA
graph, in which no Python runs, reads as an eager step does. The calls
come from the cell's configuration and traffic (:func:`census`): the
benchmark's plain reference runs one step's loss on ``meta`` tensors with
the program's weight shapes, and each attention through which a gradient
flows is counted where the program's dispatch rule, frozen below, gives it
the kernel. Their operations and bytes are ``benchmark/work.py``'s.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Optional, Tuple

UNIT, LAYER, MOVES = "%", "kernels (ops/, csrc/)", "train_images_per_s"

# the kernels' names, demangled (flash_bwd<40, false>) or not (flash_bwdILi40ELb0E)
KERNEL = re.compile(r"flash_bwd(<|ILi)")
# ``flash_kernel_ok`` of ctrlora_tpu_torch/ops/flash_attention.py at commit 7efd203,
# where a gradient flows: bf16 operands, the backward kernels' head dims, Sk >= 256
# and both sequences tiling by 128
BWD_HEAD_DIMS = (8, 16, 32, 40, 80, 160)
MIN_SK, SEQ_TILE, ITEMSIZE = 256, 128, 2


def takes_kernel(bf16: bool, sq: int, sk: int, d: int) -> bool:
    return (bf16 and d in BWD_HEAD_DIMS and sk >= MIN_SK
            and all(s >= SEQ_TILE and s % SEQ_TILE == 0 for s in (sq, sk)))


def census(model: dict, train: dict, traffic: dict) -> Dict[Tuple[int, ...], int]:
    """{(b, h, sq, sk, d, itemsize): calls} of the flash backward in one
    training step of the cell: the attentions of the reference's step whose
    q, k or v carries a gradient (the trainable control leaves as the
    training driver names them) and that the kernel takes."""
    import torch

    from benchmark import common
    from benchmark.drivers.train import trains
    from benchmark.reference.diffusion import Reference, eps_mse_loss
    from ctrlora_tpu_torch.pipeline import CtrLoraPipeline

    meta = torch.device("meta")
    pipe = CtrLoraPipeline(common.port_config(model), meta, fuse_lora=False)
    raw = {k: {n: torch.empty(s, device=meta)
               for n, s in common.shapes_of(getattr(pipe, k)).items()}
           for k in ("unet", "control", "vae", "clip")}
    for n, p in raw["control"].items():
        p.requires_grad_(trains(n, train))
    ref = Reference(model, raw)
    calls: Counter = Counter()
    for tower, section in ((ref.unet.unet, model["unet"]),
                           (ref.unet.control, model["control"]["unet"])):
        bf16 = section["dtype"] == "bfloat16" and section["use_flash_attention"]

        def attention(q, k, v, mask=None, scale=None, _real=tower.attention, _bf16=bf16):
            b, h, sq, d = q.shape
            sk = k.shape[2]
            grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
            if grad and takes_kernel(_bf16, sq, sk, d):
                calls[(b, h, sq, sk, d, ITEMSIZE)] += 1
            return _real(q, k, v, mask, scale)

        tower.attention = attention
    b, r = traffic["batch"], traffic["resolution"]
    f = 2 ** (len(model["vae"]["ch_mult"]) - 1)
    latent = (b, r // f, r // f, model["vae"]["embed_dim"])
    batch = {"jpg": torch.empty((b, r, r, 3), device=meta),
             "hint": torch.empty((b, r, r, 3), device=meta),
             "token_ids": torch.zeros((b, model["clip"]["max_length"]), dtype=torch.long,
                                      device=meta)}
    draws = {k: torch.empty(latent, device=meta) for k in ("z_eps", "hint_eps", "noise")}
    draws["t"] = torch.zeros((b,), dtype=torch.long, device=meta)
    eps_mse_loss(ref, batch, draws)
    return dict(calls)


def read(ctx, spec=None) -> Optional[float]:
    """`spec`: the benchmark whose cell ``ctx.workload`` is (the repo's by
    default). None outside training and where no such kernel ran."""
    if ctx.kind != "train":
        return None
    device_s = sum(s for name, s in ctx.trace.op_seconds.items() if KERNEL.search(name))
    if device_s <= 0.0:
        return None
    from benchmark import readers, work
    from benchmark.spec import Spec

    spec = spec or Spec()
    cell = spec.workload(ctx.workload)
    cfg = spec.config(cell["config"])
    per_step = census(cfg["model"], cfg["train"], spec.traffic(cell["traffic"]))
    least = sum(n * work.least_seconds(*readers.WORK["attn_bwd"](*shape))
                for shape, n in per_step.items())
    return 100.0 * ctx.steps * least / device_s
