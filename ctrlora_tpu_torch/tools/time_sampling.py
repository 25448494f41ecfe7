"""Time the one-LoRA sampling slice of ``chip_smoke.py`` (phase 4) alone, a
few batches in one process (on the card):

    env PYTHONPATH=<tree> python3 ctrlora_tpu_torch/tools/time_sampling.py LABEL \
        [--batches N] [--kv-in-loop-turns] [--json OUT]

It runs the tree on the path (``<tree>``, the root of a checkout):
that tree's ``chip_smoke.build_pipeline`` and ``chip_smoke.sample`` at
SD1.5 width with seeded random weights, batch 4 at 512^2, 50 DDIM steps at
CFG 7.5, after a 2-step warm-up. So two trees alternate in one call, one
process each, and the spread between runs of one tree can be read beside
the difference between trees. One JSON line: s per batch of each timed
batch, its prep / DDIM / decode split and the CPU seconds the process
spent on it (all its threads).

With ``--kv-in-loop-turns`` (a tree whose ``chip_smoke`` has ``kv_in_loop``)
the batches take turns in one process, ABBA: the sampler as it runs (the
cross-attention k|v made once, before the loop) and the same batch with
those products in the loop, N of each, so that the order of the two does
not weigh on either; the row then has ``s_per_batch`` and
``s_per_batch_in_loop``.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_sampling: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from ctrlora_tpu_torch import configs

    label = argv[0] if argv and not argv[0].startswith("--") else "tree"
    batches = int(argv[argv.index("--batches") + 1]) if "--batches" in argv else 3
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.ctrlora_inference_config(lora_num=1, lora_rank=128)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    pipe = chip_smoke.build_pipeline(cfg, dev, gen)
    b, size = chip_smoke.BATCH, chip_smoke.SIZE
    ids = torch.randint(1, cfg.clip.vocab_size, (b, cfg.clip.max_length), generator=gen,
                        device=dev)
    hint = torch.rand((b, size, size, 3), generator=gen, device=dev) * 2 - 1
    x_T = torch.randn((b, size // 8, size // 8, 4), generator=gen, device=dev)
    args = (pipe, ids, torch.zeros_like(ids), hint, x_T)
    chip_smoke.sample(*args, steps=2)
    turns = "--kv-in-loop-turns" in argv
    runs = []
    for i in range(2 * batches if turns else batches):
        in_loop = turns and i % 4 in (1, 2)
        cpu0 = time.process_time()
        with chip_smoke.kv_in_loop(pipe) if in_loop else contextlib.nullcontext():
            split = chip_smoke.sample(*args, steps=chip_smoke.STEPS)[1]
        runs.append({"s_per_batch": sum(split.values()), "kv_in_loop": in_loop,
                     "process_cpu_s": time.process_time() - cpu0, **split})
    row = {"tree": label, "steps": chip_smoke.STEPS, "batch": b, "size": size,
           "s_per_batch": [r["s_per_batch"] for r in runs if not r["kv_in_loop"]],
           "runs": runs}
    if turns:
        row["s_per_batch_in_loop"] = [r["s_per_batch"] for r in runs if r["kv_in_loop"]]
    print(json.dumps(row), flush=True)
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(row, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
