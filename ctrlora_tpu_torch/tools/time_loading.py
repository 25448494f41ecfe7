"""Time the reference-file loader (``utils.loading.load_ctrlora``) at SD1.5
width on the card:

    env PYTHONPATH=. python3 ctrlora_tpu_torch/tools/time_loading.py --write --files DIR
    env PYTHONPATH=<tree> python3 ctrlora_tpu_torch/tools/time_loading.py LABEL --files DIR
        [--json OUT]

``--write`` writes the files into DIR with ``chip_smoke.write_finetune_files``
(the SD file's UNet, VAE and CLIP, a Base ControlNet and one rank-128 LoRA,
all fp16, of a seeded ``ctrlora_finetune_config(128)`` pipeline) and their
paths into DIR/paths.json. A timed run loads with whichever
``ctrlora_tpu_torch`` is first on the path, so one tree's copy of this tool
can time another tree's loader: two trees in turns in one call, on the same
files. Each run builds that pipeline unfused on the card and times, each
reading ended by a synchronise: ``torch.load`` of the SD file alone;
``load_ctrlora(sd, basecn, basecn_skip="lora")`` and the pipeline's
``load_state_dicts`` (what the training CLIs and the sample CLI do); and
``load_ctrlora`` with the LoRA file too (what ``api.create_model`` reads).
One JSON line a run, with a blake2b digest of each loaded state dict
(keys and bytes in key order), so that two trees' loads can be held equal.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_loading: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    files = argv[argv.index("--files") + 1]
    listing = os.path.join(files, "paths.json")
    if "--write" in argv:
        import chip_smoke

        paths = chip_smoke.write_finetune_files(dev, files)
        with open(listing, "w") as f:
            json.dump(paths, f)
        return 0

    from ctrlora_tpu_torch import configs
    from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
    from ctrlora_tpu_torch.utils.loading import load_ctrlora

    with open(listing) as f:
        paths = json.load(f)
    cfg = configs.ctrlora_finetune_config(lora_rank=128)

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def build():
        torch.manual_seed(0)
        return CtrLoraPipeline(cfg, dev, fuse_lora=False)

    row = {"tree": argv[0] if argv and not argv[0].startswith("--") else "tree",
           "file_gb": {k: os.path.getsize(paths[k]) / 2 ** 30 for k in ("sd", "basecn")}}
    pipe, row["build_pipeline_s"] = clock(build)
    _, row["torch_load_sd_s"] = clock(lambda: torch.load(paths["sd"], map_location="cpu",
                                                         weights_only=False))
    states, row["load_ctrlora_s"] = clock(
        lambda: load_ctrlora(pipe, paths["sd"], paths["basecn"], basecn_skip="lora"))
    _, row["load_state_dicts_s"] = clock(lambda: pipe.load_state_dicts(*states))
    row["digest"] = {}
    for name, state in zip(("unet", "control", "vae", "clip"), states):
        h = hashlib.blake2b(digest_size=16)
        for key in sorted(state):
            h.update(key.encode())
            h.update(state[key].contiguous().numpy().tobytes())
        row["digest"][name] = h.hexdigest()
    del states
    with_lora, row["load_ctrlora_with_lora_s"] = clock(
        lambda: load_ctrlora(pipe, paths["sd"], paths["basecn"], paths["loras"]))
    row["lora_keys_nonzero"] = sum(bool(v.any()) for k, v in with_lora.control.items()
                                   if "lora_up" in k)
    del with_lora
    row["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(row)
    print(line, flush=True)
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
