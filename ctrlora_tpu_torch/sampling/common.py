"""Sampler plumbing shared by the port's samplers: the hoisted
time-embedding tables (counterpart of ``ctrlora_tpu/sampling/common.py``)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ctrlora_tpu_torch.ops import unpack_rows as unpack_ops
from ctrlora_tpu_torch.pipeline import Conditioning, CtrLoraPipeline


def make_emb_row_tables(pipe: CtrLoraPipeline, conds: Sequence[Conditioning],
                        timesteps: torch.Tensor
                        ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Optional[dict]]]:
    """Packs every branch's emb_proj table (the UNet's, then each
    condition's own) into one [S, n, Cmax] tensor and returns (packed,
    rows_of): rows_of(packed[i]) rebuilds step i's per-branch rows dict for
    ``pipe.apply_model`` with ONE kernel-D launch."""
    n_conds = len(conds)
    tables = pipe.emb_proj_tables(timesteps, conds)
    flat = {f"u.{k}": v for k, v in tables["unet"].items()}
    for j, d in enumerate(tables["control"]):
        flat.update({f"c{j}.{k}": v for k, v in d.items()})
    packed, names, sizes = unpack_ops.pack_row_tables(flat)
    # where each row goes, worked out once: (branch, key), branch -1 the UNet
    # and j >= 0 condition j's control
    places = tuple((-1, name[2:]) if name.startswith("u.") else
                   (int(name[1:name.index(".")]), name[name.index(".") + 1:]) for name in names)

    def rows_of(block: torch.Tensor) -> dict:
        rows = unpack_ops.unpack_rows(block, sizes)
        unet, control = {}, tuple({} for _ in range(n_conds))
        for (j, key), row in zip(places, rows):
            (unet if j < 0 else control[j])[key] = row
        return {"unet": unet, "control": control}

    return packed, rows_of
