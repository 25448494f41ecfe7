"""Reference checkpoints <-> the port's state dicts (counterpart of
``ctrlora_tpu/utils/ckpt_torch.py``).

The reference's torch state-dict names (SD1.5 ``model.diffusion_model.*``,
``first_stage_model.*``, ``cond_stage_model.transformer.text_model.*``; the
Base ControlNet and per-condition LoRAs under ``control_model.*``) map onto
the flax parameter paths through the same entry tables as the JAX package,
and a flax path maps onto the port's state-dict key through
``convert.port_key`` / ``convert.params_from_jax``: one name mapping, shared
with the JAX package, not a second one.

Layouts: the reference and the port are both torch, so a Linear [out, in] or
Conv [out, in, k, k] weight has the same layout in both; ``port_entries``
composes the flax transpose with ``convert._leaf``'s transpose back, so a
file's tensor reaches the port's key as a view of itself. LoRA: reference
down [rank, in] / up [out, rank] <-> port banks ``lora_down`` [n, in, rank] / ``lora_up``
[n, rank, out]; switchable zero convs and transformer norms are [n]-banks.

``.ckpt``/``.pth`` load through ``torch.load`` (a nested ``state_dict`` is
unwrapped); ``.safetensors`` only where the ``safetensors`` package imports.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ctrlora_tpu_torch import convert
from ctrlora_tpu_torch.configs import (
    CLIPTextConfig, ControlNetConfig, ModelConfig, UNetConfig, VAEConfig,
)
from ctrlora_tpu_torch.models.unet import decoder_plan, encoder_plan
from ctrlora_tpu_torch.models.xs import control_config

StateDict = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# entry tables: (torch_key, flax_path, transform)
# ---------------------------------------------------------------------------

T_LINEAR_W = "linear_w"
T_CONV_W = "conv_w"
T_COPY = "copy"


def _tfm_axes(kind: str, ndim: int) -> Optional[Tuple[int, ...]]:
    """The axes that take a reference weight to the flax layout (None: as
    it is)."""
    if kind == T_LINEAR_W:
        return tuple(reversed(range(ndim)))
    if kind == T_CONV_W:
        return (2, 3, 1, 0)
    return None


def _tfm(kind: str, x: np.ndarray) -> np.ndarray:
    axes = _tfm_axes(kind, x.ndim)
    return x if axes is None else np.ascontiguousarray(np.transpose(x, axes))


def _tfm_view(kind: str, x: torch.Tensor) -> torch.Tensor:
    """``_tfm`` on a torch tensor, as a view (no copy)."""
    axes = _tfm_axes(kind, x.ndim)
    return x if axes is None else x.permute(axes)


Entry = Tuple[str, Tuple[str, ...], str]


def _linear(t: str, f: Tuple[str, ...], bias: bool = True) -> List[Entry]:
    out = [(f"{t}.weight", (*f, "kernel"), T_LINEAR_W)]
    if bias:
        out.append((f"{t}.bias", (*f, "bias"), T_COPY))
    return out


def _conv(t: str, f: Tuple[str, ...]) -> List[Entry]:
    return [
        (f"{t}.weight", (*f, "kernel"), T_CONV_W),
        (f"{t}.bias", (*f, "bias"), T_COPY),
    ]


def _norm(t: str, f: Tuple[str, ...]) -> List[Entry]:
    return [
        (f"{t}.weight", (*f, "scale"), T_COPY),
        (f"{t}.bias", (*f, "bias"), T_COPY),
    ]


def _resblock(t: str, f: str, has_skip: bool) -> List[Entry]:
    e: List[Entry] = []
    e += _norm(f"{t}.in_layers.0", (f, "in_norm"))
    e += _conv(f"{t}.in_layers.2", (f, "in_conv"))
    e += _linear(f"{t}.emb_layers.1", (f, "emb_proj"))
    e += _norm(f"{t}.out_layers.0", (f, "out_norm"))
    e += _conv(f"{t}.out_layers.3", (f, "out_conv"))
    if has_skip:
        e += _conv(f"{t}.skip_connection", (f, "skip"))
    return e


def _transformer(t: str, f: str, depth: int = 1, ip: bool = False) -> List[Entry]:
    e: List[Entry] = []
    e += _norm(f"{t}.norm", (f, "norm"))
    e += _conv(f"{t}.proj_in", (f, "proj_in"))
    for d in range(depth):
        tb, fb = f"{t}.transformer_blocks.{d}", (f, f"block_{d}")
        for attn in ("attn1", "attn2"):
            e += _linear(f"{tb}.{attn}.to_q", (*fb, attn, "to_q"), bias=False)
            e += _linear(f"{tb}.{attn}.to_k", (*fb, attn, "to_k"), bias=False)
            e += _linear(f"{tb}.{attn}.to_v", (*fb, attn, "to_v"), bias=False)
            e += _linear(f"{tb}.{attn}.to_out.0", (*fb, attn, "to_out"))
        if ip:
            e += _linear(f"{tb}.attn2.to_k_ip", (*fb, "attn2", "to_k_ip"), bias=False)
            e += _linear(f"{tb}.attn2.to_v_ip", (*fb, "attn2", "to_v_ip"), bias=False)
            e.append((f"{tb}.attn2.ip_scale", (*fb, "attn2", "ip_scale"), T_COPY))
        e += _linear(f"{tb}.ff.net.0.proj", (*fb, "ff", "proj"))
        e += _linear(f"{tb}.ff.net.2", (*fb, "ff", "out"))
        e += _norm(f"{tb}.norm1", (*fb, "norm1"))
        e += _norm(f"{tb}.norm2", (*fb, "norm2"))
        e += _norm(f"{tb}.norm3", (*fb, "norm3"))
    e += _conv(f"{t}.proj_out", (f, "proj_out"))
    return e


def unet_entries(cfg: UNetConfig, decoder: bool = True, ip: bool = False) -> List[Entry]:
    """Full UNet table (reference names: model.diffusion_model.*); `ip` adds
    every attn2's image-prompt projections and scale."""
    e: List[Entry] = []
    e += _linear("time_embed.0", ("time_embed", "dense0"))
    e += _linear("time_embed.2", ("time_embed", "dense1"))
    steps, chans, _ = encoder_plan(cfg)
    in_ch = cfg.model_channels
    for i, step in enumerate(steps):
        if step.kind == "conv":
            e += _conv(f"input_blocks.{i}.0", ("in_conv",))
        elif step.kind == "res":
            e += _resblock(f"input_blocks.{i}.0", f"in_{i}_res", in_ch != step.out_ch)
            if step.attn:
                e += _transformer(
                    f"input_blocks.{i}.1", f"in_{i}_attn", cfg.transformer_depth, ip
                )
            in_ch = step.out_ch
        else:
            e += _conv(f"input_blocks.{i}.0.op", (f"in_{i}_down", "conv"))
    e += _resblock("middle_block.0", "mid_res0", False)
    e += _transformer("middle_block.1", "mid_attn", cfg.transformer_depth, ip)
    e += _resblock("middle_block.2", "mid_res1", False)
    if decoder:
        ch = chans[-1]
        skips = list(chans)
        for i, step in enumerate(decoder_plan(cfg)):
            skip_ch = skips.pop()
            e += _resblock(f"output_blocks.{i}.0", f"out_{i}_res", True)
            nxt = 1
            if step.attn:
                e += _transformer(
                    f"output_blocks.{i}.{nxt}", f"out_{i}_attn", cfg.transformer_depth, ip
                )
                nxt += 1
            if step.upsample:
                e += _conv(f"output_blocks.{i}.{nxt}.conv", (f"out_{i}_up", "conv"))
        e += _norm("out.0", ("norm_out",))
        e += _conv("out.2", ("conv_out",))
    return e


def _hint_block() -> List[Entry]:
    """The hint encoder: input_hint_block.{0,2,...,12} are its seven convs
    (SiLUs between them), .14 its output conv."""
    e: List[Entry] = []
    for j, idx in enumerate(range(0, 14, 2)):
        e += _conv(f"input_hint_block.{idx}", ("hint_block", f"conv_{j}"))
    return e + _conv("input_hint_block.14", ("hint_block", "conv_out"))


def controlnet_entries(cfg: ControlNetConfig) -> List[Entry]:
    """Control branch table (reference names: control_model.*); an
    image-hint ControlNet adds its hint encoder."""
    e = unet_entries(cfg.unet, decoder=False)
    steps, _, _ = encoder_plan(cfg.unet)
    for i in range(len(steps)):
        e += _conv(f"zero_convs.{i}.0", (f"zero_{i}",))
    e += _conv("middle_block_out.0", ("zero_mid",))
    if cfg.hint_mode == "image":
        e += _hint_block()
    return e


def lite_entries(cfg: UNetConfig) -> List[Entry]:
    """ControlNet-Lite table (reference names: control_model.*; the port's
    copy of JAX ``models/lite.py`` ``lite_entries``): each res step is
    input_blocks.{i}.0 (GroupNorm) and .2 (conv), the middle is
    middle_block.0 and .2."""
    e: List[Entry] = []
    e += _linear("time_embed.0", ("time_embed", "dense0"))
    e += _linear("time_embed.2", ("time_embed", "dense1"))
    for i, step in enumerate(encoder_plan(cfg)[0]):
        if step.kind == "conv":
            e += _conv(f"input_blocks.{i}.0", ("in_conv",))
        elif step.kind == "res":
            e += _norm(f"input_blocks.{i}.0", (f"in_{i}_norm",))
            e += _conv(f"input_blocks.{i}.2", (f"in_{i}_conv",))
        else:
            e += _conv(f"input_blocks.{i}.0.op", (f"in_{i}_down", "conv"))
        e += _conv(f"zero_convs.{i}.0", (f"zero_{i}",))
    e += _norm("middle_block.0", ("mid_norm",))
    e += _conv("middle_block.2", ("mid_conv",))
    e += _conv("middle_block_out.0", ("zero_mid",))
    return e + _hint_block()


XS_BASE_PREFIX, XS_CTRL_PREFIX = "base.", "control_model."


def xs_entries(cfg: UNetConfig, ratio: float = 0.2, infusion2control: Optional[str] = "cat",
               guiding: str = "encoder_double", learn_embedding: bool = False) -> List[Entry]:
    """ControlNet-XS table (the port's copy of JAX ``models/xs.py``
    ``xs_entries``): the base stream under ``XS_BASE_PREFIX`` in the UNet's
    layout; the control stream under ``XS_CTRL_PREFIX``, and the zero convs and
    the hint encoder at the root, in TwoStreamControlNet's layout
    (reference cldm_xs.py:129-262). Without infusion2control there are no
    enc_zero_in convs, and no entries for them."""
    e = [(XS_BASE_PREFIX + t, f, k) for t, f, k in unet_entries(cfg)]
    ctr_cfg = control_config(cfg, ratio)
    if learn_embedding:
        e += _linear(f"{XS_CTRL_PREFIX}time_embed.0", ("ctrl_time_embed", "dense0"))
        e += _linear(f"{XS_CTRL_PREFIX}time_embed.2", ("ctrl_time_embed", "dense1"))
    steps = encoder_plan(ctr_cfg)[0]
    cat = infusion2control == "cat"
    in_ch = ctr_cfg.model_channels
    for i, step in enumerate(steps):
        t = f"{XS_CTRL_PREFIX}input_blocks.{i}"
        if step.kind == "conv":
            e += _conv(f"{t}.0", ("ctrl_in_conv",))
        elif step.kind == "res":
            e += _resblock(f"{t}.0", f"ctrl_in_{i}_res", cat or in_ch != step.out_ch)
            if step.attn:
                e += _transformer(f"{t}.1", f"ctrl_in_{i}_attn", cfg.transformer_depth)
            in_ch = step.out_ch
        else:
            e += _conv(f"{t}.0.op", (f"ctrl_in_{i}_down", "conv"))
    e += _resblock(f"{XS_CTRL_PREFIX}middle_block.0", "ctrl_mid_res0", cat)
    e += _transformer(f"{XS_CTRL_PREFIX}middle_block.1", "ctrl_mid_attn", cfg.transformer_depth)
    e += _resblock(f"{XS_CTRL_PREFIX}middle_block.2", "ctrl_mid_res1", False)
    if guiding == "full":  # the control decoder (ControlledUNetModelFixed output_blocks)
        for i, step in enumerate(decoder_plan(ctr_cfg)):
            t = f"{XS_CTRL_PREFIX}output_blocks.{i}"
            e += _resblock(f"{t}.0", f"ctrl_out_{i}_res", True)
            nxt = 1
            if step.attn:
                e += _transformer(f"{t}.{nxt}", f"ctrl_out_{i}_attn", cfg.transformer_depth)
                nxt += 1
            if step.upsample:
                e += _conv(f"{t}.{nxt}.conv", (f"ctrl_out_{i}_up", "conv"))
    for i in range(len(steps)):
        if infusion2control is not None:  # JAX's table lists them even without infusion
            e += _conv(f"enc_zero_convs_in.{i}.0", (f"enc_zero_in_{i}",))
        if guiding in ("encoder_double", "full"):
            e += _conv(f"enc_zero_convs_out.{i}.0", (f"enc_zero_out_{i}",))
    e += _conv("middle_block_out.0", ("mid_zero_out",))
    if guiding == "full":
        e += _conv("middle_block_in.0", ("mid_zero_in",))
        for i in range(len(decoder_plan(ctr_cfg)) - 1):
            e += _conv(f"dec_zero_convs_out.{i}.0", (f"dec_zero_out_{i}",))
            e += _conv(f"dec_zero_convs_in.{i}.0", (f"dec_zero_in_{i}",))
    else:
        for i in range(len(steps)):
            e += _conv(f"dec_zero_convs_out.{i}.0", (f"dec_zero_out_{i}",))
    return e + _hint_block()


def xs_control_entries(cfg: ModelConfig) -> List[Entry]:
    """The table of an XS model's control file: ``xs_entries`` without the
    base stream (the SD file's), at the knobs of ``cfg.control``."""
    c = cfg.control
    return [e for e in xs_entries(cfg.unet, c.control_model_ratio, c.infusion2control,
                                  c.guiding, c.learn_embedding)
            if not e[0].startswith(XS_BASE_PREFIX)]


def control_entries(cfg: ControlNetConfig) -> List[Entry]:
    """The control branch's table for its variant."""
    return lite_entries(cfg.unet) if cfg.variant == "lite" else controlnet_entries(cfg)


def lora_site_entries(cfg: ControlNetConfig) -> List[Tuple[str, Tuple[str, ...]]]:
    """Ordered (torch_linear_path, flax_path) for every nn.Linear in the
    control branch, in torch named_modules order — the order the reference
    builds its per-task LoRA lists (cldm_ctrlora_pretrain.py:26-32)."""
    sites: List[Tuple[str, Tuple[str, ...]]] = [
        ("time_embed.0", ("time_embed", "dense0")),
        ("time_embed.2", ("time_embed", "dense1")),
    ]

    def transformer_sites(t: str, f: str):
        out = []
        for d in range(cfg.unet.transformer_depth):
            tb, fb = f"{t}.transformer_blocks.{d}", (f, f"block_{d}")
            # torch registration order: attn1, ff, attn2
            for name in ("to_q", "to_k", "to_v"):
                out.append((f"{tb}.attn1.{name}", (*fb, "attn1", name)))
            out.append((f"{tb}.attn1.to_out.0", (*fb, "attn1", "to_out")))
            out.append((f"{tb}.ff.net.0.proj", (*fb, "ff", "proj")))
            out.append((f"{tb}.ff.net.2", (*fb, "ff", "out")))
            for name in ("to_q", "to_k", "to_v"):
                out.append((f"{tb}.attn2.{name}", (*fb, "attn2", name)))
            out.append((f"{tb}.attn2.to_out.0", (*fb, "attn2", "to_out")))
        return out

    steps, _, _ = encoder_plan(cfg.unet)
    for i, step in enumerate(steps):
        if step.kind == "res":
            sites.append((f"input_blocks.{i}.0.emb_layers.1", (f"in_{i}_res", "emb_proj")))
            if step.attn:
                sites += transformer_sites(f"input_blocks.{i}.1", f"in_{i}_attn")
    sites.append(("middle_block.0.emb_layers.1", ("mid_res0", "emb_proj")))
    sites += transformer_sites("middle_block.1", "mid_attn")
    sites.append(("middle_block.2.emb_layers.1", ("mid_res1", "emb_proj")))
    return sites


def norm_site_entries(cfg: ControlNetConfig) -> List[Tuple[str, Tuple[str, ...]]]:
    """Ordered (torch_norm_path, flax_path) for 'norm'-named norms in torch
    named_modules order (reference: cldm_ctrlora_inference.py:41-48)."""
    sites: List[Tuple[str, Tuple[str, ...]]] = []

    def st_norms(t: str, f: str):
        out = [(f"{t}.norm", (f, "norm"))]
        for d in range(cfg.unet.transformer_depth):
            for n in ("norm1", "norm2", "norm3"):
                out.append((f"{t}.transformer_blocks.{d}.{n}", (f, f"block_{d}", n)))
        return out

    steps, _, _ = encoder_plan(cfg.unet)
    for i, step in enumerate(steps):
        if step.kind == "res" and step.attn:
            sites += st_norms(f"input_blocks.{i}.1", f"in_{i}_attn")
    sites += st_norms("middle_block.1", "mid_attn")
    return sites


def zero_conv_site_entries(cfg: ControlNetConfig) -> List[Tuple[str, Tuple[str, ...]]]:
    steps, _, _ = encoder_plan(cfg.unet)
    sites = [(f"zero_convs.{i}.0", (f"zero_{i}",)) for i in range(len(steps))]
    sites.append(("middle_block_out.0", ("zero_mid",)))
    return sites


def vae_entries(cfg: VAEConfig) -> List[Entry]:
    """AutoencoderKL table (reference names: first_stage_model.*)."""
    e: List[Entry] = []

    def res(t: str, f: Tuple[str, ...], has_nin: bool):
        out = []
        out += _norm(f"{t}.norm1", (*f, "norm1"))
        out += _conv(f"{t}.conv1", (*f, "conv1"))
        out += _norm(f"{t}.norm2", (*f, "norm2"))
        out += _conv(f"{t}.conv2", (*f, "conv2"))
        if has_nin:
            out += _conv(f"{t}.nin_shortcut", (*f, "nin_shortcut"))
        return out

    def attn(t: str, f: Tuple[str, ...]):
        out = []
        out += _norm(f"{t}.norm", (*f, "norm"))
        for n in ("q", "k", "v", "proj_out"):
            out += _conv(f"{t}.{n}", (*f, n))
        return out

    # encoder
    e += _conv("encoder.conv_in", ("encoder", "conv_in"))
    ch = cfg.ch
    for l, mult in enumerate(cfg.ch_mult):
        out_ch = cfg.ch * mult
        for i in range(cfg.num_res_blocks):
            e += res(
                f"encoder.down.{l}.block.{i}",
                ("encoder", f"down_{l}_block_{i}"),
                has_nin=ch != out_ch,
            )
            ch = out_ch
        if l != len(cfg.ch_mult) - 1:
            e += _conv(
                f"encoder.down.{l}.downsample.conv", ("encoder", f"down_{l}_downsample")
            )
    e += res("encoder.mid.block_1", ("encoder", "mid_block_1"), False)
    e += attn("encoder.mid.attn_1", ("encoder", "mid_attn_1"))
    e += res("encoder.mid.block_2", ("encoder", "mid_block_2"), False)
    e += _norm("encoder.norm_out", ("encoder", "norm_out"))
    e += _conv("encoder.conv_out", ("encoder", "conv_out"))
    e += _conv("quant_conv", ("quant_conv",))
    e += _conv("post_quant_conv", ("post_quant_conv",))
    # decoder
    e += _conv("decoder.conv_in", ("decoder", "conv_in"))
    e += res("decoder.mid.block_1", ("decoder", "mid_block_1"), False)
    e += attn("decoder.mid.attn_1", ("decoder", "mid_attn_1"))
    e += res("decoder.mid.block_2", ("decoder", "mid_block_2"), False)
    ch = cfg.ch * cfg.ch_mult[-1]
    for l in reversed(range(len(cfg.ch_mult))):
        out_ch = cfg.ch * cfg.ch_mult[l]
        for i in range(cfg.num_res_blocks + 1):
            e += res(
                f"decoder.up.{l}.block.{i}",
                ("decoder", f"up_{l}_block_{i}"),
                has_nin=ch != out_ch,
            )
            ch = out_ch
        if l != 0:
            e += _conv(f"decoder.up.{l}.upsample.conv", ("decoder", f"up_{l}_upsample"))
    e += _norm("decoder.norm_out", ("decoder", "norm_out"))
    e += _conv("decoder.conv_out", ("decoder", "conv_out"))
    return e


def clip_entries(cfg: CLIPTextConfig) -> List[Entry]:
    """HF CLIPTextModel table (reference names:
    cond_stage_model.transformer.text_model.*)."""
    e: List[Entry] = [
        ("embeddings.token_embedding.weight", ("token_embedding",), T_COPY),
        ("embeddings.position_embedding.weight", ("position_embedding",), T_COPY),
    ]
    for i in range(cfg.num_layers):
        t, f = f"encoder.layers.{i}", f"layer_{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            e += _linear(f"{t}.self_attn.{n}", (f, "self_attn", n))
        e += _norm(f"{t}.layer_norm1", (f, "layer_norm1"))
        e += _norm(f"{t}.layer_norm2", (f, "layer_norm2"))
        e += _linear(f"{t}.mlp.fc1", (f, "fc1"))
        e += _linear(f"{t}.mlp.fc2", (f, "fc2"))
    e += _norm("final_layer_norm", ("final_layer_norm",))
    return e


# ---------------------------------------------------------------------------
# reference files -> port state dicts
# ---------------------------------------------------------------------------

def _read_file(path: str) -> dict:
    """A .ckpt/.pth/.safetensors file's entries (a nested 'state_dict',
    as in Lightning checkpoints, unwrapped). The reference's checkpoints
    are pickles with non-tensor entries, so ``torch.load`` runs with
    ``weights_only=False``: load only files you trust."""
    if path.endswith(".safetensors"):
        try:
            import safetensors.numpy
        except ImportError as e:
            raise ImportError(f"{path}: reading .safetensors needs the 'safetensors' "
                              f"package, which is not installed") from e
        return {k: np.asarray(v, np.float32) for k, v in safetensors.numpy.load_file(path).items()}
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd["state_dict"] if "state_dict" in sd else sd


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference file -> {name: fp32 np.ndarray} (see ``_read_file``)."""
    return {k: v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
            for k, v in _read_file(path).items() if hasattr(v, "shape")}


def load_torch_tensors(path: str) -> Dict[str, torch.Tensor]:
    """A reference file -> {name: CPU tensor in the file's dtype}: what
    ``load_torch_state_dict`` reads, without widening or copying the
    tensors (other arrays become fp32 tensors)."""
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
            for k, v in _read_file(path).items() if hasattr(v, "shape")}


def port_entries(sd: Dict[str, torch.Tensor], entries: Sequence[Entry], prefix: str = ""
                 ) -> Dict[str, torch.Tensor]:
    """The file's tensors (or numpy arrays) under `entries` straight in the
    port's layout: {port key: tensor}, what ``convert.params_from_jax``
    makes of the JAX package's ``convert_tree`` tree (keys the file lacks
    are left out), without the flax layout in between: the two transposes
    cancel, so each value is a view of the file's tensor (in its dtype)."""
    out: Dict[str, torch.Tensor] = {}
    for tkey, fpath, kind in entries:
        full = prefix + tkey
        if full in sd:
            name, value = convert._leaf(fpath[-1], _tfm_view(kind, torch.as_tensor(sd[full])))
            out[".".join((*fpath[:-1], name))] = value
    return out


def _write_bank(state: StateDict, fpath: Tuple[str, ...], leaf: str, flax_value: np.ndarray,
                slot: int) -> None:
    """Write one flax-layout leaf into the port state dict: into bank slot
    `slot` when the port's tensor is an [n]-bank, else whole."""
    _, value = convert._leaf(leaf, flax_value)
    dst = state[convert.port_key((*fpath, leaf))]
    value = torch.from_numpy(np.ascontiguousarray(value))
    if dst.ndim == value.ndim + 1:
        dst[slot] = value
    else:
        dst.copy_(value)


def load_lora_bank(sd: Dict[str, np.ndarray], cfg: ControlNetConfig, state: StateDict,
                   slot: int, prefix: str = "control_model.", key_style: str = "module",
                   task: Optional[str] = None) -> List[str]:
    """Write one LoRA checkpoint into bank slot `slot` of an unfused control
    state dict. key_style 'module': finetune keys
    ``{prefix}{linear}.lora_layer.{down,up}.weight``; 'dict': pretrain keys
    ``{prefix}loras_dict.{task}.{j}.{down,up}.weight``. Returns the keys
    consumed."""
    used = []
    for j, (tpath, fpath) in enumerate(lora_site_entries(cfg)):
        if key_style == "module":
            kd = f"{prefix}{tpath}.lora_layer.down.weight"
            ku = f"{prefix}{tpath}.lora_layer.up.weight"
        else:
            kd = f"{prefix}loras_dict.{task}.{j}.down.weight"
            ku = f"{prefix}loras_dict.{task}.{j}.up.weight"
        if kd not in sd or ku not in sd:
            continue
        _write_bank(state, fpath, "lora_down", np.asarray(sd[kd], np.float32).T, slot)
        _write_bank(state, fpath, "lora_up", np.asarray(sd[ku], np.float32).T, slot)
        used += [kd, ku]
    return used


def load_switchable_bank(sd: Dict[str, np.ndarray], cfg: ControlNetConfig, state: StateDict,
                         slot: int, prefix: str = "control_model.") -> List[str]:
    """Write a LoRA file's zero convs and transformer norms into bank slot
    `slot` (or whole, for an unbanked tree). Returns the keys consumed."""
    used = []
    sites = ([(t, f, (("weight", "kernel", T_CONV_W), ("bias", "bias", T_COPY)))
              for t, f in zero_conv_site_entries(cfg)]
             + [(t, f, (("weight", "scale", T_COPY), ("bias", "bias", T_COPY)))
                for t, f in norm_site_entries(cfg)])
    for tpath, fpath, leaves in sites:
        for tn, leaf, kind in leaves:
            key = f"{prefix}{tpath}.{tn}"
            if key in sd:
                _write_bank(state, fpath, leaf, _tfm(kind, np.asarray(sd[key], np.float32)),
                            slot)
                used.append(key)
    return used


# ---------------------------------------------------------------------------
# port state dicts -> reference files
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def export_tree(state: StateDict, entries: Sequence[Entry], prefix: str = ""
                ) -> Dict[str, np.ndarray]:
    """Port state dict -> reference-named fp32 arrays (the inverse of the
    loader). A banked Linear or conv weight exports slot 0, as in JAX."""
    expected_ndim = {T_LINEAR_W: 2, T_CONV_W: 4}
    out: Dict[str, np.ndarray] = {}
    for tkey, fpath, kind in entries:
        key = convert.port_key(fpath)
        if key not in state:
            continue
        v = _np(state[key])
        want = expected_ndim.get(kind)
        if want is not None and v.ndim != want:
            v = v[0]
        out[prefix + tkey] = v
    return out


def export_lora_slot(state: StateDict, cfg: ControlNetConfig, slot: int = 0,
                     prefix: str = "control_model.") -> Dict[str, np.ndarray]:
    """One LoRA slot of an unfused control state dict in the reference's
    finetune format (what ``api.CtrLoRA.create_model`` reads): the LoRA
    matrices, zero convs and transformer norms."""
    out: Dict[str, np.ndarray] = {}
    for tpath, fpath in lora_site_entries(cfg):
        kd = convert.port_key((*fpath, "lora_down"))
        if kd not in state:
            continue
        down = _np(state[kd])
        up = _np(state[convert.port_key((*fpath, "lora_up"))])
        if down.ndim == 3:
            down, up = down[slot], up[slot]
        out[f"{prefix}{tpath}.lora_layer.down.weight"] = np.ascontiguousarray(down.T)
        out[f"{prefix}{tpath}.lora_layer.up.weight"] = np.ascontiguousarray(up.T)
    for sites, leaf, ndim in ((zero_conv_site_entries(cfg), "kernel", 4),
                              (norm_site_entries(cfg), "scale", 1)):
        for tpath, fpath in sites:
            w = _np(state[convert.port_key((*fpath, leaf))])
            b = _np(state[convert.port_key((*fpath, "bias"))])
            if w.ndim == ndim + 1:
                w, b = w[slot], b[slot]
            out[f"{prefix}{tpath}.weight"] = w
            out[f"{prefix}{tpath}.bias"] = b
    return out


def export_control_base(state: StateDict, cfg: ControlNetConfig,
                        prefix: str = "control_model.") -> Dict[str, np.ndarray]:
    """The control branch's base weights (zero convs included, LoRA
    matrices excluded) in the reference's key format: a Base-ControlNet
    file, or the whole control model of a vanilla or Lite ControlNet."""
    return export_tree(state, control_entries(cfg), prefix=prefix)
