"""Configuration dataclasses of the PyTorch port.

The fields of ``ctrlora_tpu/configs.py`` that the ported path reads, with the
same names and defaults, without JAX and without YAML files.
A dtype is stored as a string, as there, and ``compute_dtype`` maps it to a
``torch.dtype``. Only the presets of the ported paths are here:
``ctrlora_inference_config``, ``ctrlora_finetune_config``,
``ctrlora_pretrain_config``, the baselines ``sd15_config`` (vanilla
image-hint ControlNet) and ``cnlite_config`` (ControlNet-Lite), and
``tiny_test_config`` (``load_model_config`` takes their names), plus
``TrainConfig`` for the training step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    n_loras: int = 0
    rank: int = 128
    network_alpha: Optional[float] = None
    switchable_banks: bool = False


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: Optional[int] = 768
    use_checkpoint: bool = True  # rematerialise ResBlocks and transformers in training
    dtype: str = "bfloat16"
    use_flash_attention: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """hint_mode 'latent' (CtrLoRA: the VAE-encoded hint is the branch's
    input stream) or 'image' (vanilla ControlNet: the noisy latent is the
    input, the pixel hint enters through ``HintBlock``). variant
    'controlnet' (decoder-side taps), 'lite' (ControlNet-Lite: conv-only
    branch, encoder-side taps) or 'xs' (ControlNet-XS, not ported: its
    knobs are here so that its preset can be named)."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    hint_channels: int = 3
    hint_mode: str = "latent"
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)
    variant: str = "controlnet"
    control_model_ratio: float = 0.2
    infusion2control: Optional[str] = "cat"
    guiding: str = "encoder_double"
    learn_embedding: bool = False


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    embed_dim: int = 4
    z_channels: int = 4
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_channels: int = 3
    double_z: bool = True
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    # 'last' final_layer_norm(hidden); 'penultimate' the same one layer
    # early; 'hidden' the raw state entering layer `layer_idx` (clip-skip);
    # 'pooled' the EOT position of 'last'; 'projected' pooled @
    # text_projection [hidden, projection_dim]
    layer: str = "last"
    layer_idx: Optional[int] = None
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = None
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012
    scale_factor: float = 0.18215
    parameterization: str = "eps"  # 'eps' | 'v' (the samplers read it)
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    logvar_init: float = 0.0
    only_mid_control: bool = False  # control taps add onto the middle only
    global_average_pooling: bool = False  # each tap averaged over H and W
    sd_locked: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "ctrlora_sd15"
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    control: Optional[ControlNetConfig] = dataclasses.field(default_factory=ControlNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    clip: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    # task names of pretrain-style stacked LoRAs; index order == lora index
    tasks: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training settings, the JAX ``TrainConfig``'s fields and defaults
    (AdamW as torch's: lr 1e-5, weight decay 1e-2, betas 0.9/0.999, eps
    1e-8). ``trainable``: 'all', 'lora' or 'full' (``training.train_state``);
    ``use_ema`` keeps an fp32 shadow of the trainable parameters
    (``training.ema``); ``shard_opt_state`` needs several devices and is not
    ported (it must stay False)."""

    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    batch_size: int = 4
    grad_accum: int = 1
    max_steps: int = 700_000
    trainable: str = "all"
    norm_trainable: bool = True
    zero_trainable: bool = True
    sd_locked: bool = True
    prompt_dropout: float = 0.3
    use_ema: bool = False
    ema_decay: float = 0.9999
    shard_opt_state: bool = False
    seed: int = 42
    log_every: int = 100
    ckpt_every: int = 10_000
    image_log_every: int = 1000


MULTIGEN_TASKS = (
    "hed", "canny", "seg", "depth", "normal", "openpose", "hedsketch",
    "bbox", "outpainting",
)


def sd15_config() -> ModelConfig:
    """Vanilla SD1.5 + image-hint ControlNet, no LoRA (the JAX package's
    preset for configs/cldm_v15.yaml)."""
    return ModelConfig(
        name="cldm_v15",
        control=ControlNetConfig(hint_mode="image", lora=LoRAConfig(n_loras=0)),
    )


def cnlite_config() -> ModelConfig:
    """ControlNet-Lite baseline: the conv-only image-hint branch with
    encoder-side taps (the JAX package's preset for
    configs/cnlite_sd15.yaml)."""
    return ModelConfig(
        name="cnlite_sd15",
        control=ControlNetConfig(hint_mode="image", lora=LoRAConfig(n_loras=0),
                                 variant="lite"),
    )


def ctrlora_pretrain_config(tasks: Sequence[str] = MULTIGEN_TASKS,
                            lora_rank: int = 128) -> ModelConfig:
    """Base ControlNet + per-task LoRA pretraining at SD1.5 width: one
    rank-r LoRA bank per task in the latent-hint ControlNet, no switchable
    banks, rematerialised blocks (the JAX package's preset of the same
    name)."""
    return ModelConfig(
        name="ctrlora_pretrain",
        control=ControlNetConfig(
            hint_mode="latent",
            lora=LoRAConfig(n_loras=len(tasks), rank=lora_rank),
        ),
        tasks=tuple(tasks),
    )


def ctrlora_finetune_config(lora_rank: int = 128, ft_with_lora: bool = True) -> ModelConfig:
    """Novel-condition finetune at SD1.5 width: one rank-r LoRA in the
    latent-hint ControlNet, no banks, rematerialised blocks (the JAX
    package's preset of the same name)."""
    return ModelConfig(
        name="ctrlora_finetune",
        control=ControlNetConfig(
            hint_mode="latent",
            lora=LoRAConfig(n_loras=1 if ft_with_lora else 0, rank=lora_rank),
        ),
    )


def ctrlora_inference_config(lora_num: int = 1, lora_rank: int = 128) -> ModelConfig:
    """Switchable N-LoRA inference model at SD1.5 width, bf16 UNet and VAE,
    fp32 CLIP (the JAX package's preset of the same name); no
    rematerialisation, as there is no backward pass."""
    unet = UNetConfig(use_checkpoint=False)
    return ModelConfig(
        name="ctrlora_inference",
        unet=unet,
        control=ControlNetConfig(
            unet=unet,
            hint_mode="latent",
            lora=LoRAConfig(n_loras=lora_num, rank=lora_rank, switchable_banks=True),
        ),
    )


def tiny_test_config(
    n_loras: int = 0, switchable_banks: bool = False, hint_mode: str = "latent"
) -> ModelConfig:
    """Miniature model for unit tests: same topology, tiny widths, fp32."""
    unet = UNetConfig(
        model_channels=32,
        channel_mult=(1, 2),
        num_res_blocks=1,
        attention_resolutions=(2,),
        num_heads=2,
        context_dim=64,
        use_checkpoint=False,
        dtype="float32",
        use_flash_attention=False,
    )
    return ModelConfig(
        name="tiny",
        unet=unet,
        control=ControlNetConfig(
            unet=unet,
            hint_mode=hint_mode,
            lora=LoRAConfig(n_loras=n_loras, rank=4, switchable_banks=switchable_banks),
        ),
        vae=VAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1, dtype="float32"),
        clip=CLIPTextConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=2, max_length=16,
        ),
        tasks=tuple(f"task{i}" for i in range(n_loras)),
    )


_PRESETS = {
    "cldm_v15": sd15_config,
    "cnlite_sd15": cnlite_config,
    "ctrlora_finetune": ctrlora_finetune_config,
    "ctrlora_inference": ctrlora_inference_config,
    "ctrlora_pretrain": ctrlora_pretrain_config,
    "tiny": tiny_test_config,
}
# the JAX package's other presets, and the ROADMAP queue 1 item that ports them
XS_ITEM = "item 10b (ControlNet-XS)"
_NOT_PORTED = {"cnxs_sd15": XS_ITEM}


def load_model_config(path_or_preset: str, **overrides) -> ModelConfig:
    """The ModelConfig of a preset name (``ctrlora_tpu/configs.py``
    ``load_model_config``); keyword overrides go to the preset's function.
    YAML files are not read yet."""
    if path_or_preset in _PRESETS:
        return _PRESETS[path_or_preset](**overrides)
    if path_or_preset in _NOT_PORTED:
        raise ValueError(f"preset {path_or_preset!r} is not ported yet: ROADMAP queue 1 "
                         f"{_NOT_PORTED[path_or_preset]}")
    raise ValueError(f"{path_or_preset!r} is not a preset of the port "
                     f"({', '.join(_PRESETS)}); the port reads no YAML config files yet")
