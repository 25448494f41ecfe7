"""Configuration dataclasses of the PyTorch port.

The fields of ``ctrlora_tpu/configs.py``, with the same names and
defaults, without JAX. A dtype is stored as a string, as there, and
``compute_dtype`` maps it to a ``torch.dtype``. The presets:
``ctrlora_inference_config``, ``ctrlora_finetune_config``,
``ctrlora_pretrain_config``, the baselines ``sd15_config`` (vanilla
image-hint ControlNet), ``cnlite_config`` (ControlNet-Lite) and
``cnxs_config`` (ControlNet-XS), ``sdxl_controlnet_config`` (SDXL base
1.0 with its pixel-hint ControlNet, on fields the JAX package does not
have), and ``tiny_test_config``, plus ``TrainConfig``
for the training step.

``load_model_config`` takes a preset's name or a YAML file (the files under
``configs/``: a ``model:`` tree, or ``preset:`` plus overrides), read by the
port's own reader of the YAML subset that ``yaml.safe_dump`` writes
(:func:`parse_yaml`): the port needs no PyYAML. A file whose model needs a
part the port does not have raises, naming it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Sequence, Tuple, Union

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
    # one depth for every level, or one a level (SDXL); the middle block
    # takes the last level's
    transformer_depth: Union[int, Tuple[int, ...]] = 1
    context_dim: Optional[int] = 768
    dropout: float = 0.0  # the port has no dropout: only 0 is taken
    use_checkpoint: bool = True  # rematerialise ResBlocks and transformers in training
    dtype: str = "bfloat16"
    use_flash_attention: bool = True
    ip_tokens: int = 0  # IP-Adapter image tokens at the end of every attn2 context
    # the port's own (SDXL): heads of this width (-1: ``num_heads`` heads a
    # site), Linear proj_in / proj_out in the transformers, and the width of
    # the vector y whose ``label_emb`` adds onto the time embedding (None: no y)
    num_head_channels: int = -1
    use_linear_in_transformer: bool = False
    adm_in_channels: Optional[int] = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def depth_at(self, level: int) -> int:
        """Transformer blocks a site of `level` holds (-1: the middle)."""
        if isinstance(self.transformer_depth, int):
            return self.transformer_depth
        return self.transformer_depth[level]

    def heads_at(self, channels: int) -> int:
        """Attention heads of a site `channels` wide."""
        return self.num_heads if self.num_head_channels <= 0 else \
            channels // self.num_head_channels


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """hint_mode 'latent' (CtrLoRA: the VAE-encoded hint is the branch's
    input stream) or 'image' (vanilla ControlNet: the noisy latent is the
    input, the pixel hint enters through ``HintBlock``). variant
    'controlnet' (decoder-side taps), 'lite' (ControlNet-Lite: conv-only
    branch, encoder-side taps) or 'xs' (ControlNet-XS: a slim control
    stream beside the UNet, ``models/xs.py``, with the knobs below)."""

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
class ConditionerConfig:
    """SDXL's conditioner (the port's own): the ``clip`` tower and the
    second tower ``clip2`` each give a context (their ``layer``), which
    concatenate on the channel axis in ``context_order``; the tower named by
    ``pooled`` also gives its projected pooled vector from the same forward.
    The vector y is that pooled vector, then the six micro-conditioning
    numbers (original height and width, crop top and left, target height
    and width), each a ``size_embed_dim``-wide sinusoidal embedding. For
    the empty negative prompt the context and pooled vector are zeros."""

    clip2: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    context_order: Tuple[str, ...] = ("clip", "clip2")
    pooled: str = "clip2"
    size_embed_dim: int = 256


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    timesteps: int = 1000
    beta_schedule: str = "linear"  # 'linear' | 'cosine' | 'sqrt_linear' | 'sqrt'
    linear_start: float = 0.00085
    linear_end: float = 0.012
    cosine_s: float = 8e-3
    scale_factor: float = 0.18215
    parameterization: str = "eps"  # 'eps' | 'x0' | 'v': the training target
    v_posterior: float = 0.0  # posterior variance mixed toward beta by this share
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
    conditioner: Optional[ConditionerConfig] = None  # the port's own (SDXL)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training settings, the JAX ``TrainConfig``'s fields and defaults
    (AdamW as torch's: lr 1e-5, weight decay 1e-2, betas 0.9/0.999, eps
    1e-8). ``trainable``: 'all', 'lora' or 'full' (``training.train_state``);
    ``use_ema`` keeps an fp32 shadow of the trainable parameters
    (``training.ema``); ``shard_opt_state`` deals the AdamW state over the
    data ranks of a process group (``parallel.mesh.ShardedOptimizer``; one
    process keeps it whole)."""

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


def cnxs_config() -> ModelConfig:
    """ControlNet-XS baseline: the base UNet with a 0.2x control stream,
    cross infusion both ways (the JAX package's preset for
    configs/cnxs_sd15.yaml)."""
    return ModelConfig(
        name="cnxs_sd15",
        control=ControlNetConfig(hint_mode="image", lora=LoRAConfig(n_loras=0),
                                 variant="xs"),
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


def sdxl_controlnet_config() -> ModelConfig:
    """SDXL base 1.0 (arXiv 2307.01952; generative-models
    configs/inference/sd_xl_base.yaml) with its ControlNet
    (diffusers/controlnet-canny-sdxl-1.0): the UNet at 320 x (1, 2, 4),
    attention at levels 1 and 2 with (1, 2, 10) transformer blocks (the
    middle 10), 64-wide heads, Linear projections, a 2048-wide context (CLIP
    ViT-L/14's and OpenCLIP ViT-bigG/14's, each the state entering its last
    layer) and y of 2816 (bigG's projected pooled vector and six 256-wide
    size embeddings); the ControlNet a copy of its encoder and middle with
    the pixel hint through ``HintBlock``; the KL autoencoder with scale
    0.13025. bf16 UNet, ControlNet and VAE, fp32 text towers; no
    rematerialisation (sampling)."""
    unet = UNetConfig(attention_resolutions=(4, 2), channel_mult=(1, 2, 4),
                      transformer_depth=(1, 2, 10), context_dim=2048, use_checkpoint=False,
                      num_head_channels=64, use_linear_in_transformer=True,
                      adm_in_channels=2816)
    from ctrlora_tpu_torch.models.openclip import openclip_bigg_text_config

    clip_l = CLIPTextConfig(layer="hidden", layer_idx=-1)
    return ModelConfig(
        name="sdxl_controlnet",
        diffusion=DiffusionConfig(scale_factor=0.13025),
        unet=unet,
        control=ControlNetConfig(unet=unet, hint_mode="image"),
        vae=VAEConfig(),
        clip=clip_l,
        conditioner=ConditionerConfig(clip2=openclip_bigg_text_config()),
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


def tiny_sdxl_test_config() -> ModelConfig:
    """Miniature SDXL + ControlNet for unit tests: the same topology (three
    levels, depths (1, 2, 3), Linear projections, 8-wide heads, two text
    towers, y), tiny widths, fp32; a /8 VAE, so that the pixel hint and the
    image share a size."""
    unet = UNetConfig(model_channels=32, channel_mult=(1, 2, 2), num_res_blocks=1,
                      attention_resolutions=(4, 2), transformer_depth=(1, 2, 3),
                      context_dim=64 + 48, use_checkpoint=False, dtype="float32",
                      use_flash_attention=False, num_head_channels=8,
                      use_linear_in_transformer=True, adm_in_channels=40 + 6 * 8)
    tower = dict(vocab_size=49408, intermediate_size=128, num_layers=3, num_heads=2,
                 max_length=16, layer="hidden", layer_idx=-1)
    return ModelConfig(
        name="tiny_sdxl",
        diffusion=DiffusionConfig(scale_factor=0.13025),
        unet=unet,
        control=ControlNetConfig(unet=unet, hint_mode="image"),
        vae=VAEConfig(ch=16, ch_mult=(1, 2, 2, 2), num_res_blocks=1, dtype="float32"),
        clip=CLIPTextConfig(hidden_size=64, **tower),
        conditioner=ConditionerConfig(
            clip2=CLIPTextConfig(hidden_size=48, hidden_act="gelu", projection_dim=40,
                                 **dict(tower, intermediate_size=96)),
            size_embed_dim=8),
    )


_PRESETS = {
    "cldm_v15": sd15_config,
    "cnlite_sd15": cnlite_config,
    "cnxs_sd15": cnxs_config,
    "ctrlora_finetune": ctrlora_finetune_config,
    "ctrlora_inference": ctrlora_inference_config,
    "ctrlora_pretrain": ctrlora_pretrain_config,
    "sdxl_controlnet": sdxl_controlnet_config,
    "tiny": tiny_test_config,
    "tiny_sdxl": tiny_sdxl_test_config,
}
# ---------------------------------------------------------------------------
# YAML files
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (YAML 1.1) for the scalars safe_dump writes
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_KEY = re.compile(r"^('(?:[^']|'')*'|\"[^\"]*\"|[^'\"#\s][^:]*?):(?:\s+(.*))?$")


def _plain(text: str) -> Any:
    """One plain scalar, resolved as PyYAML's safe loader does."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.replace("_", "").lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        return float("nan") if low.endswith("nan") else float(low)
    return text


def _scalar(text: str) -> Any:
    """A value after `key: ` or `- `: quoted, an empty or one-level flow
    collection, or a plain scalar (a trailing ` #` comment dropped)."""
    if text.startswith("'"):
        if not text.endswith("'") or len(text) < 2:
            raise ValueError(f"YAML: unterminated quote in {text!r}")
        return text[1:-1].replace("''", "'")
    if text.startswith('"'):
        if not text.endswith('"') or len(text) < 2:
            raise ValueError(f"YAML: unterminated quote in {text!r}")
        return text[1:-1].encode().decode("unicode_escape")
    text = text.split(" #", 1)[0].rstrip()
    if text.startswith("[") and text.endswith("]"):
        body = text[1:-1].strip()
        if any(ch in body for ch in "[]{}'\""):
            raise ValueError(f"YAML: {text!r}: nested or quoted flow items are outside the "
                             "subset this reader takes")
        return [_scalar(v.strip()) for v in body.split(",")] if body else []
    if text == "{}":
        return {}
    if text and text[0] in "[{&*!|>%@`":
        raise ValueError(f"YAML: {text!r} is outside the subset this reader takes")
    return _plain(text)


def _key(text: str) -> Optional[Tuple[str, str]]:
    """(key, rest) of a `key:` or `key: value` line, else None."""
    m = _KEY.match(text)
    if m is None:
        return None
    key = m.group(1)
    if key[:1] in "'\"":
        key = _scalar(key)
    return key, (m.group(2) or "").strip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: List[Tuple[int, str]], i: int, indent: int) -> Tuple[Any, int]:
    """The block collection starting at line i, at `indent` -> (value, next
    line)."""
    if _is_item(lines[i][1]):
        out = []
        while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
            rest = lines[i][1][1:].strip()
            if not rest:
                i += 1
                if i < len(lines) and lines[i][0] > indent:
                    val, i = _block(lines, i, lines[i][0])
                else:
                    val = None
            elif _key(rest) is not None or _is_item(rest):  # a collection on this line
                lines[i] = (indent + 2, rest)
                val, i = _block(lines, i, indent + 2)
            else:
                val, i = _scalar(rest), i + 1
            out.append(val)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        kv = _key(lines[i][1])
        if kv is None:
            raise ValueError(f"YAML: expected `key: value`, got {lines[i][1]!r}")
        key, rest = kv
        if key in out:
            raise ValueError(f"YAML: duplicate key {key!r}")
        i += 1
        if rest:
            out[key] = _scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent
                                 or (lines[i][0] == indent and _is_item(lines[i][1]))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"YAML: unexpected indentation at {lines[i][1]!r}")
    return out, i


def parse_yaml(text: str) -> Any:
    """The document in `text`, for the subset of YAML that ``yaml.safe_dump``
    writes (block style): nested mappings, block lists (items at their
    key's indent or deeper, scalars or mappings), empty flow collections,
    and scalars resolved as PyYAML's safe loader resolves them: null, bool,
    decimal int, float, quoted and plain strings. Anchors, tags, multi-line
    scalars and nested flow collections raise ValueError."""
    lines = []
    for raw in text.splitlines():
        body = raw.rstrip()
        if not body.strip() or body.lstrip().startswith("#") or body.strip() in ("---", "..."):
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            raise ValueError("YAML: tabs are not indentation")
        lines.append((len(body) - len(stripped), stripped))
    if not lines:
        return None
    if len(lines) == 1 and _key(lines[0][1]) is None and not _is_item(lines[0][1]):
        return _scalar(lines[0][1])
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"YAML: unexpected line {lines[end][1]!r}")
    return value


_SUBTREES = {"unet": UNetConfig, "control": ControlNetConfig, "vae": VAEConfig,
             "clip": CLIPTextConfig, "diffusion": DiffusionConfig, "lora": LoRAConfig,
             "conditioner": ConditionerConfig, "clip2": CLIPTextConfig}


def _dataclass_from_dict(cls, d):
    """The JAX ``_dataclass_from_dict``: nested dicts to their dataclasses,
    lists to tuples; raises KeyError on a field `cls` does not have."""
    if d is None:
        return None
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        target = _SUBTREES.get(k)
        if target is not None and isinstance(v, dict):
            v = _dataclass_from_dict(target, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def _deep_update(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
    return dst


def check_ported(cfg: ModelConfig) -> ModelConfig:
    """`cfg`, or NotImplementedError where it needs a part the port does not
    have: image-prompt tokens in the control branch, dropout, a per-level
    depth or vector y outside the ControlNet variant, or a conditioner whose
    widths do not meet the UNet's; ValueError where a per-level depth does
    not give one depth a level."""
    if cfg.control is not None and cfg.control.unet.ip_tokens:
        raise NotImplementedError(
            f"{cfg.name}: control.unet.ip_tokens={cfg.control.unet.ip_tokens}: the control "
            "branch reads the text context only (the image-prompt tokens go to the UNet), "
            "where a JAX ControlNet built with image tokens would take the last text tokens "
            "for them")
    for where, unet in (("unet", cfg.unet),
                        ("control.unet", cfg.control.unet if cfg.control else None)):
        if unet is None:
            continue
        if unet.dropout:
            raise NotImplementedError(f"{cfg.name}: {where}.dropout={unet.dropout}: the port "
                                      "has no dropout")
        depth = unet.transformer_depth
        if not isinstance(depth, int) and len(depth) != len(unet.channel_mult):
            raise ValueError(f"{cfg.name}: {where}.transformer_depth={depth}: one depth a "
                             f"level of channel_mult={unet.channel_mult}")
        sdxl = (not isinstance(depth, int) or unet.num_head_channels > 0
                or unet.use_linear_in_transformer or unet.adm_in_channels is not None)
        if sdxl and cfg.control is not None and cfg.control.variant != "controlnet":
            raise NotImplementedError(f"{cfg.name}: {where}: per-level depth, head width, "
                                      "linear projections and y are built for the ControlNet "
                                      f"variant, not {cfg.control.variant!r}")
    _check_conditioner(cfg)
    return cfg


def _check_conditioner(cfg: ModelConfig) -> None:
    """The conditioner's widths against the UNet's: the towers' contexts
    add up to ``context_dim`` and the pooled vector with its size
    embeddings to ``adm_in_channels``; no y without a conditioner."""
    unets = [cfg.unet] + ([cfg.control.unet] if cfg.control is not None else [])
    con = cfg.conditioner
    if con is None:
        if any(u.adm_in_channels is not None for u in unets):
            raise NotImplementedError(f"{cfg.name}: adm_in_channels needs a conditioner "
                                      "that makes y")
        return
    towers = {"clip": cfg.clip, "clip2": con.clip2}
    if sorted(con.context_order) != sorted(towers) or con.pooled not in towers:
        raise ValueError(f"{cfg.name}: conditioner.context_order={con.context_order} must "
                         f"name each of {sorted(towers)} once and pooled={con.pooled!r} one")
    if not towers[con.pooled].projection_dim:
        raise ValueError(f"{cfg.name}: the pooled tower {con.pooled!r} needs projection_dim")
    ctx = sum(t.hidden_size for t in towers.values())
    adm = towers[con.pooled].projection_dim + 6 * con.size_embed_dim
    for u in unets:
        if (u.context_dim, u.adm_in_channels) != (ctx, adm):
            raise NotImplementedError(
                f"{cfg.name}: the conditioner gives a context of {ctx} and y of {adm}; the "
                f"UNet takes context_dim={u.context_dim}, adm_in_channels={u.adm_in_channels}")


def load_model_config(path_or_preset: str, **overrides) -> ModelConfig:
    """The ModelConfig of a preset name (keyword overrides go to the
    preset's function) or of a YAML file: a full ModelConfig tree under
    ``model:``, or ``preset: <name>`` with nested overrides (under
    ``model:`` or at the top), as JAX ``load_model_config`` reads them.
    Raises where the model needs a part the port does not have
    (:func:`check_ported`)."""
    if path_or_preset in _PRESETS:
        return _PRESETS[path_or_preset](**overrides)
    try:
        with open(path_or_preset) as f:
            raw = parse_yaml(f.read())
    except FileNotFoundError:
        raise ValueError(f"{path_or_preset!r} is neither a preset of the port "
                         f"({', '.join(_PRESETS)}) nor a file") from None
    if not isinstance(raw, dict):
        raise ValueError(f"{path_or_preset}: a config file holds a mapping")
    if "preset" in raw:
        preset = raw.pop("preset")
        base = dataclasses.asdict(_PRESETS[preset]())
        _deep_update(base, raw.get("model", raw))
        return check_ported(_dataclass_from_dict(ModelConfig, base))
    return check_ported(_dataclass_from_dict(ModelConfig, raw.get("model", raw)))
