"""CtrLoRA pipeline of the port: the four towers and the denoiser call
(counterpart of ``ctrlora_tpu/pipeline.py``).

The control branch is built by ``cfg.control.variant`` (``build_control``):
'controlnet' is the ControlNet, latent-hint (CtrLoRA) or image-hint
(vanilla ControlNet); 'lite' is ControlNet-Lite, whose taps add onto the
UNet's encoder side; 'xs' is ControlNet-XS, whose control stream runs in
one module with the base UNet (``models/xs.py``): the pipeline holds that
XS UNet in place of its UNet and has no separate control module
(``control`` is None), as JAX holds the XS tree in ``params.unet``. A LoRA
ControlNet is the fused tree for serving
(``lora_fuse``), or, with ``fuse_lora=False``, the unfused tree with its
stacked LoRA adapters (and switchable banks), which training updates. A
condition may carry its own control module (``Conditioning.control``: the
fused tree of its LoRA, the counterpart of JAX ``control_params``), so N
LoRAs are served side by side. Text comes in as token ids
(``utils.tokenizer`` makes them; ``encode_text`` tokenizes prompts).
Images and latents are NHWC. The frozen towers run without autograd;
``apply_control``/``apply_model`` record it when grad is enabled (the
training step), and the samplers call them under ``torch.no_grad``.

A model with a conditioner (SDXL, ``cfg.conditioner``) holds a second
text tower ``clip2``; its context is both towers' side by side, and
``encode_prompts`` also gives each row's vector conditioning (``vector``:
the pooled text vector and the six micro-conditioning numbers), which
travels with the context through CFG to ``apply_model``, where
``embed_vector`` makes it the model's y.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.configs import ControlNetConfig, DiffusionConfig, ModelConfig, UNetConfig
from ctrlora_tpu_torch.lora_fuse import cast_params_for_inference, fused_control_config
from ctrlora_tpu_torch.models.clip import CLIPTextModel, encode_windowed
from ctrlora_tpu_torch.models.attention import SpatialTransformer
from ctrlora_tpu_torch.models.layers import ResBlock, to_channels_last
from ctrlora_tpu_torch.models.lite import ControlNetLite
from ctrlora_tpu_torch.models.unet import ControlNet, UNet
from ctrlora_tpu_torch.models.vae import AutoencoderKL, sample_posterior
from ctrlora_tpu_torch.models.xs import XSUNet
from ctrlora_tpu_torch.schedules import DiffusionSchedule, make_schedule, timestep_embedding
from ctrlora_tpu_torch.utils import trace
from ctrlora_tpu_torch.utils.tokenizer import default_tokenizer


def build_control(cfg: ControlNetConfig, fuse_lora: bool = True,
                  unet: Optional[UNetConfig] = None) -> nn.Module:
    """The control module of `cfg`'s variant, on the current default
    device: ControlNet-Lite; the ControlNet (its fused tree, without LoRA
    parameters, unless ``fuse_lora`` is False); or, for ControlNet-XS, the
    XS UNet, both streams in one module, over the base UNet config `unet`
    (default ``cfg.unet``), which the pipeline holds in place of its
    UNet."""
    if cfg.variant == "lite":
        return ControlNetLite(cfg.unet, cfg.hint_channels)
    if cfg.variant == "xs":
        return XSUNet(cfg.unet if unet is None else unet, hint_channels=cfg.hint_channels,
                      control_model_ratio=cfg.control_model_ratio,
                      infusion2control=cfg.infusion2control, guiding=cfg.guiding,
                      learn_embedding=cfg.learn_embedding)
    if cfg.variant != "controlnet":
        raise ValueError(f"unknown control variant {cfg.variant!r}")
    return ControlNet(fused_control_config(cfg) if fuse_lora else cfg)


def schedule_of(d: DiffusionConfig) -> DiffusionSchedule:
    """The schedule tables of the diffusion config `d`."""
    return make_schedule(
        beta_schedule=d.beta_schedule, timesteps=d.timesteps,
        linear_start=d.linear_start, linear_end=d.linear_end, cosine_s=d.cosine_s,
        v_posterior=d.v_posterior, parameterization=d.parameterization)


@dataclasses.dataclass(frozen=True)
class Conditioning:
    """One control condition: the hint (a VAE-encoded latent [B, h, w, 4]
    for a latent-hint ControlNet, pixels [B, 8h, 8w, 3] in [0, 1] for an
    image-hint one), the adapter index of an unfused control tree, its
    blend weight, and optionally its own control module (a fused
    ControlNet holding its LoRA's tree) instead of the pipeline's."""

    hint: torch.Tensor
    lora_idx: Optional[Union[int, torch.Tensor]] = None
    weight: float = 1.0
    control: Optional[nn.Module] = None


class CtrLoraPipeline:
    """Module bundle + schedule. The modules are built on `device`, in eval
    mode, without gradients, in channels-last memory. ``fuse_lora=False``
    holds the unfused LoRA control tree (training) instead of the fused one
    (serving). ``control_mode`` is where the taps add onto the UNet:
    'encoder' for ControlNet-Lite, else 'decoder'. With ControlNet-XS
    (``is_xs``) ``unet`` is the XS UNet and ``control`` is None."""

    def __init__(self, cfg: ModelConfig, device="cuda", fuse_lora: bool = True):
        self.cfg = cfg
        self.device = torch.device(device)
        self.fuse_lora = fuse_lora
        self.is_xs = cfg.control.variant == "xs"
        self.control_mode = "encoder" if cfg.control.variant == "lite" else "decoder"
        with self.device:
            if self.is_xs:
                self.unet = build_control(cfg.control, fuse_lora, unet=cfg.unet)
                self.control = None
            else:
                self.unet = UNet(cfg.unet)
                self.control = build_control(cfg.control, fuse_lora)
            self.vae = AutoencoderKL(cfg.vae)
            con = cfg.conditioner
            self.clip = CLIPTextModel(cfg.clip, pooled=con is not None and con.pooled == "clip")
            self.clip2 = None if con is None else CLIPTextModel(con.clip2,
                                                                pooled=con.pooled == "clip2")
        for m in self.modules():
            to_channels_last(m.eval().requires_grad_(False))
        self.schedule: DiffusionSchedule = schedule_of(cfg.diffusion)

    def new_control(self) -> nn.Module:
        """Another control module of the pipeline's kind (fused or not),
        built as the pipeline builds its own: a condition's own tree."""
        if self.is_xs:
            raise ValueError("ControlNet-XS has no separate control module: its control "
                             "stream is part of the pipeline's XS UNet")
        with self.device:
            control = build_control(self.cfg.control, self.fuse_lora)
        return to_channels_last(control.eval().requires_grad_(False))

    def modules(self) -> List[nn.Module]:
        """The UNet (or XS UNet), the control module where there is one, the
        VAE, CLIP and the second text tower where there is one."""
        return [m for m in (self.unet, self.control, self.vae, self.clip, self.clip2)
                if m is not None]

    def load_state_dicts(self, unet, control, vae, clip) -> None:
        """Load the four state dicts (``convert.params_from_jax`` layout; the
        control dict fused, or unfused for ``fuse_lora=False``; empty for
        ControlNet-XS) with strict=True."""
        if self.control is None and control:
            raise ValueError("ControlNet-XS has no control module: its control stream's "
                             "weights are in the UNet's state dict")
        for module, sd in ((self.unet, unet), (self.control, control), (self.vae, vae),
                           (self.clip, clip)):
            if module is not None:
                module.load_state_dict(sd, strict=True)

    def cast_for_inference(self) -> None:
        """Cast the UNet, ControlNet and VAE weights to their compute dtypes
        once and derive the fused projections; CLIP stays fp32."""
        cast_params_for_inference(self.unet, self.cfg.unet.compute_dtype)
        if self.control is not None:
            cast_params_for_inference(self.control, self.cfg.control.unet.compute_dtype)
        cast_params_for_inference(self.vae, self.cfg.vae.compute_dtype)

    # ------------------------------------------------------------------
    # frozen towers
    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode_first_stage(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                           eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """img [B, H, W, 3] -> scaled latent [B, h, w, 4]: the posterior mean,
        or a posterior draw with noise `eps` (or drawn from `generator`)."""
        mean, logvar = self.vae.encode(img)
        return self._scaled_latent(mean, logvar, generator, eps)

    def first_stage_from_moments(self, moments: torch.Tensor,
                                 generator: Optional[torch.Generator] = None,
                                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``encode_first_stage`` from precomputed posterior moments (mean |
        logvar on the channel axis), with the same sampling and scaling."""
        mean, logvar = moments.float().chunk(2, dim=-1)
        return self._scaled_latent(mean, logvar, generator, eps)

    def _scaled_latent(self, mean, logvar, generator, eps) -> torch.Tensor:
        if eps is None and generator is not None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device)
        z = mean if eps is None else sample_posterior(mean, logvar, eps)
        return self.cfg.diffusion.scale_factor * z

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.cfg.diffusion.scale_factor)

    @torch.no_grad()
    def encode_text_tokens(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids [B, 77] -> context [B, 77, 768] fp32; [B, n*77] ids are
        encoded a 77-token window at a time and concatenated (the clip
        hack). With a conditioner: both towers' contexts side by side
        ([B, 77, 2048] for SDXL)."""
        if self.clip2 is not None:
            return self.encode_text_pooled(token_ids)[0]
        window = self.cfg.clip.max_length
        if token_ids.shape[1] == window:
            return self.clip(token_ids)
        return encode_windowed(self.clip, token_ids, window)

    @torch.no_grad()
    def encode_text_pooled(self, token_ids: torch.Tensor):
        """(context [B, S, sum of the towers' widths], pooled [B, P]) fp32 of
        a model with a conditioner: each tower once (spans ``text.clip_l``
        and ``text.bigg``), the pooled tower giving its projected pooled
        vector from the same forward; the contexts in ``context_order``."""
        con = self.cfg.conditioner
        out, pooled = {}, None
        for name, tower, span in (("clip", self.clip, "text.clip_l"),
                                  ("clip2", self.clip2, "text.bigg")):
            with trace.span(span):
                if name == con.pooled:
                    out[name], pooled = tower.context_and_pooled(token_ids)
                else:
                    out[name] = tower(token_ids)
        return torch.cat([out[n] for n in con.context_order], dim=-1), pooled

    def encode_text(self, prompts: Sequence[str], windows: int = 1) -> torch.Tensor:
        """Tokenize `prompts` (``windows`` 77-token windows each) on the host
        and encode them; raises on an id outside the model's vocabulary."""
        ids = default_tokenizer()(prompts, windows=windows)
        if int(ids.max()) >= self.cfg.clip.vocab_size:
            raise ValueError(f"tokenizer produced id {int(ids.max())} >= model vocab "
                             f"{self.cfg.clip.vocab_size}; config/tokenizer mismatch")
        return self.encode_text_tokens(torch.from_numpy(ids).to(self.device))

    def encode_text_cond_uncond(self, token_ids, uncond_ids):
        """The CFG pair as ONE batched CLIP call."""
        both = self.encode_text_tokens(torch.cat([token_ids, uncond_ids]))
        b = token_ids.shape[0]
        return both[:b], both[b:]

    @torch.no_grad()
    def encode_prompts(self, token_ids, uncond_ids, size_hw=None):
        """(context, uncond context, vector, uncond vector) of the CFG pair;
        the vectors None for a model without a conditioner, whose pair is
        ``encode_text_cond_uncond``'s. With one: both towers once on the
        stacked ids; an empty negative prompt (EOT right after SOT) gives a
        zero context and pooled vector (SDXL's zero negative
        conditioning); each vector is the pooled vector, then the original
        size (h, w), the crop (0, 0) and the target size (h, w) of an
        image `size_hw` = (h, w) pixels."""
        if self.clip2 is None:
            return (*self.encode_text_cond_uncond(token_ids, uncond_ids), None, None)
        b = token_ids.shape[0]
        ctx, pooled = self.encode_text_pooled(torch.cat([token_ids, uncond_ids]))
        keep = torch.cat([torch.ones(b, dtype=torch.bool, device=ctx.device),
                          uncond_ids.long().argmax(dim=-1) != 1])
        ctx = torch.where(keep[:, None, None], ctx, 0.0)
        pooled = torch.where(keep[:, None], pooled, 0.0)
        h, w = (int(v) for v in size_hw)
        sizes = torch.tensor([h, w, 0, 0, h, w], dtype=pooled.dtype, device=pooled.device)
        vector = torch.cat([pooled, sizes.expand(2 * b, 6)], dim=1)
        return ctx[:b], ctx[b:], vector[:b], vector[b:]

    def embed_vector(self, vector: torch.Tensor) -> torch.Tensor:
        """The vector conditioning [N, P + 6] -> the model's y [N, P + 6 *
        size_embed_dim] fp32: the pooled vector, then each micro-conditioning
        number's sinusoidal embedding ([cos | sin], as the time step's)."""
        d = self.cfg.conditioner.size_embed_dim
        n, p = vector.shape[0], vector.shape[1] - 6
        sizes = timestep_embedding(vector[:, p:].reshape(-1), d).reshape(n, 6 * d)
        return torch.cat([vector[:, :p].float(), sizes], dim=1)

    # ------------------------------------------------------------------
    # the denoiser
    # ------------------------------------------------------------------
    def control_of(self, cond: Conditioning) -> nn.Module:
        """The control module a condition runs: its own, else the pipeline's."""
        return self.control if cond.control is None else cond.control

    @torch.no_grad()
    def emb_proj_tables(self, timesteps: torch.Tensor, conds: Sequence[Conditioning] = (),
                        vector: Optional[torch.Tensor] = None) -> Optional[dict]:
        """Every t-dependent projection for the S sampling steps at once:
        {'unet': {res_block: [S, C]}, 'control': (one dict per cond, ...)}.
        The timestep MLP and the per-ResBlock emb_proj Linears depend only on
        the step, so the sampler computes them once, not per step. Each
        condition's rows come from its own control module and its
        ``lora_idx`` (both are LoRA sites), as in JAX. None for
        ControlNet-Lite and ControlNet-XS, as in JAX: the UNet then embeds t
        in each call.

        A model that takes y adds ``label_emb(y)`` of each row's `vector`
        [N, ...] (the model calls' stacked vectors) to the time embedding
        before the SiLU, so the rows differ by row: the tables are then
        [S, N, C]. The vector's embedding and each branch's ``label_emb``
        run once here (span ``model.vector``; counter
        ``model.vector.rows``: the N rows)."""
        if self.is_xs or self.control_mode == "encoder":
            return None
        udt, cdt = self.cfg.unet.compute_dtype, self.cfg.control.unet.compute_dtype
        branches = [(self.unet, udt, None)] + [(self.control_of(c), cdt, c.lora_idx)
                                               for c in conds]
        labels = [None] * len(branches)
        if self.cfg.unet.adm_in_channels is not None:
            if vector is None:
                raise ValueError("the model takes y: its tables need the calls' vectors")
            with trace.span("model.vector"):
                y = self.embed_vector(vector)
                labels = [module.label_emb(y, dtype)[None] for module, dtype, _ in branches]
                trace.count("model.vector.rows", vector.shape[0])

        def branch(module, dtype, lora_idx, label):
            e = module.time_embed(timesteps, dtype, lora_idx)
            x = F.silu(e if label is None else e[:, None] + label)
            return {name: block.emb_proj(x, lora_idx) for name, block in module.named_children()
                    if isinstance(block, ResBlock)}

        tables = [branch(*b, label) for b, label in zip(branches, labels)]
        return {"unet": tables[0], "control": tuple(tables[1:])}

    @torch.no_grad()
    def xattn_kv_tables(self, context: torch.Tensor,
                        conds: Sequence[Conditioning] = ()) -> Optional[dict]:
        """Every cross-attention site's k|v projection of the text context
        for a sampler's loop (JAX ``xattn_kv_tables``): {'unet': {site:
        (kv_block0, ...)}, 'control': (one dict or None per cond, ...)}.

        The context is the same at every step, so the ``ctx @ [wk|wv]``
        product of each of the 23 transformer sites at SD1.5 width (16 in
        the UNet, 7 in the ControlNet) reruns the same work every step; this
        makes it once per site, with the same product on the same operands
        as the site's own (``CrossAttention.project_kv``), so a call given
        the tables returns what it returns without them. `context` is the
        one the model calls take (CFG-stacked where they stack it), `conds`
        their conditions. Under ``parallel.tp.tensor_parallel`` each entry
        holds this rank's head columns: use the tables under the same
        context.

        None for ControlNet-XS and ControlNet-Lite, and where the UNet has
        image-prompt tokens (its context is then [text | image]), as in JAX.
        A condition whose control module carries LoRA (the unfused runtime
        path) gets None: its projections stay in the loop."""
        if self.is_xs or self.control_mode == "encoder" or self.cfg.unet.ip_tokens:
            return None

        def branch(module, dtype):
            ctx = context.to(dtype)
            out = {}
            for name, site in module.named_children():
                if not isinstance(site, SpatialTransformer):
                    continue
                attns = [getattr(site, f"block_{i}").attn2 for i in range(site.depth)]
                if any(a.lora for a in attns):
                    return None
                out[name] = tuple(a.project_kv(ctx, a.kv_cols()) for a in attns)
            return out

        cdt = self.cfg.control.unet.compute_dtype
        return {"unet": branch(self.unet, self.cfg.unet.compute_dtype),
                "control": tuple(branch(self.control_of(c), cdt) for c in conds)}

    def apply_control(self, x_noisy, t, context, conds: Sequence[Conditioning],
                      control_scales: Optional[Sequence[float]] = None,
                      emb_rows: Optional[Sequence[dict]] = None,
                      kv_rows: Optional[Sequence[Optional[dict]]] = None,
                      y: Optional[torch.Tensor] = None):
        """The control branch for each condition; each tap i scaled by
        ``control_scales[i]`` and the condition's weight (then averaged over
        H and W under ``global_average_pooling``), and the conditions
        summed, in fp32 as JAX does (a single condition at weight 1 and no
        scales keeps the compute dtype). A latent-hint ControlNet takes the
        condition's latent as its input stream; an image-hint one (and
        ControlNet-Lite) takes x_noisy, with the pixel hint beside it.
        kv_rows: each condition's entry of ``xattn_kv_tables``' 'control'.
        y: the model's y (``embed_vector``) where it takes one and no
        emb_rows are given."""
        ccfg = self.cfg.control
        total = None
        for j, cond in enumerate(conds):
            rows = emb_rows[j] if emb_rows is not None else None
            kvr = kv_rows[j] if kv_rows is not None else None
            control = self.control_of(cond)
            if ccfg.variant == "lite":
                taps = control(x_noisy, t, context, hint=cond.hint)
            elif ccfg.hint_mode == "image":
                taps = control(x_noisy, t, context, emb_rows=rows, lora_idx=cond.lora_idx,
                               hint=cond.hint, kv_rows=kvr, y=y)
            else:
                taps = control(cond.hint, t, context, emb_rows=rows, lora_idx=cond.lora_idx,
                               kv_rows=kvr, y=y)
            if control_scales is not None:
                taps = [c.float() * float(s) * cond.weight for c, s in zip(taps, control_scales)]
            elif len(conds) > 1 or cond.weight != 1.0:
                taps = [c.float() * cond.weight for c in taps]
            if self.cfg.diffusion.global_average_pooling:
                taps = [c.mean(dim=(1, 2), keepdim=True) for c in taps]
            total = list(taps) if total is None else [a + b for a, b in zip(total, taps)]
        return tuple(total)

    def apply_model(self, x_noisy, t, context, conds: Optional[Sequence[Conditioning]] = None,
                    emb_rows: Optional[Dict] = None,
                    control_scales: Optional[Sequence[float]] = None,
                    control_batch_mask: Optional[torch.Tensor] = None,
                    ip_context: Optional[torch.Tensor] = None,
                    kv_rows: Optional[Dict] = None,
                    vector: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Predicted model output (eps, or v for a v-parameterized model)
        [B, h, w, 4] fp32 for noisy latents. emb_rows: one step's rows of
        ``emb_proj_tables`` (t batch-uniform); control_scales: one factor
        per control tap (13 at SD1.5 width); control_batch_mask [B]: each
        sample's control on (1) or off (0), guess mode's uncond half.
        ip_context [B, ip_tokens, D]: image-prompt tokens appended to the
        UNet's context only; the control branch reads the text context
        (reference cldm_ctrlora_style_inference.py:163-187). A UNet with
        image tokens needs them and one without takes none: the port
        raises on either, and on a token count other than the UNet's, where
        JAX would take the last text tokens for image tokens. kv_rows:
        ``xattn_kv_tables`` of this exact `context` and `conds`. vector
        [B, P + 6]: each row's vector conditioning (``encode_prompts``) for
        a model that takes y, made y here where no emb_rows hold it.

        ControlNet-XS: one fused two-stream forward on the first
        condition's pixel hint, or the plain SD forward where there is no
        condition (JAX's XS branch). JAX silently ignores the scales, the
        mask, a condition's weight and any further condition there; the
        port raises on a mask, on scales other than ones, on a weight other
        than 1 and on more than one condition."""
        with trace.span("model.call"):
            if self.is_xs:
                if ip_context is not None or kv_rows is not None:
                    raise ValueError("ControlNet-XS takes no ip_context and no kv_rows (JAX "
                                     "ignores them)")
                return self._apply_xs(x_noisy, t, context, conds, control_scales,
                                      control_batch_mask)
            n_ip = self.cfg.unet.ip_tokens
            if (ip_context is None) != (n_ip == 0) or (n_ip and ip_context.shape[1] != n_ip):
                got = None if ip_context is None else tuple(ip_context.shape)
                raise ValueError(f"the UNet takes {n_ip} image-prompt tokens; ip_context is "
                                 f"{got}")
            y = None
            if emb_rows is None and self.cfg.unet.adm_in_channels is not None:
                if vector is None:
                    raise ValueError("the model takes y: apply_model needs the rows' vectors")
                y = self.embed_vector(vector)
            control = None
            if conds:
                with trace.span("model.control"):
                    control = self.apply_control(
                        x_noisy, t, context, conds, control_scales,
                        emb_rows=emb_rows["control"] if emb_rows is not None else None,
                        kv_rows=kv_rows["control"] if kv_rows is not None else None, y=y)
                    if control_batch_mask is not None:
                        m = control_batch_mask.reshape(-1, 1, 1, 1)
                        control = tuple(c * m.to(c.dtype) for c in control)
            if ip_context is not None:
                context = torch.cat([context, ip_context.to(context.dtype)], dim=1)
            with trace.span("model.unet"):
                return self.unet(x_noisy, t, context, control=control,
                                 emb_rows=emb_rows["unet"] if emb_rows is not None else None,
                                 only_mid_control=self.cfg.diffusion.only_mid_control,
                                 control_mode=self.control_mode,
                                 kv_rows=kv_rows["unet"] if kv_rows is not None else None,
                                 y=y)

    def _apply_xs(self, x_noisy, t, context, conds, control_scales, control_batch_mask):
        if control_batch_mask is not None:
            raise ValueError("ControlNet-XS takes no control_batch_mask (JAX ignores it)")
        if control_scales is not None and any(float(s) != 1.0 for s in control_scales):
            raise ValueError("ControlNet-XS takes no control_scales other than ones "
                             "(JAX ignores them)")
        conds = conds or []
        if len(conds) > 1 or any(c.weight != 1.0 for c in conds):
            raise ValueError("ControlNet-XS takes one condition at weight 1 (JAX uses the "
                             "first condition's hint only)")
        hint = conds[0].hint if conds else None
        with trace.span("model.unet"):
            return self.unet(x_noisy, t, context, hint=hint, no_control=not conds)
