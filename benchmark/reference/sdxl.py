"""Plain reference of SDXL base 1.0 with its ControlNet: the UNet, the
pixel-hint ControlNet, both text towers and the vector conditioning y,
written from the published description (arXiv 2307.01952;
generative-models ``configs/inference/sd_xl_base.yaml``;
diffusers/controlnet-canny-sdxl-1.0) in plain PyTorch over a dict of
weights. The KL autoencoder and the products, norms and ResBlock are
``sd15``'s.

It imports nothing of the program under test. The weights are the
benchmark's seeded tensors keyed by the checkpoint names the program's
state dicts use; every tensor is read in float32. Activations are NCHW
float32. Precision is ``sd15``'s: float32 products with TF32 off
(:func:`~benchmark.reference.sd15.fp32_products`), or with ``low=True`` the
control: float8 e4m3 operands in every product of the bf16 towers and TF32
in the float32 text towers.

The architecture, as written here:

- UNet: ``model_channels`` x ``channel_mult``, ``num_res_blocks`` ResBlocks
  a level, a transformer after each ResBlock of a level in
  ``attention_resolutions`` with ``transformer_depth[level]`` blocks, the
  middle with the last level's; heads ``num_head_channels`` wide; GroupNorm
  then Linear ``proj_in`` on the [B, HW, C] rows, the blocks
  (self-attention, cross-attention on the 2048-wide context, GEGLU x4, each
  after a LayerNorm), Linear ``proj_out``, plus the input. The time
  embedding plus ``label_emb(y)`` (Linear, SiLU, Linear) feeds every
  ResBlock.
- ControlNet: the UNet's encoder and middle with their own weights and
  ``label_emb``; the pixel hint through seven 3x3 convs with SiLU (16, 16,
  32, 32, 96, 96, 256 wide, stride 2 at the third, fifth and seventh) and a
  3x3 conv to ``model_channels``, added after ``in_conv``; a 1x1 zero conv
  after ``in_conv`` and after every input block, and one after the middle:
  10 taps at three levels, added onto the UNet's skips (last first) and its
  middle output, each times the control strength.
- Text: CLIP ViT-L/14 (quick-GELU) and OpenCLIP ViT-bigG/14 (GELU), causal;
  each tower's context is the state entering its last layer, without the
  final LayerNorm; the two concatenate on the channel axis (``clip``
  first). The pooled vector is bigG's final LayerNorm output at each row's
  EOT token (the row's largest id) times ``text_projection``.
- y: the pooled vector, then original size (h, w), crop (top, left) and
  target size (h, w), each number a 256-wide [cos | sin] sinusoidal
  embedding: 1280 + 6 x 256 = 2816.
- An empty negative prompt gives a zero context and pooled vector; its size
  embeddings stay (generative-models' ``force_uc_zero_embeddings``,
  diffusers' ``force_zeros_for_empty_prompt``).

Departures from the published model: the weights are seeded, not the
published files; both towers read one row of ids, padded with EOT (the
OpenCLIP tokenizer pads with 0; before the EOT token, which the causal
mask and the pooling read, the two agree); ``text_projection`` is read as a
Linear weight [out, in], the transpose of OpenCLIP's [in, out] matrix
(seeded, it is the same distribution); the empty prompt is recognised by
its ids (EOT right after SOT).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.sd15 import Tower, UNetRef, VAERef, fp32_products, nhwc, \
    timestep_embedding

Tensor = torch.Tensor

# the pixel hint's 3x3 convs: (width, stride), each followed by SiLU
HINT_WIDTHS = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))


def encoder_levels(u: dict) -> List[Tuple[str, int, int]]:
    """(kind, out channels, level) of each input block: 'conv', then per
    level num_res_blocks 'res' and a 'down' between levels."""
    mc = u["model_channels"]
    steps = [("conv", mc, 0)]
    for level, mult in enumerate(u["channel_mult"]):
        steps += [("res", mult * mc, level)] * u["num_res_blocks"]
        if level != len(u["channel_mult"]) - 1:
            steps.append(("down", mult * mc, level))
    return steps


def decoder_levels(u: dict) -> List[Tuple[int, int, bool]]:
    """(out channels, level, upsamples) of each output block."""
    out = []
    for level, mult in reversed(list(enumerate(u["channel_mult"]))):
        for i in range(u["num_res_blocks"] + 1):
            out.append((mult * u["model_channels"], level,
                        level > 0 and i == u["num_res_blocks"]))
    return out


def depth_at(u: dict, level: int) -> int:
    d = u["transformer_depth"]
    return d if isinstance(d, int) else d[level]


def has_attn(u: dict, level: int) -> bool:
    return 2 ** level in u["attention_resolutions"]


class SDXLUNetRef(UNetRef):
    """SDXL's UNet (``unet`` weights) and its ControlNet (``control``
    weights); `u` the UNet section of the configuration (the ControlNet's
    has the same widths)."""

    def __init__(self, u: dict, unet: Tower, control: Optional[Tower]):
        super().__init__(u, unet, control)
        self.enc_l = encoder_levels(u)
        self.dec_l = decoder_levels(u)

    def embed(self, tw: Tower, t: Tensor, y: Tensor) -> Tensor:
        """The time embedding plus label_emb(y)."""
        lab = tw.linear(F.silu(tw.linear(y, "label_emb.dense0")), "label_emb.dense1")
        return self.time_embed(tw, t) + lab

    def attn(self, tw: Tower, site: str, x: Tensor, ctx: Optional[Tensor]) -> Tensor:
        b, s, c = x.shape
        heads = c // self.u["num_head_channels"]
        src = x if ctx is None else ctx
        split = lambda t: t.reshape(b, t.shape[1], heads, -1).transpose(1, 2)
        q = split(tw.linear(x, f"{site}.to_q", bias=False))
        k = split(tw.linear(src, f"{site}.to_k", bias=False))
        v = split(tw.linear(src, f"{site}.to_v", bias=False))
        out = tw.attention(q, k, v).transpose(1, 2).reshape(b, s, -1)
        return tw.linear(out, f"{site}.to_out")

    def transformer_at(self, tw: Tower, site: str, x: Tensor, ctx: Tensor, depth: int
                       ) -> Tensor:
        b, c, hh, ww = x.shape
        h = tw.group_norm(x, f"{site}.norm", 1e-6, False)
        h = tw.linear(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c), f"{site}.proj_in")
        for i in range(depth):
            blk = f"{site}.block_{i}"
            h = h + self.attn(tw, f"{blk}.attn1", tw.layer_norm(h, f"{blk}.norm1"), None)
            h = h + self.attn(tw, f"{blk}.attn2", tw.layer_norm(h, f"{blk}.norm2"), ctx)
            a, gate = tw.linear(tw.layer_norm(h, f"{blk}.norm3"), f"{blk}.ff.proj").chunk(2, -1)
            h = h + tw.linear(a * F.gelu(gate), f"{blk}.ff.out")
        h = tw.linear(h, f"{site}.proj_out")
        return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x

    def hint_block(self, tw: Tower, hint: Tensor) -> Tensor:
        """Pixel hint [B, 3, H, W] -> [B, model_channels, H/8, W/8]."""
        h = hint
        for i, (_, stride) in enumerate(HINT_WIDTHS):
            h = F.silu(tw.conv(h, f"hint_block.conv_{i}", stride=stride))
        return tw.conv(h, "hint_block.conv_out")

    def encoder_xl(self, tw: Tower, x: Tensor, emb: Tensor, ctx: Tensor,
                   hint: Optional[Tensor] = None) -> Tuple[Tensor, List[Tensor]]:
        """in_conv (plus the hint's features where `hint` is given: the
        ControlNet), the input blocks and the middle -> (middle output, the
        skips, or the ControlNet's 10 zero-conv taps)."""
        taps = hint is not None
        u = self.u
        h = tw.conv(x, "in_conv")
        if taps:
            h = h + self.hint_block(tw, hint)
        outs = [tw.conv(h, "zero_0") if taps else h]
        for i, (kind, _, level) in enumerate(self.enc_l[1:], start=1):
            if kind == "res":
                h = self.res(tw, f"in_{i}_res", h, emb)
                if has_attn(u, level):
                    h = self.transformer_at(tw, f"in_{i}_attn", h, ctx, depth_at(u, level))
            else:
                h = tw.conv(h, f"in_{i}_down.conv", stride=2)
            outs.append(tw.conv(h, f"zero_{i}") if taps else h)
        h = self.res(tw, "mid_res0", h, emb)
        h = self.transformer_at(tw, "mid_attn", h, ctx, depth_at(u, -1))
        h = self.res(tw, "mid_res1", h, emb)
        if taps:
            outs.append(tw.conv(h, "zero_mid"))
        return h, outs

    def taps(self, x: Tensor, t: Tensor, ctx: Tensor, y: Tensor, hint: Tensor) -> List[Tensor]:
        """The ControlNet's taps [B, C, h, w] for the noisy latent x and the
        pixel hint [B, 3, 8h, 8w]."""
        emb = self.embed(self.control, t, y)
        return self.encoder_xl(self.control, x, emb, ctx, hint)[1]

    def unet_xl(self, x: Tensor, t: Tensor, ctx: Tensor, y: Tensor,
                control: Optional[Sequence[Tensor]] = None) -> Tensor:
        """Model output [B, 4, h, w]; the taps add onto the skips (reversed)
        and the middle output."""
        tw = self.unet
        emb = self.embed(tw, t, y)
        h, skips = self.encoder_xl(tw, x, emb, ctx)
        n = len(skips)
        if control is not None:
            h = h + control[n]
        for i, (_, level, up) in enumerate(self.dec_l):
            skip = skips.pop()
            if control is not None:
                skip = skip + control[n - 1 - i]
            h = self.res(tw, f"out_{i}_res", torch.cat([h, skip], dim=1), emb)
            if has_attn(self.u, level):
                h = self.transformer_at(tw, f"out_{i}_attn", h, ctx, depth_at(self.u, level))
            if up:
                h = tw.conv(F.interpolate(h, scale_factor=2.0, mode="nearest"),
                            f"out_{i}_up.conv")
        return tw.conv(tw.group_norm(h, "norm_out", 1e-5, True), "conv_out")

    def controlled_xl(self, x: Tensor, t: Tensor, ctx: Tensor, y: Tensor, hint: Tensor,
                      strength: float = 1.0) -> Tensor:
        taps = [c * float(strength) for c in self.taps(x, t, ctx, y, hint)]
        return self.unet_xl(x, t, ctx, y, taps)


class TextTowerRef:
    """A causal CLIP text transformer (``clip`` or ``clip2`` weights; `c`
    its configuration section): the context is the state entering layer
    ``layer_idx`` (no final LayerNorm); the pooled vector is the final
    LayerNorm of the last layer's output at each row's EOT token, times
    ``text_projection``."""

    def __init__(self, c: dict, tw: Tower):
        self.c, self.tw = c, tw

    def states(self, ids: Tensor, stop: int) -> Tensor:
        """The state entering layer `stop` (the last layer's output at
        ``num_layers``)."""
        c, tw = self.c, self.tw
        heads = c["num_heads"]
        b, s = ids.shape
        x = tw.p("token_embedding", 2)[ids.long().clamp(0, c["vocab_size"] - 1)] + \
            tw.p("position_embedding", 2)[None, :s]
        mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        split = lambda t: t.reshape(b, s, heads, -1).transpose(1, 2)
        for i in range(stop):
            pre = f"layer_{i}"
            h = tw.layer_norm(x, f"{pre}.layer_norm1")
            q, k, v = (split(tw.linear(h, f"{pre}.self_attn.{n}_proj")) for n in "qkv")
            out = tw.attention(q, k, v, mask).transpose(1, 2).reshape(b, s, -1)
            x = x + tw.linear(out, f"{pre}.self_attn.out_proj")
            h = tw.linear(tw.layer_norm(x, f"{pre}.layer_norm2"), f"{pre}.fc1")
            act = h * torch.sigmoid(1.702 * h) if c["hidden_act"] == "quick_gelu" else F.gelu(h)
            x = x + tw.linear(act, f"{pre}.fc2")
        return x

    def context(self, ids: Tensor) -> Tensor:
        idx = self.c["layer_idx"]
        return self.states(ids, self.c["num_layers"] + idx if idx < 0 else idx)

    def pooled(self, ids: Tensor) -> Tensor:
        final = self.tw.layer_norm(self.states(ids, self.c["num_layers"]), "final_layer_norm")
        rows = final[torch.arange(ids.shape[0], device=ids.device), ids.long().argmax(-1)]
        return self.tw.linear(rows, "text_projection", bias=False)


def size_embedding(sizes: Tensor, dim: int) -> Tensor:
    """[N, 6] micro-conditioning numbers -> [N, 6 dim]: each number's
    sinusoidal embedding, in order."""
    return timestep_embedding(sizes.reshape(-1).double(), dim).reshape(sizes.shape[0], -1)


def empty_rows(ids: Tensor) -> Tensor:
    """[B] bool: the rows whose EOT token (the largest id) follows SOT."""
    return ids.long().argmax(-1) == 1


class SDXLReference:
    """SDXL's towers over the benchmark's raw weights (`weights`: {'unet',
    'control', 'vae', 'clip', 'clip2'} -> name -> tensor) and the
    configuration's model section `m`. `low`: the control."""

    def __init__(self, m: dict, weights: Dict[str, Dict[str, Tensor]], low: bool = False):
        self.m = m
        tw = lambda k, tf32=False: Tower(weights[k], low=low, tf32=tf32 and low)
        self.unet = SDXLUNetRef(m["unet"], tw("unet"), tw("control"))
        self.vae = VAERef(m["vae"], tw("vae"))
        con = m["conditioner"]
        self.towers = {"clip": TextTowerRef(m["clip"], tw("clip", True)),
                       "clip2": TextTowerRef(con["clip2"], tw("clip2", True))}
        self.text_tf32 = low
        self.scale_factor = m["diffusion"]["scale_factor"]

    def text(self, ids: Tensor) -> Tuple[Tensor, Tensor]:
        """Token ids [B, 77] -> (context [B, 77, 2048], pooled [B, 1280])."""
        con = self.m["conditioner"]
        with fp32_products(tf32=self.text_tf32):
            ctx = torch.cat([self.towers[n].context(ids) for n in con["context_order"]], -1)
            return ctx, self.towers[con["pooled"]].pooled(ids)

    def vector(self, pooled: Tensor, size_hw: Tuple[int, int]) -> Tensor:
        """y [B, 2816] of pooled vectors at an image of `size_hw` pixels."""
        h, w = size_hw
        sizes = torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float64, device=pooled.device)
        return self.y_of(torch.cat([pooled.double(), sizes.expand(pooled.shape[0], 6)], 1))

    def y_of(self, vector: Tensor) -> Tensor:
        """y of vectors [B, P + 6] as the program carries them: the pooled
        vector, then the six micro-conditioning numbers."""
        dim = self.m["conditioner"]["size_embed_dim"]
        return torch.cat([vector[:, :-6].float(), size_embedding(vector[:, -6:], dim)], 1)

    def prompts(self, ids: Tensor, nids: Tensor, size_hw: Tuple[int, int]
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """(context, uncond context, y, uncond y): the empty negative rows'
        context and pooled vector zeros."""
        ctx, pooled = self.text(ids)
        unc, upooled = self.text(nids)
        keep = (~empty_rows(nids)).float()
        unc, upooled = unc * keep[:, None, None], upooled * keep[:, None]
        return ctx, unc, self.vector(pooled, size_hw), self.vector(upooled, size_hw)

    def pixels(self, z: Tensor) -> Tensor:
        """Latents [B, h, w, 4] -> images [B, H, W, 3] in about [-1, 1]."""
        return nhwc(self.vae.decode(z.float().permute(0, 3, 1, 2) / self.scale_factor))


def guided_eps_xl(model: SDXLUNetRef, x: Tensor, t: int, ctx: Tensor, unc: Tensor, y: Tensor,
                  uy: Tensor, hint: Tensor, scale: float, strength: float) -> Tensor:
    """eps_u + scale (eps_c - eps_u) for latents x [B, 4, h, w] at timestep
    t: the cond and uncond halves in one call, the pixel hint [B, 3, H, W]
    feeding both, every tap times `strength`."""
    b = x.shape[0]
    tv = torch.full((2 * b,), int(t), device=x.device)
    out = model.controlled_xl(torch.cat([x, x]), tv, torch.cat([ctx, unc]), torch.cat([y, uy]),
                              torch.cat([hint, hint]), strength)
    return out[b:] + scale * (out[:b] - out[b:])

