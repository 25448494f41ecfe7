"""Plain reference of the served and trained model: SD1.5's UNet, the
CtrLoRA ControlNet (latent hint, LoRA on every Linear), the KL autoencoder
and the CLIP ViT-L/14 text tower, written from the published architecture
in plain PyTorch over a dict of weights.

It imports nothing of the program under test. The weights are the
benchmark's own seeded tensors (``benchmark/seeding.py``), keyed by the
names the checkpoints use; the reference reads every tensor in float32 and
does its own LoRA arithmetic. Activations are NCHW float32.

Precision: ``Tower(low=False)`` computes every product in float32 with TF32
off (the caller sets the backend flags, :func:`fp32_products`). With
``low=True`` it is the control: a tower the configuration serves in
bfloat16 rounds both operands of every product (matmul, conv, the two
attention products) to float8 e4m3 with a per-tensor scale, the nearest
precision below bfloat16; a float32 tower (CLIP) runs its products in TF32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_products(tf32: bool = False):
    """Products in float32 (TF32 off), or in TF32 where `tf32`; the backend
    flags are restored on leaving."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def round_e4m3(t: Tensor) -> Tensor:
    """`t` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude maps to 448), returned in float32. The rounding is of the
    forward pass only: the gradient passes through unchanged, in float32
    (rounded on the way back it would underflow to zero)."""
    t = t.float()
    d = t.detach()
    s = E4M3_MAX / d.abs().amax().clamp(min=1e-30)
    return t + ((d * s).to(torch.float8_e4m3fn).float() / s - d)


# ---------------------------------------------------------------------------
# topology (the published SD1.5 layout, from the config's numbers)
# ---------------------------------------------------------------------------

def encoder_steps(u: dict) -> List[Tuple[str, int, bool]]:
    """(kind, out channels, has attention) of each input block: 'conv', then
    per level num_res_blocks 'res' and a 'down' between levels."""
    mc = u["model_channels"]
    steps = [("conv", mc, False)]
    ds = 1
    for level, mult in enumerate(u["channel_mult"]):
        for _ in range(u["num_res_blocks"]):
            steps.append(("res", mult * mc, ds in u["attention_resolutions"]))
        if level != len(u["channel_mult"]) - 1:
            steps.append(("down", mult * mc, False))
            ds *= 2
    return steps


def decoder_steps(u: dict) -> List[Tuple[int, bool, bool]]:
    """(out channels, has attention, upsamples) of each output block."""
    mc = u["model_channels"]
    ds = 2 ** (len(u["channel_mult"]) - 1)
    out = []
    for level, mult in reversed(list(enumerate(u["channel_mult"]))):
        for i in range(u["num_res_blocks"] + 1):
            up = level > 0 and i == u["num_res_blocks"]
            out.append((mult * mc, ds in u["attention_resolutions"], up))
            if up:
                ds //= 2
    return out


def timestep_embedding(t: Tensor, dim: int, max_period: float = 10000.0) -> Tensor:
    """Sinusoidal embedding [N] -> [N, dim]: [cos | sin] of t * 10000^(-i/half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float64,
                                                           device=t.device) / half)
    args = t.double()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()


# ---------------------------------------------------------------------------
# one tower's weights and its layers
# ---------------------------------------------------------------------------

class Tower:
    """The layers of one tower over its weights `sd` (name -> tensor). A
    LoRA site (``<site>.lora_down`` [n, in, r] and ``.lora_up`` [n, r, out]
    beside ``<site>.weight``) adds (x down[slot]) up[slot]; a switchable
    bank (a leading [n] axis on a zero conv or transformer norm) gives its
    [slot] entry. ``fuse=True`` folds each LoRA into its weight once, in
    float32 (sampling: no gradient), instead of running it per call."""

    def __init__(self, sd: Dict[str, Tensor], low: bool = False, tf32: bool = False,
                 slot: int = 0, fuse: bool = False):
        self.sd, self.low, self.tf32, self.slot = sd, low and not tf32, tf32, slot
        self.fused: Dict[str, Tensor] = {}
        if fuse:
            for key in sd:
                if key.endswith(".lora_down"):
                    site = key[: -len(".lora_down")]
                    down, up = sd[key][slot].float(), sd[f"{site}.lora_up"][slot].float()
                    self.fused[site] = sd[f"{site}.weight"].float() + (down @ up).t()

    # -- parameters --------------------------------------------------------
    def p(self, key: str, ndim: int) -> Tensor:
        t = self.sd[key]
        if t.dim() == ndim + 1:  # a switchable bank: this slot's entry
            t = t[self.slot]
        return t.float()

    def has(self, key: str) -> bool:
        return key in self.sd

    # -- products ----------------------------------------------------------
    def _q(self, t: Tensor) -> Tensor:
        return round_e4m3(t) if self.low else t

    def matmul(self, a: Tensor, b: Tensor) -> Tensor:
        return self._q(a) @ self._q(b)

    def linear(self, x: Tensor, site: str, bias: bool = True) -> Tensor:
        if site in self.fused:
            w = self.fused[site]
        else:
            w = self.p(f"{site}.weight", 2)
        y = self.matmul(x, w.t())
        if site not in self.fused and self.has(f"{site}.lora_down"):
            down = self.sd[f"{site}.lora_down"][self.slot].float()
            up = self.sd[f"{site}.lora_up"][self.slot].float()
            y = y + self.matmul(self.matmul(x, down), up)
        if bias and self.has(f"{site}.bias"):
            y = y + self.p(f"{site}.bias", 1)
        return y

    def conv(self, x: Tensor, site: str, stride: int = 1, padding: Optional[int] = None
             ) -> Tensor:
        w = self.p(f"{site}.weight", 4)
        if padding is None:
            padding = (w.shape[-1] - 1) // 2
        b = self.p(f"{site}.bias", 1) if self.has(f"{site}.bias") else None
        return F.conv2d(self._q(x), self._q(w), b, stride=stride, padding=padding)

    def group_norm(self, x: Tensor, site: str, eps: float, silu: bool,
                   add_row: Optional[Tensor] = None, groups: int = 32) -> Tensor:
        if add_row is not None:
            x = x + add_row[:, :, None, None]
        b, c = x.shape[:2]
        g = groups if c % groups == 0 else math.gcd(c, groups)
        xg = x.reshape(b, g, -1)
        mean = xg.mean(-1, keepdim=True)
        var = (xg - mean).square().mean(-1, keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
        y = y * self.p(f"{site}.weight", 1)[None, :, None, None] + \
            self.p(f"{site}.bias", 1)[None, :, None, None]
        return F.silu(y) if silu else y

    def layer_norm(self, x: Tensor, site: str, eps: float = 1e-5) -> Tensor:
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + eps) * self.p(f"{site}.weight", 1) + \
            self.p(f"{site}.bias", 1)

    def attention(self, q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor] = None,
                  scale: Optional[float] = None) -> Tensor:
        """softmax(q k^T * scale + mask) v over [B, H, S, D]."""
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        logits = self.matmul(q, k.transpose(-1, -2)) * scale
        if mask is not None:
            logits = logits + mask
        return self.matmul(torch.softmax(logits, dim=-1), v)


# ---------------------------------------------------------------------------
# UNet and ControlNet
# ---------------------------------------------------------------------------

class UNetRef:
    """SD1.5's UNet (``unet`` weights) and the CtrLoRA ControlNet
    (``control`` weights): `u` is the UNet section of the configuration."""

    def __init__(self, u: dict, unet: Tower, control: Optional[Tower]):
        self.u, self.unet, self.control = u, unet, control
        self.enc = encoder_steps(u)
        self.dec = decoder_steps(u)

    def time_embed(self, tw: Tower, t: Tensor) -> Tensor:
        e = timestep_embedding(t, self.u["model_channels"])
        return tw.linear(F.silu(tw.linear(e, "time_embed.dense0")), "time_embed.dense1")

    def res(self, tw: Tower, site: str, x: Tensor, emb: Tensor) -> Tensor:
        h = tw.conv(tw.group_norm(x, f"{site}.in_norm", 1e-5, True), f"{site}.in_conv")
        row = tw.linear(F.silu(emb), f"{site}.emb_proj")
        h = tw.conv(tw.group_norm(h, f"{site}.out_norm", 1e-5, True, add_row=row),
                    f"{site}.out_conv")
        if tw.has(f"{site}.skip.weight"):
            x = tw.conv(x, f"{site}.skip")
        return x + h

    def attn(self, tw: Tower, site: str, x: Tensor, ctx: Optional[Tensor]) -> Tensor:
        heads = self.u["num_heads"]
        b, s, _ = x.shape
        src = x if ctx is None else ctx
        split = lambda t: t.reshape(b, t.shape[1], heads, -1).transpose(1, 2)
        q = split(tw.linear(x, f"{site}.to_q", bias=False))
        k = split(tw.linear(src, f"{site}.to_k", bias=False))
        v = split(tw.linear(src, f"{site}.to_v", bias=False))
        out = tw.attention(q, k, v).transpose(1, 2).reshape(b, s, -1)
        return tw.linear(out, f"{site}.to_out")

    def transformer(self, tw: Tower, site: str, x: Tensor, ctx: Tensor) -> Tensor:
        b, c, hh, ww = x.shape
        x_in = x
        h = tw.conv(tw.group_norm(x, f"{site}.norm", 1e-6, False), f"{site}.proj_in")
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, -1)
        for i in range(self.u["transformer_depth"]):
            blk = f"{site}.block_{i}"
            h = h + self.attn(tw, f"{blk}.attn1", tw.layer_norm(h, f"{blk}.norm1"), None)
            h = h + self.attn(tw, f"{blk}.attn2", tw.layer_norm(h, f"{blk}.norm2"), ctx)
            a, gate = tw.linear(tw.layer_norm(h, f"{blk}.norm3"), f"{blk}.ff.proj").chunk(2, -1)
            h = h + tw.linear(a * F.gelu(gate), f"{blk}.ff.out")
        h = h.reshape(b, hh, ww, -1).permute(0, 3, 1, 2)
        return tw.conv(h, f"{site}.proj_out") + x_in

    def encoder(self, tw: Tower, x: Tensor, emb: Tensor, ctx: Tensor, taps: bool
                ) -> Tuple[Tensor, List[Tensor]]:
        """in_conv and the input blocks, then the middle. Returns (middle
        output, the list): the skips (UNet) or the 13 zero-conv taps
        (ControlNet, `taps`)."""
        h = tw.conv(x, "in_conv")
        outs = [tw.conv(h, "zero_0") if taps else h]
        for i, (kind, _, has_attn) in enumerate(self.enc[1:], start=1):
            if kind == "res":
                h = self.res(tw, f"in_{i}_res", h, emb)
                if has_attn:
                    h = self.transformer(tw, f"in_{i}_attn", h, ctx)
            else:
                h = tw.conv(h, f"in_{i}_down.conv", stride=2)
            outs.append(tw.conv(h, f"zero_{i}") if taps else h)
        h = self.res(tw, "mid_res0", h, emb)
        h = self.transformer(tw, "mid_attn", h, ctx)
        h = self.res(tw, "mid_res1", h, emb)
        if taps:
            outs.append(tw.conv(h, "zero_mid"))
        return h, outs

    def control_taps(self, hint_latent: Tensor, t: Tensor, ctx: Tensor) -> List[Tensor]:
        """The ControlNet's 13 taps [B, C, h, w] from the hint latent
        [B, 4, h, w] (CtrLoRA's latent hint is the branch's input)."""
        emb = self.time_embed(self.control, t)
        return self.encoder(self.control, hint_latent, emb, ctx, taps=True)[1]

    def __call__(self, x: Tensor, t: Tensor, ctx: Tensor,
                 control: Optional[Sequence[Tensor]] = None) -> Tensor:
        """Model output [B, 4, h, w] for the noisy latent x [B, 4, h, w]; the
        taps add onto the skips (reversed) and the middle output."""
        tw = self.unet
        emb = self.time_embed(tw, t)
        h, skips = self.encoder(tw, x, emb, ctx, taps=False)
        n = len(skips)
        if control is not None:
            h = h + control[n]
        for i, (_, has_attn, up) in enumerate(self.dec):
            skip = skips.pop()
            if control is not None:
                skip = skip + control[n - 1 - i]
            h = self.res(tw, f"out_{i}_res", torch.cat([h, skip], dim=1), emb)
            if has_attn:
                h = self.transformer(tw, f"out_{i}_attn", h, ctx)
            if up:
                h = tw.conv(F.interpolate(h, scale_factor=2.0, mode="nearest"),
                            f"out_{i}_up.conv")
        return tw.conv(tw.group_norm(h, "norm_out", 1e-5, True), "conv_out")

    def controlled(self, x: Tensor, t: Tensor, ctx: Tensor, hint_latent: Tensor,
                   scales: Optional[Sequence[float]] = None) -> Tensor:
        """The UNet with the ControlNet's taps, each times its scale."""
        taps = self.control_taps(hint_latent, t, ctx)
        if scales is not None:
            taps = [c * float(s) for c, s in zip(taps, scales)]
        return self(x, t, ctx, taps)


# ---------------------------------------------------------------------------
# the KL autoencoder
# ---------------------------------------------------------------------------

class VAERef:
    """AutoencoderKL (``vae`` weights; `v` the configuration's VAE section):
    GroupNorm eps 1e-6, single-head attention at the bottleneck."""

    def __init__(self, v: dict, tw: Tower):
        self.v, self.tw = v, tw

    def res(self, site: str, x: Tensor) -> Tensor:
        tw = self.tw
        h = tw.conv(tw.group_norm(x, f"{site}.norm1", 1e-6, True), f"{site}.conv1")
        h = tw.conv(tw.group_norm(h, f"{site}.norm2", 1e-6, True), f"{site}.conv2")
        if tw.has(f"{site}.nin_shortcut.weight"):
            x = tw.conv(x, f"{site}.nin_shortcut")
        return x + h

    def attn(self, site: str, x: Tensor) -> Tensor:
        tw = self.tw
        b, c, hh, ww = x.shape
        h = tw.group_norm(x, f"{site}.norm", 1e-6, False)
        seq = lambda t: t.reshape(b, c, hh * ww).transpose(1, 2)[:, None]
        q, k, v = (seq(tw.conv(h, f"{site}.{n}")) for n in ("q", "k", "v"))
        out = tw.attention(q, k, v)[:, 0].transpose(1, 2).reshape(b, c, hh, ww)
        return x + tw.conv(out, f"{site}.proj_out")

    def mid(self, pre: str, h: Tensor) -> Tensor:
        h = self.res(f"{pre}.mid_block_1", h)
        return self.res(f"{pre}.mid_block_2", self.attn(f"{pre}.mid_attn_1", h))

    def encode(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """x [B, 3, H, W] -> (mean, logvar clipped to [-30, 20]) [B, 4, h, w]."""
        v, tw = self.v, self.tw
        h = tw.conv(x, "encoder.conv_in")
        for level in range(len(v["ch_mult"])):
            for i in range(v["num_res_blocks"]):
                h = self.res(f"encoder.down_{level}_block_{i}", h)
            if level != len(v["ch_mult"]) - 1:
                h = tw.conv(F.pad(h, (0, 1, 0, 1)), f"encoder.down_{level}_downsample",
                            stride=2, padding=0)
        h = self.mid("encoder", h)
        h = tw.conv(tw.group_norm(h, "encoder.norm_out", 1e-6, True), "encoder.conv_out")
        mean, logvar = tw.conv(h, "quant_conv").chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: Tensor) -> Tensor:
        """z [B, 4, h, w] -> image [B, 3, H, W]."""
        v, tw = self.v, self.tw
        h = self.mid("decoder", tw.conv(tw.conv(z, "post_quant_conv"), "decoder.conv_in"))
        for level in reversed(range(len(v["ch_mult"]))):
            for i in range(v["num_res_blocks"] + 1):
                h = self.res(f"decoder.up_{level}_block_{i}", h)
            if level != 0:
                h = tw.conv(F.interpolate(h, scale_factor=2.0, mode="nearest"),
                            f"decoder.up_{level}_upsample")
        return tw.conv(tw.group_norm(h, "decoder.norm_out", 1e-6, True), "decoder.conv_out")


# ---------------------------------------------------------------------------
# the CLIP text tower
# ---------------------------------------------------------------------------

class CLIPRef:
    """CLIP ViT-L/14's text transformer (``clip`` weights; `c` the
    configuration's CLIP section): causal self-attention, quick-GELU MLP,
    the final LayerNorm's output for every token."""

    def __init__(self, c: dict, tw: Tower):
        self.c, self.tw = c, tw

    def __call__(self, ids: Tensor) -> Tensor:
        c, tw = self.c, self.tw
        heads = c["num_heads"]
        b, s = ids.shape
        x = tw.p("token_embedding", 2)[ids.long().clamp(0, c["vocab_size"] - 1)] + \
            tw.p("position_embedding", 2)[None, :s]
        mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        split = lambda t: t.reshape(b, s, heads, -1).transpose(1, 2)
        for i in range(c["num_layers"]):
            pre = f"layer_{i}"
            h = tw.layer_norm(x, f"{pre}.layer_norm1")
            q, k, v = (split(tw.linear(h, f"{pre}.self_attn.{n}_proj")) for n in "qkv")
            out = tw.attention(q, k, v, mask).transpose(1, 2).reshape(b, s, -1)
            x = x + tw.linear(out, f"{pre}.self_attn.out_proj")
            h = tw.linear(tw.layer_norm(x, f"{pre}.layer_norm2"), f"{pre}.fc1")
            x = x + tw.linear(h * torch.sigmoid(1.702 * h), f"{pre}.fc2")
        return tw.layer_norm(x, "final_layer_norm")


def nchw(t: Tensor) -> Tensor:
    return t.permute(0, 3, 1, 2)


def nhwc(t: Tensor) -> Tensor:
    return t.permute(0, 2, 3, 1)
