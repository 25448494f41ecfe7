"""ZoeDepth metric-depth estimator (counterpart of
``ctrlora_tpu/annotators/zoe.py``; reference annotator/zoe: ZoeD_M12_N.pt,
isl-org/ZoeDepth).

* Backbone: BEiT-L/16 (midas_repo backbones/beit.py). Each block has its
  own relative-position bias table, resized to the runtime window and
  gathered by ``gen_relative_position_index`` (timm's); separate q and v
  biases with the k bias fixed at zero; layer-scale gammas; taps at blocks
  5/11/17/23.
* Neck: MiDaS's DPT neck with the 'project' readout (the port's
  ``midas.act_postprocess``, ``FeatureFusionBlock``, ``Up2``), whose head
  gives the relative depth and the 32-channel activation the metric head
  reads.
* Metric head (models/zoedepth/zoedepth_v1.py): the seed bin regressor
  (softplus, 64 bins), the projectors, four attractors of kind 'mean' with
  alpha 300 and gamma 2 (the reference calls ``inv_attractor`` bare, so its
  defaults hold, not the config's 1000) and the conditional log-binomial
  between MIN_TEMP and MAX_TEMP; depth = sum(probs * bin centres).
* Protocol (models/depth_model.py): reflect padding, the 'minimal' resize to
  [384, 512] in multiples of 32 (bilinear, align_corners=True), the average
  over the horizontal flip (the image and its flip run as one batch of 2),
  the bicubic resize back (``F.interpolate``, the reference's own op; JAX's
  ``_resize_bicubic`` computes the same taps), then the 2/85 percentile
  stretch, inverted, to uint8.

The module keeps ZoeD_M12_N.pt's key names (``core.core.pretrained.*``,
``core.core.scratch.*``, the head's ``conv2``, ``seed_*``, ``projectors``,
``attractors``, ``conditional_log_binomial``); the file's other entries
(timm's index buffers, the classifier) are left out before the strict load,
as JAX's ``convert_zoe`` reads only these. The widths are this module's
constants, read when a net is built. The 2x and bin up-samplings are
``F.interpolate(bilinear, align_corners=True)``; JAX builds their grids in
float32 numpy, up to one float32 ulp of (H - 1) apart (see ``mlsd.py``).
No file, no net: the detector raises FileNotFoundError, as JAX's does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators.midas import (
    FeatureFusionBlock, Mlp, PatchEmbed, Up2, act_postprocess,
)
from ctrlora_tpu_torch.annotators.normalbae import up_ac
from ctrlora_tpu_torch.annotators.uniformer import resize
from ctrlora_tpu_torch.utils.precision import fp32_exact

# BEiT-L/16 at 384 px and its DPT neck: the published widths
BEIT_DIM = 1024
BEIT_LAYERS = 24
BEIT_HEADS = 16
HOOKS = (5, 11, 17, 23)
REASSEMBLE = (256, 512, 1024, 1024)
FEATURES = 256
PATCH = 16  # midas.PatchEmbed's
TRAIN_WINDOW = 24  # 384 // 16: the window the bias tables were trained at
# the metric head (zoedepth_v1.py, config_zoedepth.json)
N_BINS = 64
BIN_EMBED = 128
SEED_MLP = 256
ATTRACTORS = (16, 8, 4, 1)
ATTR_ALPHA = 300.0
ATTR_GAMMA = 2
MIN_TEMP = 0.0212
MAX_TEMP = 50.0

FILE = "ZoeD_M12_N.pt"


def gen_relative_position_index(wh: int, ww: int) -> np.ndarray:
    """timm.models.beit.gen_relative_position_index: [n + 1, n + 1] indices
    into the bias table for a wh x ww window plus the class token."""
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    n = wh * ww
    idx = np.zeros((n + 1, n + 1), np.int32)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


@functools.lru_cache(maxsize=8)
def _index(wh: int, ww: int) -> torch.Tensor:
    return torch.from_numpy(gen_relative_position_index(wh, ww).astype(np.int64)).reshape(-1)


def rel_pos_bias(table: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """[1, heads, n + 1, n + 1]: the (2*24-1)^2 + 3 table with its grid part
    resized bilinearly (align_corners=False) to the runtime window, then
    gathered (midas_repo beit.py:29-61: the table reshaped (width, height)
    before the resize; the two sides are equal at 47)."""
    old = 2 * TRAIN_WINDOW - 1
    nh, nw = 2 * wh - 1, 2 * ww - 1
    heads = table.shape[1]
    sub = table[:old * old]
    if (nh, nw) != (old, old):
        grid = sub.reshape(1, old, old, heads).permute(0, 3, 1, 2)
        sub = resize(grid, (nh, nw)).permute(0, 2, 3, 1).reshape(nh * nw, heads)
    full = torch.cat([sub, table[old * old:]], dim=0)
    n = wh * ww + 1
    bias = full[_index(wh, ww).to(table.device)].reshape(n, n, heads)
    return bias.permute(2, 0, 1)[None]


class BeitAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * TRAIN_WINDOW - 1) ** 2 + 3, heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, gh: int, gw: int):
        b, s, d = x.shape
        hd = d // self.heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        q, k, v = F.linear(x, self.qkv.weight, bias).reshape(
            b, s, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        logits = (q * hd ** -0.5) @ k.transpose(-2, -1)
        w = torch.softmax(logits + rel_pos_bias(self.relative_position_bias_table, gh, gw), -1)
        return self.proj((w @ v).transpose(1, 2).reshape(b, s, d))


class BeitBlock(nn.Module):
    """timm's BEiT block: pre-norm (LayerNorm eps 1e-6), layer-scale gammas."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.gamma_2 = nn.Parameter(torch.ones(dim))

    def forward(self, x, gh: int, gw: int):
        x = x + self.gamma_1 * self.attn(self.norm1(x), gh, gw)
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class Beit(nn.Module):
    def __init__(self, dim: int, layers: int, heads: int):
        super().__init__()
        self.patch_embed = PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.blocks = nn.ModuleList(BeitBlock(dim, heads) for _ in range(layers))


class DPTBeit(nn.Module):
    """x [B, 3, H, W] (H, W multiples of 32, scaled to [-1, 1]) -> (the
    relative depth [B, 1, H, W], the 32-channel head activation, the
    bottleneck ``layer4_rn``, the refinenet outputs 4..1)."""

    def __init__(self):
        super().__init__()
        self.hooks = tuple(HOOKS)
        self.pretrained = nn.Module()
        self.pretrained.model = Beit(BEIT_DIM, BEIT_LAYERS, BEIT_HEADS)
        for lvl, width in enumerate(REASSEMBLE):
            self.pretrained.add_module(f"act_postprocess{lvl + 1}",
                                       act_postprocess(BEIT_DIM, width, lvl))
        self.scratch = nn.Module()
        for lvl, width in enumerate(REASSEMBLE):
            self.scratch.add_module(f"layer{lvl + 1}_rn",
                                    nn.Conv2d(width, FEATURES, 3, padding=1, bias=False))
            self.scratch.add_module(f"refinenet{lvl + 1}", FeatureFusionBlock(FEATURES))
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(FEATURES, FEATURES // 2, 3, padding=1), Up2(),
            nn.Conv2d(FEATURES // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1),
            nn.ReLU())

    def forward(self, x):
        beit = self.pretrained.model
        b, gh, gw = x.shape[0], x.shape[2] // PATCH, x.shape[3] // PATCH
        h = beit.patch_embed.proj(x).flatten(2).transpose(1, 2)
        h = torch.cat([beit.cls_token.expand(b, -1, -1), h], dim=1)
        taps = []
        for i, block in enumerate(beit.blocks):
            h = block(h, gh, gw)
            if i in self.hooks:
                taps.append(h)
        layers = []
        for lvl, tap in enumerate(taps):
            ap = getattr(self.pretrained, f"act_postprocess{lvl + 1}")
            feat = ap[0](tap)
            feat = feat.transpose(1, 2).reshape(b, feat.shape[-1], gh, gw)
            for layer in ap[3:]:
                feat = layer(feat)
            layers.append(getattr(self.scratch, f"layer{lvl + 1}_rn")(feat))
        s = self.scratch
        r4 = s.refinenet4(layers[3])
        r3 = s.refinenet3(r4, layers[2])
        r2 = s.refinenet2(r3, layers[1])
        r1 = s.refinenet1(r2, layers[0])
        head = s.output_conv
        out_conv = head[3](head[2](head[1](head[0](r1))))
        return head[5](head[4](out_conv)), out_conv, layers[3], (r4, r3, r2, r1)


class Mlp2(nn.Module):
    """conv1x1 -> ReLU -> conv1x1 under the reference's ``_net`` indices."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self._net = nn.Sequential(nn.Conv2d(cin, hidden, 1), nn.ReLU(), nn.Conv2d(hidden, cout, 1))

    def forward(self, x):
        return self._net(x)


class ConditionalLogBinomial(nn.Module):
    def __init__(self, cin: int, condition: int):
        super().__init__()
        bottleneck = (cin + condition) // 2
        self.mlp = nn.Sequential(nn.Conv2d(cin + condition, bottleneck, 1), nn.GELU(),
                                 nn.Conv2d(bottleneck, 4, 1))


def inv_attractor(dx: torch.Tensor) -> torch.Tensor:
    return dx / (1.0 + ATTR_ALPHA * dx ** ATTR_GAMMA)


@functools.lru_cache(maxsize=4)
def _log_binom(k: int) -> torch.Tensor:
    """The log-binomial coefficients (Stirling) of k classes, evaluated in
    float32 numpy in torch's order (dist_layers.py:29-69), as JAX's."""
    e = np.float32(1e-7)
    k_np = np.arange(k, dtype=np.float32) + e
    n_np = np.float32(k - 1) + e
    return torch.from_numpy(n_np * np.log(n_np) - k_np * np.log(k_np)
                            - (n_np - k_np) * np.log(n_np - k_np + e)).reshape(1, k, 1, 1)


def log_binomial(p: torch.Tensor, t: torch.Tensor, k: int = N_BINS,
                 eps: float = 1e-4) -> torch.Tensor:
    """p, t [B, 1, H, W] -> the [B, k, H, W] softmax over the binomial's
    log-probabilities at temperature t."""
    idx = torch.arange(k, dtype=p.dtype, device=p.device).reshape(1, k, 1, 1)
    y = (_log_binom(k).to(p.device) + idx * torch.log(p.clamp(eps, 1.0))
         + (k - 1 - idx) * torch.log((1.0 - p).clamp(eps, 1.0)))
    return torch.softmax(y / t, dim=1)


class ZoeDepth(nn.Module):
    """x [B, 3, H, W] (H, W multiples of 32, scaled to [-1, 1]) -> the metric
    depth [B, 1, H, W] (zoedepth_v1.py:124-201, the test path)."""

    def __init__(self):
        super().__init__()
        self.core = nn.Module()
        self.core.core = DPTBeit()
        self.conv2 = nn.Conv2d(FEATURES, FEATURES, 1)
        self.seed_bin_regressor = Mlp2(FEATURES, SEED_MLP, N_BINS)
        self.seed_projector = Mlp2(FEATURES, BIN_EMBED, BIN_EMBED)
        self.projectors = nn.ModuleList(Mlp2(FEATURES, BIN_EMBED, BIN_EMBED) for _ in ATTRACTORS)
        self.attractors = nn.ModuleList(Mlp2(BIN_EMBED, BIN_EMBED, n) for n in ATTRACTORS)
        self.conditional_log_binomial = ConditionalLogBinomial(32 + 1, BIN_EMBED)

    def forward(self, x):
        rel, last, l4_rn, blocks = self.core.core(x)
        btlnck = self.conv2(l4_rn)
        b_prev = F.softplus(self.seed_bin_regressor(btlnck))
        prev_emb = self.seed_projector(btlnck)
        for proj, attractor, xb in zip(self.projectors, self.attractors, blocks):
            hw = xb.shape[2:]
            emb = proj(xb)
            a = F.softplus(attractor(emb + up_ac(prev_emb, hw)))  # [B, nA, h, w]
            bc = up_ac(b_prev, hw)  # [B, bins, h, w]
            b_prev = bc + inv_attractor(a[:, :, None] - bc[:, None]).mean(dim=1)
            prev_emb = emb
        hw = last.shape[2:]
        last = torch.cat([last, up_ac(rel, hw)], dim=1)
        pt = self.conditional_log_binomial.mlp(torch.cat([last, up_ac(prev_emb, hw)], dim=1))
        pt = F.softplus(pt) + 1e-4
        p = pt[:, 0:1] / (pt[:, 0:1] + pt[:, 1:2])
        t = (MAX_TEMP - MIN_TEMP) * (pt[:, 2:3] / (pt[:, 2:3] + pt[:, 3:4])) + MIN_TEMP
        probs = log_binomial(p, t)
        return (probs * up_ac(b_prev, probs.shape[2:])).sum(dim=1, keepdim=True)


def _constrain32(v: float) -> int:
    return int(round(v / 32) * 32)


def minimal_resize_size(h: int, w: int, th: int = 384, tw: int = 512) -> Tuple[int, int]:
    """The 'minimal' keep-aspect target of an h x w image, in multiples of 32
    (base_models/midas.py:100-170)."""
    sh, sw = th / h, tw / w
    if abs(1 - sw) < abs(1 - sh):
        sh = sw
    else:
        sw = sh
    return max(_constrain32(sh * h), 32), max(_constrain32(sw * w), 32)


def pad_sizes(h: int, w: int) -> Tuple[int, int]:
    """The reflect padding of each side (depth_model.py ``infer_with_pad``)."""
    return int(np.sqrt(h / 2) * 3), int(np.sqrt(w / 2) * 3)


class ZoeDetector:
    """`state_dict`: ZoeD_M12_N.pt's tensors; default the file in
    `ckpt_dir`. Without it the detector raises, as JAX's does."""

    def __init__(self, state_dict=None, device="cuda", ckpt_dir: Optional[str] = None):
        if state_dict is None:
            state_dict = nets.read_weights(FILE, ckpt_dir)
        if state_dict is None:
            raise FileNotFoundError(f"ZoeDetector needs {FILE} in the annotator checkpoint "
                                    f"directory ({ckpt_dir or 'ckpts_dir()'})")
        state_dict = nets.keep_keys(state_dict, nets.module_keys(ZoeDepth))
        self.model = nets.build(ZoeDepth, state_dict, "zoe", device)

    def infer(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B, 3, H, W] in [0, 1] on the model's device -> metric depth
        [B, H, W]: the 'minimal' resize, the net, the bicubic resize back."""
        h, w = x.shape[2:]
        nh, nw = minimal_resize_size(h, w)
        with torch.inference_mode(), fp32_exact():
            d = self.model((up_ac(x, (nh, nw)) - 0.5) / 0.5)
            if (nh, nw) != (h, w):
                d = F.interpolate(d, size=(h, w), mode="bicubic", align_corners=False)
        return d[:, 0]

    def infer_pad(self, x: torch.Tensor) -> torch.Tensor:
        """``infer`` of the images reflect-padded, cropped back."""
        h, w = x.shape[2:]
        ph, pw = pad_sizes(h, w)
        d = self.infer(F.pad(x, (pw, pw, ph, ph), mode="reflect"))
        return d[:, ph:h + ph, pw:w + pw]

    def raw_depth(self, input_image: np.ndarray) -> np.ndarray:
        """The float32 metric depth [H, W] of a uint8 RGB image, averaged over
        its horizontal flip (the two as one batch)."""
        img = torch.from_numpy(np.ascontiguousarray(input_image, np.float32) / 255.0)
        x = img.to(nets.device_of(self.model)).permute(2, 0, 1)[None]
        d = self.infer_pad(torch.cat([x, x.flip(3)]))
        return ((d[0] + d[1].flip(1)) / 2.0).cpu().numpy()

    def __call__(self, input_image: np.ndarray) -> np.ndarray:
        assert input_image.ndim == 3
        depth = self.raw_depth(input_image)
        vmin, vmax = np.percentile(depth, 2), np.percentile(depth, 85)
        depth = 1.0 - (depth - vmin) / (vmax - vmin)
        return (depth * 255.0).clip(0, 255).astype(np.uint8)
