"""The port's evaluation metrics against the JAX package's on the CPU:
LPIPS (all three VGG key namings, both normalize modes, the JAX tree's
carry), MSE / PSNR / SSIM, the streaming accumulator, CLIPScore over a
tiny HF-named CLIPModel, the TF32 guard of the metric entry points, and
the multi-batch PSNR difference from torchmetrics (a known defect of the
JAX reference, kept by the port).

Every input comes from a numpy seed; each tolerance is stated where it is
used.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrlora_tpu import evaluation as jev
from ctrlora_tpu.models import lpips as jlp
from ctrlora_tpu_torch import convert
from ctrlora_tpu_torch import evaluation as tev
from ctrlora_tpu_torch.models import lpips as tlp
from ctrlora_tpu_torch.models.inception import FIDInceptionV3, inception_features

PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
# torchvision features.{i} -> lpips net.slice{k}: the slices' layer ranges
SLICES = ((1, range(0, 4)), (2, range(4, 9)), (3, range(9, 16)), (4, range(16, 23)),
          (5, range(23, 30)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Six pytest processes share the host's cores: one torch thread each
    (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lpips_sd(seed=0, widths=(64, 128, 256, 512, 512)):
    """A torchvision-named VGG16 + lin-head state dict of seeded weights (a
    gain under 1 a layer, so deep random nets stay finite)."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for cout, (_, idxs) in zip(widths, zip(PLAN, IDX)):
        for i in idxs:
            sd[f"features.{i}.weight"] = rng.normal(
                0, (1.0 / (9 * cin)) ** 0.5, (cout, cin, 3, 3)).astype(np.float32)
            sd[f"features.{i}.bias"] = rng.normal(0, 0.01, (cout,)).astype(np.float32)
            cin = cout
    for k, cout in enumerate(widths):
        sd[f"lin{k}.model.1.weight"] = rng.uniform(0, 0.1, (1, cout, 1, 1)).astype(np.float32)
    return sd


def renamed(sd, naming):
    """The same weights under the lpips package's key names."""
    if naming == "features":
        return dict(sd)
    out = {}
    for k, v in sd.items():
        if k.startswith("features."):
            i, leaf = int(k.split(".")[1]), k.split(".")[2]
            s = next(si for si, r in SLICES if i in r)
            out[f"{naming}{s}.{i}.{leaf}"] = v
        else:
            k2 = k.replace("lin", "lins.", 1) if naming == "net.net.slice" else k
            out[k2] = v
    return out


@pytest.fixture(scope="module")
def lpips_pair():
    sd = lpips_sd()
    model = tlp.LPIPS.from_state_dict(tlp.convert_lpips(sd), "cpu")
    return sd, jlp.convert_lpips(sd), model


@pytest.mark.parametrize("normalize", [True, False])
def test_lpips_matches_jax(lpips_pair, normalize):
    """Per-image LPIPS at [2, 64, 64, 3] fp32, rtol 1e-4 / atol 1e-6; the
    port's model loaded through the JAX tree's carry gives the same."""
    sd, jtree, model = lpips_pair
    rng = np.random.default_rng(1)
    lo = 0.0 if normalize else -1.0
    a = rng.uniform(lo, 1, (2, 64, 64, 3)).astype(np.float32)
    b = rng.uniform(lo, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jlp.lpips_jit(jtree, a, b, normalize=normalize))
    got = tlp.lpips(model, torch.from_numpy(a), torch.from_numpy(b), normalize).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    carried = tlp.LPIPS.from_state_dict(convert.params_from_jax(jtree), "cpu")
    got2 = tlp.lpips(carried, torch.from_numpy(a), torch.from_numpy(b), normalize).numpy()
    np.testing.assert_array_equal(got2, got)


@pytest.mark.parametrize("naming", ["features", "net.slice", "net.net.slice"])
def test_lpips_key_namings_give_equal_weights(naming):
    """torchvision, lpips and lpips-in-a-wrapper names (the last with the
    'lins.{k}' heads) load to the same weights in the port and, through the
    JAX bridge and the carry, to the same tensors bit for bit."""
    sd = lpips_sd(widths=(4, 8, 8, 8, 8))
    want = tlp.convert_lpips(sd)
    got = tlp.convert_lpips(renamed(sd, naming))
    carried = convert.params_from_jax(jlp.convert_lpips(renamed(sd, naming)))
    assert set(got) == set(want) == set(carried)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(carried[k], want[k]), k


def test_lpips_init_tree_carries_and_identical_images_score_zero():
    """JAX's init_lpips_params tree carries into the port's LPIPS (every
    leaf, the rank-1 lin kernels as [C] weights), the port's own init has
    the same keys and shapes, and lpips(a, a) is exactly 0."""
    jtree = jlp.init_lpips_params(jax.random.PRNGKey(0))
    state = convert.params_from_jax(jtree)
    own = tlp.init_lpips_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in own.items()}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        name, kind = path[0].key, path[1].key
        value = np.asarray(leaf)
        want = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value
        np.testing.assert_array_equal(state[f"{name}.{'bias' if kind == 'bias' else 'weight'}"],
                                      want)
    model = tlp.LPIPS.from_state_dict(state, "cpu")
    a = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    assert torch.equal(tlp.lpips(model, a, a), torch.zeros(2))


# ---------------------------------------------------------------------------
# MSE / PSNR / SSIM and the accumulator
# ---------------------------------------------------------------------------

def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("metric", ["mse", "psnr", "ssim"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 32, 32, 3)])
def test_plain_metric_matches_jax(metric, shape):
    """Within 1e-5 (relative for PSNR, absolute for MSE and SSIM)."""
    a, b = _pair(shape, 3)
    want = float(getattr(jev, metric)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(tev, metric)(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5 if metric == "psnr" else 0, atol=1e-5)


def test_accumulator_matches_jax_over_two_batches():
    """The streaming means of two unequal batches, within 1e-5."""
    j, t = jev.MetricAccumulator(), tev.MetricAccumulator(device="cpu")
    for shape, seed in (((2, 32, 32, 3), 4), ((1, 32, 32, 3), 5)):
        a, b = _pair(shape, seed)
        j.update(a, b)
        t.update(a, b)
    want, got = j.compute(), t.compute()
    assert set(got) == set(want) == {"mse", "psnr", "ssim"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_multi_batch_psnr_differs_from_torchmetrics_pooled_mse():
    """JAX's accumulator (and so the port's) averages per-batch PSNRs
    weighted by count; torchmetrics' PeakSignalNoiseRatio (dim None) keeps
    the sum of squared errors and the count and gives one PSNR of the pooled
    MSE. One batch: equal within 1e-5 dB. Two batches of different error
    (noise 0.01 and 0.2): the port, like JAX, reads 9.89 dB above the pooled
    PSNR."""
    rng = np.random.default_rng(6)
    batches = []
    for sigma in (0.01, 0.2):
        a = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
        batches.append((a, (a + rng.normal(0, sigma, a.shape)).astype(np.float32)))
    pooled = lambda bs: 10 * np.log10(1.0 / (sum(float(((a - b) ** 2).sum()) for a, b in bs)
                                            / sum(a.size for a, _ in bs)))
    one = tev.MetricAccumulator(device="cpu")
    one.update(*batches[0])
    np.testing.assert_allclose(one.compute()["psnr"], pooled(batches[:1]), atol=1e-5)
    acc, jacc = tev.MetricAccumulator(device="cpu"), jev.MetricAccumulator()
    for a, b in batches:
        acc.update(a, b)
        jacc.update(a, b)
    np.testing.assert_allclose(acc.compute()["psnr"], jacc.compute()["psnr"], rtol=1e-5)
    gap = acc.compute()["psnr"] - pooled(batches)
    np.testing.assert_allclose(gap, 9.89, atol=0.01)


# ---------------------------------------------------------------------------
# CLIPScore
# ---------------------------------------------------------------------------

def tiny_clip_sd(seed=0, width=64, layers=2, image=32, patch=8, proj=48):
    """An HF CLIPModel state dict of seeded weights: text 2 x 64, vision
    2 x 64 at 32 px with patch 8, projection 48."""
    rng = np.random.default_rng(seed)
    w = lambda *s, std=0.02: rng.normal(0, std, s).astype(np.float32)
    sd = {}

    def tower(pre):
        for i in range(layers):
            t = f"{pre}.encoder.layers.{i}"
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{t}.self_attn.{n}.weight"] = w(width, width, std=0.1)
                sd[f"{t}.self_attn.{n}.bias"] = w(width)
            for n in ("layer_norm1", "layer_norm2"):
                sd[f"{t}.{n}.weight"] = 1 + w(width)
                sd[f"{t}.{n}.bias"] = w(width)
            sd[f"{t}.mlp.fc1.weight"] = w(4 * width, width, std=0.1)
            sd[f"{t}.mlp.fc1.bias"] = w(4 * width)
            sd[f"{t}.mlp.fc2.weight"] = w(width, 4 * width, std=0.05)
            sd[f"{t}.mlp.fc2.bias"] = w(width)

    sd["text_model.embeddings.token_embedding.weight"] = w(49408, width, std=0.5)
    sd["text_model.embeddings.position_embedding.weight"] = w(77, width, std=0.1)
    tower("text_model")
    sd["text_model.final_layer_norm.weight"] = 1 + w(width)
    sd["text_model.final_layer_norm.bias"] = w(width)
    sd["text_projection.weight"] = w(proj, width, std=0.1)
    sd["vision_model.embeddings.class_embedding"] = w(width, std=0.5)
    sd["vision_model.embeddings.patch_embedding.weight"] = w(width, 3, patch, patch, std=0.1)
    sd["vision_model.embeddings.position_embedding.weight"] = w(
        (image // patch) ** 2 + 1, width, std=0.1)
    sd["vision_model.pre_layrnorm.weight"] = 1 + w(width)
    sd["vision_model.pre_layrnorm.bias"] = w(width)
    tower("vision_model")
    sd["vision_model.post_layernorm.weight"] = 1 + w(width)
    sd["vision_model.post_layernorm.bias"] = w(width)
    sd["visual_projection.weight"] = w(proj, width, std=0.1)
    return sd


@pytest.fixture(scope="module")
def scorers():
    sd = tiny_clip_sd()
    return jev.CLIPScorer.from_torch_state(sd), tev.CLIPScorer.from_torch_state(sd, device="cpu")


PROMPTS = ["a photograph of an astronaut riding a horse", "  a cat  "]


def test_clip_score_matches_jax(scorers):
    """Per-sample 100 * cosine on the same pre-normalised pixels and
    prompts, within 1e-3."""
    js, ts = scorers
    pixels = np.random.default_rng(7).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = js.tokenizer([p.strip() for p in PROMPTS])
    img = js.vision_apply(js.vision_params, jnp.asarray(pixels))
    txt = js.text_apply(js.text_params, jnp.asarray(ids))
    img = np.asarray(img / jnp.linalg.norm(img, axis=-1, keepdims=True))
    txt = np.asarray(txt / jnp.linalg.norm(txt, axis=-1, keepdims=True))
    want = 100.0 * np.sum(img * txt, axis=-1)
    got = ts.scores(*ts.embed_pixels(torch.from_numpy(pixels), PROMPTS))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_accumulator_clip_score_matches_jax(scorers):
    """The accumulator's 'clip score' (uint8 images through CLIP's
    preprocessing) within 1e-3, beside MSE/PSNR/SSIM within 1e-5."""
    js, ts = scorers
    rng = np.random.default_rng(8)
    j = jev.MetricAccumulator(clip_scorer=js)
    t = tev.MetricAccumulator(clip_scorer=ts, device="cpu")
    for n in (2, 1):
        a, b = _pair((n, 32, 32, 3), 9 + n)
        sample = rng.integers(0, 256, (n, 48, 40, 3), dtype=np.uint8)
        j.update(a, b, sample=sample, prompts=PROMPTS[:n])
        t.update(a, b, sample=sample, prompts=PROMPTS[:n])
    want, got = j.compute(), t.compute()
    assert set(got) == set(want) == {"mse", "psnr", "ssim", "clip score"}
    np.testing.assert_allclose(got["clip score"], want["clip score"], rtol=0, atol=1e-3)
    for k in ("mse", "psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the TF32 guard
# ---------------------------------------------------------------------------

def _flags():
    return torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("entry", ["lpips", "inception_features", "clip_embed", "ssim"])
def test_metric_entry_points_run_without_tf32_and_restore_flags(entry, scorers):
    """Inside each metric entry point matmuls are 'highest' and cuDNN TF32
    is off; the caller's settings ('high', TF32 on here) come back after."""
    seen = []
    spy = lambda *_: seen.append(_flags())
    with contextlib.ExitStack() as stack:
        if entry == "lpips":
            model = tlp.LPIPS((4, 8, 8, 8, 8))
            model.conv0.register_forward_pre_hook(spy)
            run = lambda: tlp.lpips(model, torch.zeros(1, 16, 16, 3), torch.ones(1, 16, 16, 3))
        elif entry == "inception_features":
            model = FIDInceptionV3()
            model.Conv2d_1a_3x3.register_forward_pre_hook(spy)
            run = lambda: inception_features(model, torch.zeros(1, 75, 75, 3))
        elif entry == "clip_embed":
            ts = scorers[1]
            stack.callback(ts.vision.register_forward_pre_hook(spy).remove)
            run = lambda: ts.embed(np.zeros((1, 32, 32, 3), np.uint8), ["a cat"])
        else:
            real = tev.F.conv2d
            stack.enter_context(mock.patch.object(
                tev.F, "conv2d", lambda *a, **kw: spy() or real(*a, **kw)))
            run = lambda: tev.ssim(torch.zeros(1, 16, 16, 3), torch.zeros(1, 16, 16, 3))
        saved = _flags()
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        try:
            run()
            after = _flags()
        finally:
            torch.set_float32_matmul_precision(saved[0])
            torch.backends.cudnn.allow_tf32 = saved[1]
    assert seen and set(seen) == {("highest", False)}
    assert after == ("high", True)
