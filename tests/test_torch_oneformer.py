"""The port's OneFormer (``ctrlora_tpu_torch/annotators/oneformer/``)
against the JAX package's on the CPU.

A tiny configuration that both packages take (``TINY``: Swin 16 wide with
window 4, two blocks a stage; the pixel decoder 32 wide with two encoder
layers of 4 heads; the decoder 32 wide with one class layer and three
masked layers; COCO 6 queries over 8 classes, ADE20k 10 over 9), one
seeded file of each published layout (``chip_smoke.write_detector_files``: the tensors under 'model'
beside 'iteration', with a training-only text projector the detector
leaves out). JAX's tree comes from ``convert_oneformer`` on the file's
tensors: JAX's own loader (``load_torch_state_dict``) unwraps 'state_dict'
only, so it cannot read the file as detectron2 nests it (ROADMAP queue 3).

Stage by stage, each on the same input: the Swin maps (at a size that is a
multiple of the window and at one that is not) and the pixel decoder's
outputs agree within 1e-4 of their largest |value|; the decoder's class
logits and masks, and the full forward's, within 1e-4 of theirs (a mask
logit near 0 could flip a block of the next layer's attention mask; none
does here). The detector's class map differs on at most 0.5% of pixels
(JAX resizes the masks with cv2 on the host, the port with F.interpolate;
an argmax near a tie flips a pixel). ``task_tokens`` is bit-equal to JAX's,
the two published configs and the palettes equal JAX's, and at the
published depths the module's keys are exactly those JAX's converter reads.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ctrlora_tpu.annotators import oneformer as jof
from ctrlora_tpu.annotators.oneformer import decoder as jdec
from ctrlora_tpu.annotators.oneformer import pixel_decoder as jpd
from ctrlora_tpu.annotators.oneformer import swin as jswin
from ctrlora_tpu_torch.annotators import nets
from ctrlora_tpu_torch.annotators import oneformer as tof
from ctrlora_tpu_torch.annotators.oneformer import decoder as tdec
from ctrlora_tpu_torch.annotators.oneformer import pixel_decoder as tpd
from ctrlora_tpu_torch.annotators.oneformer import swin as tswin

TINY = {"swin": dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4), window_size=4),
        "pixel": dict(conv_dim=32, mask_dim=32, nheads=4, dim_feedforward=64, enc_layers=2,
                      in_channels=(16, 32, 64, 128)),
        "dec": dict(hidden_dim=32, nheads=2, dim_feedforward=64, dec_layers=3,
                    class_dec_layers=1),
        "coco": dict(num_queries=6, num_classes=8, min_size_test=96, max_size_test=160),
        "ade20k": dict(num_queries=10, num_classes=9, min_size_test=80, max_size_test=200)}
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(pkg, dataset):
    """(pkg's swin, pixel_decoder, decoder modules, pkg's oneformer) ->
    the TINY config of `dataset` in that package's dataclasses."""
    sw, pd, dec, of = pkg
    d = TINY[dataset]
    return of.OneFormerConfig(
        swin=sw.SwinConfig(**TINY["swin"]), pixel=pd.PixelDecoderConfig(**TINY["pixel"]),
        dec=dec.DecoderConfig(**TINY["dec"], num_queries=d["num_queries"],
                              num_classes=d["num_classes"]),
        min_size_test=d["min_size_test"], max_size_test=d["max_size_test"], palette=dataset)


PORT, JAX = (tswin, tpd, tdec, tof), (jswin, jpd, jdec, jof)


def patch_tiny(mp):
    """Both packages' coco_config / ade20k_config give TINY's."""
    for pkg in (PORT, JAX):
        mp.setattr(pkg[3], "coco_config", lambda pkg=pkg: tiny_config(pkg, "coco"))
        mp.setattr(pkg[3], "ade20k_config", lambda pkg=pkg: tiny_config(pkg, "ade20k"))


def jax_detector(path, cfg):
    """JAX's detector on the tensors of a seeded file (under 'model')."""
    sd = torch.load(path, weights_only=True)["model"]
    return jof.OneformerDetector(cfg, params=jof.convert_oneformer(
        {k: v.numpy() for k, v in sd.items()}, cfg))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("oneformer_ckpts"))
    mp = pytest.MonkeyPatch()
    patch_tiny(mp)
    chip_smoke.write_detector_files(d, names=list(chip_smoke.ONEFORMER_FILES))
    mp.undo()
    return d


@pytest.fixture(scope="module")
def coco(files):
    """(the port's COCO detector, JAX's, JAX's params)."""
    cfg = tiny_config(JAX, "coco")
    jdet = jax_detector(f"{files}/{tof.COCO_FILE}", cfg)
    port = tof.OneformerDetector(tiny_config(PORT, "coco"), device="cpu", ckpt_dir=files,
                                 file=tof.COCO_FILE)
    return port, jdet, jdet.params


def image(seed, hw):
    import cv2

    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (9, 9), 3.0)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).permute(0, 3, 1, 2)


def close(got: torch.Tensor, want, nhwc=True):
    """got (port, NCHW where `nhwc`) within REL of JAX's largest |value|."""
    want = np.asarray(want)
    g = got.permute(0, 2, 3, 1).numpy() if nhwc else got.numpy()
    assert g.shape == want.shape
    np.testing.assert_allclose(g, want, rtol=0, atol=REL * np.abs(want).max())


@pytest.mark.parametrize("hw", [(64, 96), (70, 90)])
def test_swin_matches_jax(coco, hw):
    """At 16 x 24 tokens (whole windows) and 18 x 23 (the patch embedding and
    every stage padded)."""
    port, _, params = coco
    x = np.random.default_rng(hw[1]).standard_normal((1, *hw, 3)).astype(np.float32)
    want = jax.jit(jswin.swin_forward, static_argnums=2)(
        params["backbone"], jnp.asarray(x), tiny_config(JAX, "coco").swin)
    with torch.inference_mode():
        got = port.model.backbone(nchw(x))
    assert sorted(got) == sorted(want) == ["res2", "res3", "res4", "res5"]
    for k in want:
        close(got[k], want[k])


@pytest.mark.parametrize("hw, ws, shift", [(8, 4, 2), (16, 8, 4), (24, 12, 6)])
def test_shift_mask_equals_jax(hw, ws, shift):
    np.testing.assert_array_equal(tswin.shift_mask(hw, hw + ws, ws, shift).numpy(),
                                  jswin._shift_mask(hw, hw + ws, ws, shift))


def test_pixel_decoder_and_decoder_match_jax(coco):
    """Each on the same inputs (JAX's previous stage's outputs)."""
    port, jdet, params = coco
    cfg = tiny_config(JAX, "coco")
    x = np.random.default_rng(1).standard_normal((1, 96, 128, 3)).astype(np.float32)
    feats = jax.jit(jswin.swin_forward, static_argnums=2)(params["backbone"], jnp.asarray(x),
                                                          cfg.swin)
    mf, ms = jax.jit(jpd.pixel_decoder_forward, static_argnums=2)(params["pixel_decoder"], feats,
                                                                  cfg.pixel)
    pd, pred = port.model.sem_seg_head.pixel_decoder, port.model.sem_seg_head.predictor
    with torch.inference_mode():
        got_mf, got_ms = pd({k: nchw(v) for k, v in feats.items()})
        close(got_mf, mf)
        for g, w in zip(got_ms, ms):
            close(g, w)
        tasks = jnp.asarray(jdet.tasks)
        cls, masks = jax.jit(jdec.decoder_forward, static_argnums=4)(params["predictor"], ms, mf,
                                                                     tasks, cfg.dec)
        task = port.model.task_mlp(torch.from_numpy(np.asarray(jdet.tasks)))
        got_cls, got_masks = pred(task, [nchw(m) for m in ms], nchw(mf))
    close(got_cls, cls, nhwc=False)
    close(got_masks, masks, nhwc=False)
    assert got_masks.shape == (1, 6, 24, 32) and got_cls.shape == (1, 6, 9)


def test_forward_matches_jax(coco):
    port, jdet, params = coco
    x = np.random.default_rng(2).standard_normal((1, 96, 128, 3)).astype(np.float32)
    cls, masks = jdet._jit(params, jnp.asarray(x), jnp.asarray(jdet.tasks))
    with torch.inference_mode():
        got_cls, got_masks = port.model(nchw(x), port.task_input())
    close(got_cls, cls, nhwc=False)
    close(got_masks, masks, nhwc=False)


@pytest.mark.parametrize("dataset, hw", [("coco", (64, 80)), ("ade20k", (72, 60))])
def test_detector_matches_jax(files, dataset, hw):
    """Through the published-layout file: the class map on at most 0.5% of
    pixels differing, at least two classes in it; the coloured map has
    JAX's shape and dtype."""
    name = tof.COCO_FILE if dataset == "coco" else tof.ADE20K_FILE
    port = tof.OneformerDetector(tiny_config(PORT, dataset), device="cpu", ckpt_dir=files,
                                 file=name)
    jdet = jax_detector(f"{files}/{name}", tiny_config(JAX, dataset))
    img = image(hw[0], hw)
    got, want = port.semantic_map(img), jdet.semantic_map(img)
    assert got.shape == want.shape == hw and got.dtype == want.dtype == np.int32
    assert len(np.unique(want)) >= 2
    assert (got != want).mean() <= 5e-3, (got != want).mean()
    out, jout = port(img), jdet(img)
    assert out.shape == jout.shape == (*hw, 3) and out.dtype == jout.dtype == np.uint8


def test_task_tokens_bit_equal():
    for task in ("semantic", "panoptic", "instance"):
        np.testing.assert_array_equal(tof.task_tokens(task), jof.task_tokens(task))
    np.testing.assert_array_equal(tof.task_tokens("semantic", 5), jof.task_tokens("semantic", 5))


def test_published_configs_equal_jax():
    for name in ("coco_config", "ade20k_config"):
        got, want = getattr(tof, name)(), getattr(jof, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tof.coco_config().dec.num_queries == 150 and tof.ade20k_config().dec.num_classes == 150


def test_palettes_equal_jax():
    assert tof.palettes() == jof.palettes()
    for dataset, k in (("coco", 133), ("ade20k", 150)):
        assert len(tof.palettes()[dataset]["classes"]) == k


def test_without_a_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match=tof.COCO_FILE):
        tof.OneformerCOCODetector(device="cpu", ckpt_dir=str(tmp_path))


def test_keys_at_published_depths():
    """At TINY's widths with the published depths (Swin 2/2/18/2, six
    encoder layers, nine masked and two class layers): the module's keys are
    exactly those convert_oneformer reads."""
    from test_torch_midas import Recorder, layout

    cfgs = []
    for pkg in (PORT, JAX):
        c = tiny_config(pkg, "coco")
        cfgs.append(dataclasses.replace(
            c, swin=dataclasses.replace(c.swin, depths=(2, 2, 18, 2)),
            pixel=dataclasses.replace(c.pixel, enc_layers=6),
            dec=dataclasses.replace(c.dec, dec_layers=9, class_dec_layers=2)))
    with torch.device("meta"):
        model = tof.OneFormer(cfgs[0])
    sd = Recorder(layout(model))
    jof.convert_oneformer(sd, cfgs[1])
    assert sd.read == set(sd) and len(sd) == len(nets.module_keys(lambda: tof.OneFormer(cfgs[0])))
