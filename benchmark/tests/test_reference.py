"""The plain reference against the program's plain path (CPU tensors take
the kernels' plain versions) at the program's tiny size, on the same
seeded weights: the towers, the controlled UNet with the LoRA run and
folded, the schedules and AdamW."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import common, seeding
from benchmark.reference.diffusion import (
    Reference, adamw_step, alphas_cumprod, ddim_coefficients, ddim_ladder, guided_eps,
)
from benchmark.reference.sd15 import nchw, nhwc

TOL = 2e-5


def pipeline_and_weights(switchable: bool, fuse: bool):
    from ctrlora_tpu_torch import configs, lora_fuse
    from ctrlora_tpu_torch.pipeline import CtrLoraPipeline

    cfg = configs.tiny_test_config(n_loras=1, switchable_banks=switchable)
    model = dataclasses.asdict(cfg)
    pipe = CtrLoraPipeline(cfg, "cpu", fuse_lora=fuse)
    shapes = {"unet": common.shapes_of(pipe.unet),
              "control": common.unfused_control_shapes(cfg),
              "vae": common.shapes_of(pipe.vae), "clip": common.shapes_of(pipe.clip)}
    raw = seeding.seeded_weights(shapes, 7, "cpu", {k: torch.float32 for k in shapes})
    for k in ("unet", "vae", "clip"):
        getattr(pipe, k).load_state_dict(raw[k], strict=True)
    control = (lora_fuse.fuse_control_tree(pipe.control, raw["control"], 0, cfg.control.lora)
               if fuse else raw["control"])
    pipe.control.load_state_dict(control, strict=True)
    return cfg, model, pipe, raw


@pytest.mark.parametrize("fuse", [False, True])
def test_controlled_unet_matches_the_program(fuse):
    cfg, model, pipe, raw = pipeline_and_weights(switchable=fuse, fuse=fuse)
    from ctrlora_tpu_torch.pipeline import Conditioning

    ref = Reference(model, raw, fuse=fuse)
    g = torch.Generator().manual_seed(0)
    x, hint = torch.randn((2, 8, 8, 4), generator=g), torch.randn((2, 8, 8, 4), generator=g)
    ctx = torch.randn((2, 16, 64), generator=g)
    t = torch.tensor([3, 917])
    with torch.no_grad():
        want = pipe.apply_model(x, t, ctx, [Conditioning(hint)])
        got = nhwc(ref.unet.controlled(nchw(x), t, ctx, nchw(hint)))
    assert common.rel_l2(got, want) < TOL


def test_towers_match_the_program():
    cfg, model, pipe, raw = pipeline_and_weights(switchable=False, fuse=False)
    ref = Reference(model, raw)
    g = torch.Generator().manual_seed(1)
    img = torch.rand((2, 16, 16, 3), generator=g)
    ids = torch.randint(0, 128, (2, 16), generator=g)
    eps = torch.randn((2, 8, 8, 4), generator=g)
    with torch.no_grad():
        assert common.rel_l2(ref.text(ids), pipe.encode_text_tokens(ids)) < TOL
        assert common.rel_l2(nhwc(ref.latent(img, eps)),
                             pipe.encode_first_stage(img, eps=eps)) < TOL
        assert common.rel_l2(ref.pixels(eps), pipe.decode_first_stage(eps)) < TOL


def test_guided_eps_and_ddim_update_match_the_sampler():
    """One DDIM step of the program's sampler, read off as the reference
    reads it: the guided eps from x -> x_prev."""
    from ctrlora_tpu_torch.pipeline import Conditioning
    from ctrlora_tpu_torch.sampling.ddim import DDIMConfig, ddim_sample
    from ctrlora_tpu_torch.schedules import make_ddim_schedule

    cfg, model, pipe, raw = pipeline_and_weights(switchable=True, fuse=True)
    ref = Reference(model, raw, fuse=True)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((1, 8, 8, 4), generator=g)
    hint = torch.randn((1, 8, 8, 4), generator=g)
    ctx, unc = torch.randn((2, 1, 16, 64), generator=g)
    steps = 5
    dd = make_ddim_schedule(pipe.schedule, steps)
    sub = dd[:1]  # the ladder's first rung: t = 1 from x
    with torch.no_grad():
        x_prev = ddim_sample(pipe, ctx, unc, [Conditioning(hint)], x.shape,
                             DDIMConfig(steps=1, guidance_scale=7.5), x_T=x, ddim_schedule=sub)
        ts, a_t, a_prev = ddim_ladder(model["diffusion"], steps)
        c_x, c_e = ddim_coefficients(float(a_t[-1]), float(a_prev[-1]))
        e_prog = (nchw(x_prev).double() - c_x * nchw(x).double()) / c_e
        e_ref = guided_eps(ref.unet, nchw(x), int(ts[-1]), ctx, unc, nchw(hint), 7.5, 1.0)
    assert common.rel_l2(e_prog, e_ref) < 1e-4


def test_schedules_match_the_program():
    from ctrlora_tpu_torch.schedules import make_ddim_schedule, make_schedule

    from ctrlora_tpu_torch.configs import DiffusionConfig

    d = dataclasses.asdict(DiffusionConfig())
    sched = make_schedule()
    np.testing.assert_allclose(alphas_cumprod(d), sched.alphas_cumprod, rtol=1e-6)
    for steps in (3, 20, 50):
        ts, a_t, a_prev = ddim_ladder(d, steps)
        dd = make_ddim_schedule(sched, steps)
        assert np.array_equal(ts, dd.timesteps[::-1])
        np.testing.assert_allclose(a_t, dd.alphas[::-1], rtol=1e-6)
        np.testing.assert_allclose(a_prev, dd.alphas_prev[::-1], rtol=1e-6)


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(3)
    p0 = {"a": torch.randn((5, 7), generator=g), "b": torch.randn((3,), generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in p0.items()} for _ in range(3)]
    mine = {k: v.clone() for k, v in p0.items()}
    theirs = [torch.nn.Parameter(v.clone()) for v in p0.values()]
    opt = torch.optim.AdamW(theirs, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
    state = {}
    for s, gr in enumerate(grads, start=1):
        adamw_step(mine, gr, state, s, 1e-3, (0.9, 0.999), 1e-8, 1e-2)
        for p, k in zip(theirs, p0):
            p.grad = gr[k].clone()
        opt.step()
    for p, k in zip(theirs, p0):
        torch.testing.assert_close(mine[k], p.detach(), rtol=1e-6, atol=1e-7)
