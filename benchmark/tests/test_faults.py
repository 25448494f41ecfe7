"""A whole run at the tiny size, past the look for a card, with the timed
path broken underneath: each fault a cell can have makes ``correct`` come
out false against the cells' limits."""

import json

import pytest
import torch

from benchmark import run


def correct_of(root, workload, capsys) -> bool:
    assert run.main(["--workload", workload, "--seed", "77", "--seconds", "0", "--trace", "0"],
                    root=root, device="cpu", chip_check=False) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"]


def test_sound_runs_are_correct(tiny_root, capsys):
    assert correct_of(tiny_root, "tiny.sample", capsys)
    assert correct_of(tiny_root, "tiny.train", capsys)


@pytest.mark.parametrize("rows", ["all", "last"])
def test_an_image_altered_where_it_is_made(tiny_root, capsys, monkeypatch, rows):
    from ctrlora_tpu_torch.pipeline import CtrLoraPipeline

    decode = CtrLoraPipeline.decode_first_stage

    def altered(self, z):
        img = decode(self, z)
        return img + 0.1 if rows == "all" else torch.cat([img[:-1], img[-1:] + 0.1])

    monkeypatch.setattr(CtrLoraPipeline, "decode_first_stage", altered)
    assert not correct_of(tiny_root, "tiny.sample", capsys)


@pytest.mark.parametrize("rows", ["all", "last"])
def test_a_model_output_altered_where_it_is_made(tiny_root, capsys, monkeypatch, rows):
    from ctrlora_tpu_torch.pipeline import CtrLoraPipeline

    apply_model = CtrLoraPipeline.apply_model

    def altered(self, x, *a, **k):
        out = apply_model(self, x, *a, **k)
        if rows == "all":
            return out * 1.5
        b = x.shape[0] // 2  # the cond rows, then the uncond rows
        return torch.cat([out[:b - 1], out[b - 1:b] * 1.5, out[b:]])

    monkeypatch.setattr(CtrLoraPipeline, "apply_model", altered)
    assert not correct_of(tiny_root, "tiny.sample", capsys)


def test_a_sampler_the_check_cannot_see(tiny_root, capsys, monkeypatch):
    """A sampler that reaches the model without the pipeline's
    ``apply_model`` (as a captured graph of the step would) fails the
    check rather than passing on latents it never kept."""
    from ctrlora_tpu_torch.scripts import sample as sample_cli

    ddim_sample = sample_cli.ddim_sample

    def unseen(pipe, *a, **k):
        pipe.__dict__.pop("apply_model", None)  # the class's method, not the wrapper
        return ddim_sample(pipe, *a, **k)

    monkeypatch.setattr(sample_cli, "ddim_sample", unseen)
    assert not correct_of(tiny_root, "tiny.sample", capsys)


def test_a_sampler_that_leaves_its_latent_unchanged(tiny_root, capsys, monkeypatch):
    from ctrlora_tpu_torch.sampling import common
    from ctrlora_tpu_torch.scripts import sample as sample_cli
    from ctrlora_tpu_torch.schedules import make_ddim_schedule

    def frozen_ddim(pipe, ctx, unc, conds, shape, cfg, x_T=None, **kw):
        eps_fn = common.make_guided_eps_fn(pipe, ctx, unc, conds, cfg.guidance_scale,
                                           kw.get("control_scales"))
        x = x_T.to(pipe.device, torch.float32)
        for t in make_ddim_schedule(pipe.schedule, cfg.steps).timesteps[::-1]:
            eps_fn(x, int(t))  # the model runs; the step's update is lost
        return x

    monkeypatch.setattr(sample_cli, "ddim_sample", frozen_ddim)
    assert not correct_of(tiny_root, "tiny.sample", capsys)


def test_a_training_step_that_leaves_its_state_unchanged(tiny_root, capsys, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    assert not correct_of(tiny_root, "tiny.train", capsys)


def test_half_the_batch_left_out(tiny_root, capsys, monkeypatch):
    from ctrlora_tpu_torch.training import step as step_mod

    loss_for_batch = step_mod.loss_for_batch

    def half(pipe, batch, generator=None, draws=None):
        n = batch["jpg"].shape[0] // 2
        return loss_for_batch(pipe, {k: v[:n] for k, v in batch.items()}, generator,
                              {k: v[:n] for k, v in draws.items()})

    monkeypatch.setattr(step_mod, "loss_for_batch", half)
    assert not correct_of(tiny_root, "tiny.train", capsys)
