"""The port's YAML config reader against the JAX package's
``load_model_config`` (PyYAML) on the CPU:

* every file under ``configs/`` reads to the same ModelConfig tree as JAX
  reads it (field for field; the port's own SDXL fields at their
  defaults), the style config's image tokens too;
* a ``preset:`` + overrides file, nested under ``model:`` and at the top;
* a round trip of JAX ``save_model_config`` output;
* a file with the cosine schedule, v_posterior and the v target, whose
  pipeline schedule tables are JAX's;
* ``parse_yaml`` against ``yaml.safe_load`` on the scalars and collections
  ``yaml.safe_dump`` writes, and its refusals.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import yaml

from ctrlora_tpu import configs as jax_configs
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline

from ctrlora_tpu_torch import configs
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from tests.torch_configs import jax_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


def _tree(cfg):
    """A port tree without the port's own fields (at their defaults), or a
    JAX tree."""
    return jax_tree(cfg) if isinstance(cfg, configs.ModelConfig) else dataclasses.asdict(cfg)


def test_every_config_file_is_listed():
    names = {os.path.basename(f) for f in FILES}
    assert len(FILES) >= 17 and {"cnxs_sd15.yaml", "cldm_v15.yaml"} <= names


@pytest.mark.parametrize("path", FILES, ids=[os.path.relpath(f, ROOT) for f in FILES])
def test_config_file_reads_as_jax_reads_it(path):
    want = jax_configs.load_model_config(path)
    got = configs.load_model_config(path)
    assert _tree(got) == _tree(want)
    with open(path) as f:
        assert configs.parse_yaml(f.read()) == yaml.safe_load(open(path))


def test_cnxs_file_is_the_xs_preset():
    cfg = configs.load_model_config(os.path.join(ROOT, "configs", "cnxs_sd15.yaml"))
    assert cfg == configs.cnxs_config()
    assert (cfg.control.variant, cfg.control.control_model_ratio, cfg.control.guiding,
            cfg.control.infusion2control) == ("xs", 0.2, "encoder_double", "cat")


@pytest.mark.parametrize("nested", [True, False], ids=["under-model", "top-level"])
def test_preset_with_overrides_matches_jax(tmp_path, nested):
    body = ("unet:\n  dtype: float32\n  attention_resolutions:\n  - 4\n  - 2\n"
            "control:\n  guiding: full\n  infusion2control: add\n  learn_embedding: true\n"
            "  lora:\n    network_alpha: 16.0\n"
            "diffusion:\n  linear_end: 1.2e-02\n  parameterization: v\n"
            "tasks:\n- hed\n- canny\n")
    if nested:
        body = "model:\n" + "".join(f"  {ln}\n" for ln in body.splitlines())
    path = tmp_path / "override.yaml"
    path.write_text("# an XS variant\npreset: cnxs_sd15\n" + body)
    got, want = configs.load_model_config(str(path)), jax_configs.load_model_config(str(path))
    assert _tree(got) == _tree(want)
    assert got.unet.dtype == "float32" and got.control.guiding == "full"
    assert got.tasks == ("hed", "canny") and got.diffusion.linear_end == 0.012


@pytest.mark.parametrize("name", ["cnxs_sd15", "cldm_v15", "ctrlora_finetune", "tiny"])
def test_jax_saved_config_round_trips(tmp_path, name):
    path = str(tmp_path / f"{name}.yaml")
    jax_configs.save_model_config(jax_configs.load_model_config(name), path)
    assert _tree(configs.load_model_config(path)) == _tree(jax_configs.load_model_config(path))
    assert configs.load_model_config(path) == configs.load_model_config(name)


SCALARS = ["a: 1", "a: -3", "a: 0.5", "a: 1.0e-05", "a: 1e-5", "a: .5", "a: null", "a: ~",
           "a:", "a: true", "a: False", "a: 'quoted: yes'", 'a: "x\\ty"', "a: bfloat16",
           "a: .inf", "a: -.inf", "a: 1_000", "a: 'it''s'", "a: []", "a: {}", "a: [1, b, 2.5]",
           "a: plain words here", "a: x # a comment"]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_pyyaml_does(text):
    assert configs.parse_yaml(text + "\n") == yaml.safe_load(text)


def test_block_collections_as_pyyaml_reads_them():
    text = ("---\na:\n  b:\n  - 1\n  - x\n  c:\n    - {}\n    - - 2\n      - 3\n  d: 4\n"
            "e:\n- k: 1\n  m: two\n- k: 2\n")
    assert configs.parse_yaml(text) == yaml.safe_load(text)
    assert configs.parse_yaml("") is None and configs.parse_yaml("- 1\n- 2\n") == [1, 2]


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: !!str 1\n", "a: |\n  x\n", "a: [1, [2]]\n",
                                  "a: 1\n  b: 2\n", "a: 1\na: 2\n", "a: 'open\n",
                                  "a:\n\t- 1\n"])
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError, match="YAML"):
        configs.parse_yaml(text)


@pytest.mark.parametrize("field, value, match", [
    ("control.unet", {"ip_tokens": 4}, "control.unet.ip_tokens=4"),
    ("unet", {"dropout": 0.1}, "dropout"),
])
def test_unported_parts_raise(tmp_path, field, value, match):
    """What the port lacks or refuses raises: dropout, and image-prompt
    tokens in the control branch (which reads text only)."""
    path = tmp_path / "x.yaml"
    key, val = next(iter(value.items()))
    parts = field.split(".")
    nest = "".join(f"{'  ' * i}{name}:\n" for i, name in enumerate(parts))
    path.write_text(f"preset: cldm_v15\n{nest}{'  ' * len(parts)}{key}: {val}\n")
    jax_configs.load_model_config(str(path))  # JAX reads it
    with pytest.raises(NotImplementedError, match=match):
        configs.load_model_config(str(path))


def test_diffusion_options_load_as_jax_reads_them(tmp_path):
    """Another schedule, v_posterior and the v target load in both packages,
    and the port pipeline's schedule tables are JAX's, bit for bit."""
    path = tmp_path / "x.yaml"
    path.write_text("preset: cldm_v15\ndiffusion:\n  beta_schedule: cosine\n"
                    "  v_posterior: 0.1\n  parameterization: v\n")
    want = jax_configs.load_model_config(str(path))
    got = configs.load_model_config(str(path))
    assert _tree(got) == _tree(want)
    assert (got.diffusion.beta_schedule, got.diffusion.v_posterior,
            got.diffusion.parameterization) == ("cosine", 0.1, "v")
    a = CtrLoraPipeline(got, device="meta").schedule
    b = JaxPipeline(want).schedule
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)
