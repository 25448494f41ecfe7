"""Import hygiene of the PyTorch port: the package and chip_smoke.py import
no JAX, no flax, no PyYAML, no transformers and nothing of ctrlora_tpu (the
GPU host has none of them; the port reads YAML configs with its own
reader), no module
imports triton (every kernel is CUDA C++ built with nvcc), and the
kernel build directory is ignored by git. The gradio front ends
(``ctrlora_tpu_torch/app/gradio_*.py``) exit at import without gradio, so
their sources are scanned instead of imported."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import ctrlora_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


GRADIO = ("ctrlora_tpu_torch.app.gradio_ctrlora", "ctrlora_tpu_torch.app.gradio_controlnet",
          "ctrlora_tpu_torch.app.gradio_ctrlora_style_transfer")


def _modules():
    """Every module of the port but the gradio front ends."""
    names = ["ctrlora_tpu_torch"]
    for info in pkgutil.walk_packages(ctrlora_tpu_torch.__path__, "ctrlora_tpu_torch."):
        if info.name not in GRADIO:
            names.append(info.name)
    return names


def test_port_modules_cover_the_slice():
    names = set(_modules())
    for mod in ("configs", "schedules", "convert", "lora_fuse", "pipeline",
                "ops.group_norm", "ops.flash_attention", "ops.geglu_ffn", "ops.unpack_rows",
                "ops._build", "models.layers", "models.attention", "models.unet",
                "models.vae", "models.clip", "sampling.common", "sampling.ddim",
                "training.losses", "training.train_state", "training.step",
                "training.trainer", "api", "ops.kernel_flags", "utils.tokenizer",
                "utils.image", "utils.ckpt_torch", "utils.loading", "tools.ablate_flash",
                "tools.ablate_geglu", "tools.ablate_flash_bwd", "tools.time_flash_bwd",
                "tools.ablate_hpack2", "tools.ablate_group_norm", "tools.time_gn_hpack2",
                "tools.ablate_gn_onepass", "tools.time_gn_onepass_unpack",
                "tools.time_sampling", "sampling.plms", "sampling.dpm_solver",
                "data.datasets", "scripts.sample", "data.scheduler", "data.native",
                "data.loader", "training.ema", "training.latent_cache",
                "scripts.train_common", "scripts.train_ctrlora_finetune",
                "scripts.train_ctrlora_pretrain", "models.lite", "scripts.train_cn",
                "models.xs", "models.ip_adapter", "models.openclip", "style",
                "utils.precision", "models.lpips", "models.inception", "models.t5",
                "evaluation", "annotators.util", "annotators.simple", "annotators.registry",
                "scripts.evaluate_control", "scripts.evaluate_restore",
                "scripts.evaluate_fid", "annotators.download", "annotators.nets",
                "annotators.hed", "annotators.lineart", "annotators.mlsd", "apps.logic",
                "app", "scripts.tool_make_control_init", "scripts.tool_combine_weights",
                "scripts.tool_extract_weights", "scripts.tool_make_cond_images",
                "scripts.evaluate_lineart_is_coarse", "scripts.evaluate_lineart",
                "annotators.midas", "annotators.uniformer", "annotators.ade_palette",
                "annotators.openpose", "annotators.openpose.models",
                "annotators.openpose.decode", "annotators.pidinet", "annotators.bbox",
                "annotators.densepose"):
        assert f"ctrlora_tpu_torch.{mod}" in names
    found = {info.name for info in
             pkgutil.walk_packages(ctrlora_tpu_torch.__path__, "ctrlora_tpu_torch.")}
    assert set(GRADIO) <= found


def test_gradio_front_ends_import_no_jax():
    """The three gradio modules' imports, read from their sources: gradio,
    the standard library and the port only."""
    for name in GRADIO:
        path = os.path.join(ROOT, *name.split(".")) + ".py"
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        imported = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                    for a in node.names]
        imported += [node.module or "" for node in ast.walk(tree)
                     if isinstance(node, ast.ImportFrom)]
        roots = {m.split(".")[0] for m in imported}
        assert "gradio" in roots and "ctrlora_tpu_torch" in roots
        assert not roots & {"jax", "jaxlib", "flax", "ctrlora_tpu"}, (name, roots)


def test_no_jax_in_port_or_chip_smoke():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ctrlora_tpu', 'yaml', 'transformers'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_no_module_imports_triton():
    """No import of triton anywhere in the port's sources or chip_smoke.py,
    at module level or inside a function."""
    pkg = os.path.dirname(ctrlora_tpu_torch.__file__)
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    found = []
    for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            found += [(path, n) for n in names if n.split(".")[0] == "triton"]
    assert len(files) > 40 and found == []


def test_build_dir_is_gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        lines = {ln.strip() for ln in f}
    assert "ctrlora_tpu_torch/_build/" in lines
    from ctrlora_tpu_torch.ops import _build

    assert os.path.relpath(_build.BUILD_DIR, ROOT) == "ctrlora_tpu_torch/_build"


def test_chip_smoke_refuses_without_cuda():
    """Without a card chip_smoke.py exits non-zero and prints no result."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run the full slice")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
