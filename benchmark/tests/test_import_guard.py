"""What the benchmark loads, in a fresh interpreter: no module of JAX or of
the JAX package (top-level names compared whole, since the port's name
begins with the JAX package's), and a reference that loads nothing of the
program. In a directory that holds only the benchmark it fails and prints
no result."""

import os
import shutil
import subprocess
import sys

from benchmark.spec import DEFAULT_ROOT

GUARD = ("jax", "jaxlib", "flax", "ctrlora_tpu")


def python(code: str, cwd: str = DEFAULT_ROOT, **env) -> subprocess.CompletedProcess:
    e = dict(os.environ, PYTHONPATH=cwd, **env)
    e.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=e, capture_output=True,
                          text=True, timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from benchmark.tests.tiny import write_root\n"
        "from benchmark import run\n"
        f"root = write_root({str(tmp_path)!r})\n"
        "for w in ('tiny.sample', 'tiny.train'):\n"
        "    assert run.main(['--workload', w, '--seed', '5', '--seconds', '0', '--trace', '0'],"
        " root=root, device='cpu', chip_check=False) == 0\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        f"print('FOUND', sorted(tops & set({GUARD!r})), 'ctrlora_tpu_torch' in tops)\n")
    out = python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND [] True" in out.stdout


def test_a_module_loaded_by_the_check_stops_the_result(tiny_root, capsys, monkeypatch):
    """A forbidden module that appears while the reference runs, after the
    window, leaves the run without a result."""
    import contextlib
    import types

    from benchmark import run
    from benchmark.reference import sd15

    products = sd15.fp32_products

    @contextlib.contextmanager
    def loads_flax(*a, **k):
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
        with products(*a, **k):
            yield

    monkeypatch.setattr(sd15, "fp32_products", loads_flax)
    for w in ("tiny.sample", "tiny.train"):
        assert run.main(["--workload", w, "--seed", "6", "--seconds", "0", "--trace", "0"],
                        root=tiny_root, device="cpu", chip_check=False) == 3
        out = capsys.readouterr()
        assert '"correct"' not in out.out  # no result line
        assert "flax" in out.err
        monkeypatch.delitem(sys.modules, "flax")


def test_the_reference_loads_nothing_of_the_program():
    out = python("import sys\nimport benchmark.reference.sd15, benchmark.reference.diffusion\n"
                 "print(sorted({m.split('.')[0] for m in sys.modules} & "
                 "{'ctrlora_tpu_torch', 'ctrlora_tpu', 'jax', 'jaxlib', 'flax'}))")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_without_the_program_a_run_fails_and_prints_nothing(tmp_path):
    shutil.copy(os.path.join(DEFAULT_ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(DEFAULT_ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\nfrom benchmark import run\n"
            "sys.exit(run.main(['--workload', 'sample.b8.ddim50', '--seed', '1', '--seconds', '1',"
            " '--trace', '0'], device='cpu', chip_check=False))")
    out = python(code, cwd=str(tmp_path))
    assert out.returncode != 0
    assert not out.stdout.strip()
    out = python(code.replace(", device='cpu', chip_check=False", ""), cwd=str(tmp_path))
    assert out.returncode != 0 and not out.stdout.strip()
