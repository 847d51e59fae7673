"""The import guard: no run loads JAX or the JAX package."""
import subprocess
import sys

from benchmark import guard
from benchmark.tests.conftest import REPO


def test_top_level_names_compared_whole():
    assert guard.forbidden_loaded(["hydrabadger_tpu_torch", "hydrabadger_tpu_torch.sim.tensor",
                                   "jaxtyping", "flaxen", "numpy"]) == []
    assert guard.forbidden_loaded(["hydrabadger_tpu.ops.rs_jax", "jax.numpy", "jaxlib",
                                   "flax.linen"]) == ["flax", "hydrabadger_tpu", "jax", "jaxlib"]


def _python(code: str, env_path: str = None):
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": env_path or str(REPO), "HOME": str(REPO)}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_everything_a_run_loads_is_clean():
    # the harness, both drivers' program paths and every metric reader
    code = (
        "import benchmark.run as r, benchmark.guard as g\n"
        "import hydrabadger_tpu_torch.sim.tensor, hydrabadger_tpu_torch.ops._kernels\n"
        "import torch.profiler\n"
        "spec = r.load_spec()\n"
        "for c in spec['configs']:\n"
        "    import json; r.load_module('drivers', json.load(open(c['file']))['driver'])\n"
        "for m in spec['end_to_end'] + spec['per_layer']: r.load_module('metrics', m['name'])\n"
        "print(g.forbidden_loaded())\n"
    )
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_loaded_jax_stops_the_run(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    out = _python("import jax, benchmark.guard as g; g.check('test')",
                  f"{tmp_path}:{REPO}")
    assert out.returncode == 3
    assert "loaded jax" in out.stderr and out.stdout == ""


def test_no_card_no_result():
    env = {"PATH": "/usr/bin:/bin", "HOME": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "rs64-inst1024",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_no_program_no_result(tmp_path):
    import shutil

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tpke64-inst1",
                          "--seed", "7", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
