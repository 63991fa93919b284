"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level module name (`cpm_tpu_torch` is the port; `cpm_tpu` is not), and
the reference imports nothing of the port."""

import json
import subprocess
import sys

from benchmark.registry import REPO

BANNED = ("jax", "jaxlib", "flax", "cpm_tpu")


def _top_levels(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    tops = _top_levels(
        "import benchmark.run, benchmark.serve, benchmark.train, benchmark.calibrate, "
        "benchmark.faults\n"
        "import cpm_tpu_torch.engine.test, cpm_tpu_torch.engine.train, "
        "cpm_tpu_torch.data.loader, cpm_tpu_torch.modeling.model, cpm_tpu_torch.ops.cuda.multilevel_roi_align")
    assert "cpm_tpu_torch" in tops
    assert not tops & set(BANNED), tops & set(BANNED)


def test_the_reference_loads_nothing_of_the_port():
    tops = _top_levels(
        "import pkgutil, importlib, benchmark.reference as r\n"
        "for m in pkgutil.walk_packages(r.__path__, 'benchmark.reference.'):\n"
        "    importlib.import_module(m.name)\n"
        "import benchmark.weights, benchmark.bounds, benchmark.check, benchmark.traffic")
    assert not tops & set(BANNED + ("cpm_tpu_torch",)), tops


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "cpm_r50_fpn.serve_b1", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_the_jax_check_compares_whole_names(monkeypatch):
    import types

    from benchmark.common import jax_modules

    monkeypatch.setitem(sys.modules, "cpm_tpu_torch_like", types.ModuleType("cpm_tpu_torch_like"))
    assert jax_modules() == []
    monkeypatch.setitem(sys.modules, "cpm_tpu.ops", types.ModuleType("cpm_tpu.ops"))
    assert jax_modules() == ["cpm_tpu"]
