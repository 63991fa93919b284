"""The port stands apart from JAX and from the JAX package, and chip_smoke.py
refuses to run without a card.

Each check runs in a fresh interpreter, so that modules the test process
already imported (JAX among them) cannot hide a missing dependency.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def _python(code, cwd=REPO, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def test_every_port_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'cpm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import cpm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(cpm_tpu_torch.__path__, 'cpm_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "wanted = ('ops.cuda._build', 'ops.cuda.multilevel_roi_align', 'ops.cuda.stacked_roi_align',\n"
        "          'ops.cuda.clustered_roi_align', 'ops.cuda.roi_align', 'tools.bench_roi_align',\n"
        "          'ops.deform_conv', 'ops.cuda.deform_sample', 'ops.cuda.crossroi_roi_align',\n"
        "          'tools.probe_dcn_sampler', 'tools.probe_pooler_crossroi',\n"
        "          'data.catalog', 'data.coco_io', 'data.coco', 'data.synthetic_coco',\n"
        "          'data.transforms', 'data.samplers', 'data.loader', 'engine.checkpoint',\n"
        "          'engine.test', 'evaluation.coco_eval', 'utils.logger', 'utils.vis',\n"
        "          'tools.train_net', 'tools.test_net', 'structures.image_batch',\n"
        "          'modeling.layers', 'ops.roi_pool', 'ops.rotated', 'evaluation.proposal_eval',\n"
        "          'utils.measure', 'tools.compute_flops', 'native',\n"
        "          'tools.coco_model_to_cityscapes')\n"
        "assert all('cpm_tpu_torch.' + w in names for w in wanted), names\n"
        "print(len(names))\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 75


def test_host_data_modules_import_no_torch():
    # the loaders run on a thread of their own beside the train step and are
    # numpy, PIL and the native decode pool's ctypes, as in the JAX package;
    # the evaluator is numpy
    code = (
        "import sys, importlib\n"
        "for m in ('torch', 'jax', 'cpm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "for n in ('data.catalog', 'data.coco_io', 'data.coco', 'data.synthetic_coco',\n"
        "          'data.transforms', 'data.samplers', 'data.loader', 'evaluation.coco_eval',\n"
        "          'utils.logger', 'utils.vis', 'structures.image_batch',\n"
        "          'evaluation.proposal_eval', 'native'):\n"
        "    importlib.import_module('cpm_tpu_torch.' + n)\n"
        "print('ok')\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_import_no_jax_inside_functions_either():
    # `cpm_tpu` followed by a word boundary does not match `cpm_tpu_torch`
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|cpm_tpu)(\s|\.|$)", re.M)
    for path in list((REPO / "cpm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
    assert pattern.search("    from cpm_tpu.config import cfg\n")
    assert pattern.search("import cpm_tpu\n")
    assert not pattern.search("from cpm_tpu_torch.config import cfg\n")


def test_card_test_file_imports_no_jax():
    # tests/test_torch_cuda_kernels.py runs on machines that have a card and
    # PyTorch but not the JAX package's dependencies
    text = (REPO / "tests" / "test_torch_cuda_kernels.py").read_text()
    assert not re.search(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|cpm_tpu)(\s|\.|$)", text, re.M)
    assert "pytest.mark.cuda" in text


def test_config_imports_without_pyyaml_and_yaml_use_raises():
    # PyYAML is imported inside merge_cfg_from_file, nowhere else
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['cpm_tpu'] = None\n"
        "from cpm_tpu_torch.config import get_default_cfg, merge_cfg_from_file, merge_cfg_from_list\n"
        "cfg = get_default_cfg()\n"
        "assert cfg.TPU.COMPUTE_DTYPE == 'bfloat16'\n"
        "merge_cfg_from_list(['SOLVER.BASE_LR', '0.02'], cfg)\n"
        "assert cfg.SOLVER.BASE_LR == 0.02\n"
        "try:\n"
        "    merge_cfg_from_file('cfgs/debug/tiny_fast_rcnn.yaml', cfg)\n"
        "except ImportError:\n"
        "    print('refused')\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "refused"


def test_port_config_schema_equals_the_jax_packages():
    """Guards the port's copy of the schema against drift: the same keys,
    defaults and types, the same merge and freeze behaviour."""
    import cpm_tpu.config as jax_config
    import cpm_tpu_torch.config as port_config

    def walk(a, b, path=""):
        assert type(a).__name__ == type(b).__name__, path
        if isinstance(a, dict):
            assert list(a) == list(b), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        else:
            assert a == b and type(a) is type(b), path

    want, got = jax_config.get_default_cfg(), port_config.get_default_cfg()
    walk(got, want)
    assert isinstance(got, port_config.AttrDict) and not isinstance(got, jax_config.AttrDict)
    yaml_file = REPO / "cfgs" / "debug" / "tiny_fast_rcnn.yaml"
    opts = ["SOLVER.BASE_LR", "0.02", "TRAIN.SCALES", "(640, 672)"]
    for mod, c in ((jax_config, want), (port_config, got)):
        mod.merge_cfg_from_file(str(yaml_file), c)
        mod.merge_cfg_from_list(opts, c)
        mod.assert_and_infer_cfg(c)
    walk(got, want)
    assert got.is_immutable() and got.TRAIN.SCALES == (640, 672)
    assert vars(port_config.freeze_to_ns(got).SOLVER) == vars(jax_config.freeze_to_ns(want).SOLVER)
    for mod in (jax_config, port_config):
        fresh = mod.get_default_cfg()
        try:
            mod.merge_cfg_from_list(["SOLVER.NO_SUCH_KEY", "1"], fresh)
        except KeyError as e:
            assert "SOLVER.NO_SUCH_KEY" in str(e)
        else:
            raise AssertionError("unknown key accepted")


def test_collecting_the_port_tests_loads_no_torch():
    # a test worker with torch loaded can deadlock the 8-device XLA:CPU
    # collectives of tests/test_multichip.py, so the port's tests import
    # torch inside the tests, as the repo's other tests do
    code = (
        "import glob, sys, pytest\n"
        "files = sorted(glob.glob('tests/test_torch_*.py'))\n"
        "rc = pytest.main(['--collect-only', '-q', '-p', 'no:cacheprovider', *files])\n"
        "print(len(files), int(rc), 'torch' in sys.modules)\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    n_files, rc, torch_loaded = proc.stdout.split()[-3:]
    for name in ("test_torch_pooler_kernels.py", "test_torch_cuda_kernels.py"):
        assert (REPO / "tests" / name).exists()
    assert int(n_files) >= 10 and rc == "0"
    assert torch_loaded == "False"


def _assert_refused(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    _assert_refused(proc)


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env,
    )
    _assert_refused(proc)
