"""The port's eval CLI in its parent mode, `--shards`, on the CPU.

`python -m cpm_tpu_torch.tools.test_net --device cpu --shards 2` on
cfgs/debug/tiny_cpm.yaml over the repository's 16 synthetic images spawns
two children of the CLI with `--range`; their merged range files must equal
one `--range 0 16` run's results under `_canon` (rounded to 1e-3 px and
1e-5 of a score), and the parent writes bbox.json and prints the COCO stats.
Every process builds the same seeded weights (`build_model(cfg, seed=0)`),
so random-init results agree across processes. The port of
tests/test_shard_cli.py; each CLI call has a timeout.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "debug", "tiny_cpm.yaml")


def _run_cli(args, ckpt_dir, timeout=300):
    proc = subprocess.run(
        [sys.executable, "-m", "cpm_tpu_torch.tools.test_net", "--cfg", TINY, "--device", "cpu"]
        + args + ["DATA_DIR", os.path.join(REPO, "data"), "CKPT", ckpt_dir],
        capture_output=True, text=True, timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, (f"CLI failed rc={proc.returncode}\nstdout:\n{proc.stdout[-3000:]}"
                                  f"\nstderr:\n{proc.stderr[-3000:]}")
    return proc


def _canon(results):
    """Order-independent canonical form of COCO result dicts."""
    return sorted(
        (r["image_id"], r["category_id"], tuple(round(float(v), 3) for v in r["bbox"]),
         round(float(r["score"]), 5))
        for r in results)


def test_shards_cli_merged_equals_single_process(tmp_path):
    n_images = 16  # data/synthetic_debug

    single_dir = str(tmp_path / "single")
    _run_cli(["--range", "0", str(n_images)], single_dir)
    with open(os.path.join(single_dir, "test", f"detection_range_0_{n_images}.json")) as f:
        single = json.load(f)
    assert single, "the single-process run produced no detections"
    assert not os.path.exists(os.path.join(single_dir, "test", "bbox.json"))  # --range: no eval

    shard_dir = str(tmp_path / "sharded")
    parent = _run_cli(["--shards", "2"], shard_dir)
    assert '"AP"' in parent.stdout  # the parent printed the merged set's stats

    out = os.path.join(shard_dir, "test")
    shard_files = sorted(f for f in os.listdir(out) if f.startswith("detection_range_"))
    assert shard_files == ["detection_range_0_8.json", "detection_range_8_16.json"]
    merged = []
    for name in shard_files:
        with open(os.path.join(out, name)) as f:
            merged.extend(json.load(f))
    assert _canon(merged) == _canon(single)
    # the parent evaluated the merged set: bbox.json written
    with open(os.path.join(out, "bbox.json")) as f:
        assert _canon(json.load(f)) == _canon(single)
    for name in ("shard_0_8.log", "shard_8_16.log"):
        with open(os.path.join(out, name)) as f:
            assert "8 images in" in f.read()
