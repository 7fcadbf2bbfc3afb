"""The port's V=5000 run (``sat_tpu_torch.tools.vocab5000_run``) on the
CPU: one run of the tool at a small edge (2 steps of batch 2 at 32 px,
an eval cap of 2 annotations) with its mesh arm in eight gloo ranks under
``torch.distributed.run``, shared by the tests below; the vocabulary it
builds held byte for byte to the JAX package's ``build_vocabulary`` on
the same corpus."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX script's result.json keys (scripts/vocab5000_run.py)
JAX_KEYS = {
    "vocab_words", "vocabulary_cap_bound", "num_images", "image_size", "train_steps",
    "loss_single_first_last", "loss_tp_first_last", "loss_parity_max_rel", "mesh_shape",
    "tp_sharded_tensors", "scores_single", "scores_tp", "total_seconds",
}


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("SAT_FI_", "SAT_TORCH_DEVICE"))}
    env["OMP_NUM_THREADS"] = "2"
    return env


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("vocab5000")
    proc = subprocess.run(
        [sys.executable, "-m", "sat_tpu_torch.tools.vocab5000_run", "--cpu", "--steps", "2", "--batch-size", "2",
         "--image-size", "32", "--eval-anns", "2", "--out", str(out)],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    with open(out / "result.json") as f:
        result = json.load(f)
    yield {"out": out, "result": result, "stdout": proc.stdout}
    shutil.rmtree(out, ignore_errors=True)     # two V=5000 checkpoints with their Adam slots


def test_vocabulary_is_the_jax_packages_and_holds_5000_words(run, tmp_path):
    from sat_tpu.config import Config as JaxConfig
    from sat_tpu.data.dataset import build_vocabulary

    out = run["out"]
    config = JaxConfig(train_caption_file=str(out / "captions.json"), max_train_ann_num=None,
                       vocabulary_size=5000, vocabulary_file=str(tmp_path / "vocabulary.csv"))
    build_vocabulary(config)
    with open(tmp_path / "vocabulary.csv", "rb") as f:
        want = f.read()
    with open(out / "vocabulary.csv", "rb") as f:
        got = f.read()
    assert got == want
    assert len(got.decode().strip().splitlines()) - 1 == 5000      # a header row, then the words
    assert run["result"]["vocab_words"] == 5000


def test_result_has_the_jax_keys_and_passes_its_gates(run):
    r = run["result"]
    assert JAX_KEYS <= set(r)
    assert r["mesh_shape"] == [2, 4] and r["train_steps"] == 2
    # the embedding rows and the last decode layer's kernel and bias
    assert r["tp_sharded_tensors"] == 3
    assert r["loss_parity_max_rel"] < 5e-2
    assert r["loss_records"] == 2 and len(r["loss_tp_first_last"]) == 2
    for key in ("scores_single", "scores_tp"):
        assert set(r[key]) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}
        assert all(math.isfinite(v) for v in r[key].values())
    assert r["device"] == "cpu" and r["vocabulary_cap_bound"] is True
    # every rank ran the mesh eval through the CLI (the plain version on the CPU)
    assert r["launches_tp_eval_ranks"] == [0] * 8
    assert os.path.isfile(run["out"] / "results_tp.json") and os.path.isfile(run["out"] / "summary.md")


def test_mesh_arm_ran_in_eight_gloo_ranks_on_the_cpu(run):
    with open(run["out"] / "ranks.log") as f:
        log = f.read()
    assert "8 ranks (8 on this host), backend gloo, rank 0 on cpu" in log
    tallies = sorted(os.listdir(run["out"] / "tally_tp"))
    assert tallies == [f"tally_rank{r}.json" for r in range(8)]
    with open(run["out"] / "tally_tp" / "tally_rank3.json") as f:
        tally = json.load(f)
    assert [t["rc"] for t in tally] == [0, 0] and tally[1]["argv"][0] == "--phase=eval"


def test_refuses_to_run_without_a_card_unless_asked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "sat_tpu_torch.tools.vocab5000_run", "--out", str(tmp_path / "v")],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "no CUDA device is visible" in proc.stderr
    assert not os.path.exists(tmp_path / "v")
