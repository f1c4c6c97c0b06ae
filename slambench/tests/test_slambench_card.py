"""On the card: each cell's command runs briefly and comes out correct.
Skips without a card (``python -m pytest slambench -m card`` on the
machine with one)."""

import json
import subprocess
import sys

import pytest

from slambench import harness


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.load_spec()["workloads"]])
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload", name, "--seed",
         "2718281828", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu"


def test_run_refuses_without_a_card():
    """Without a card the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload",
         "museum-fidelity.replay", "--seed", "1", "--seconds", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_run_refuses_without_the_program(card, tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    the command exits non-zero and prints no result."""
    import shutil

    shutil.copy(f"{harness.ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload",
         "museum-fidelity.replay", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
