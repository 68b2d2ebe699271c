"""The run: no card, no result; and `correct` on the CPU at a small size,
true for the program, false for the control and for each fault the cells
can have, planted in the timed path."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gpubench.harness import spec
from gpubench.tests.helpers import run_tiny, tiny_cell


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "correct-10x",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_run_fails_outside_a_checkout(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program to run: the run fails and prints nothing."""
    import shutil
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "correct-10x",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _altered(job, run_pass):
    """An answer altered where it is produced: one base of every output."""
    def rp(tap):
        for name, codes, solid in run_pass(tap):
            codes = codes.copy()
            if len(codes):
                codes[len(codes) // 2] ^= 1
            yield name, codes, solid
    return rp


def _half_left_out(job, run_pass):
    """Half of the batch left out: every other pile yields nothing."""
    def rp(tap):
        for i, item in enumerate(run_pass(tap)):
            if i % 2 == 0:
                yield item
    return rp


def _unchanged(job, run_pass):
    """A step that returns its state unchanged: the correction hands
    back each read as it came in."""
    def rp(tap):
        for name, codes, solid in run_pass(tap):
            raw = job.index[name]
            yield name, raw, np.ones(len(raw), bool)
    return rp


def test_program_is_correct():
    result, checks = run_tiny(tiny_cell())
    assert result["correct"], checks
    assert all(c["value"] == 0 for c in checks.values())
    assert set(result["metrics"]) == {"bases_per_s", "error_pct", "setup_s"}
    assert list(result)[-1] == "checks"
    json.dumps(result)


def test_polish_is_correct():
    result, checks = run_tiny(tiny_cell("polish-10x"))
    assert result["correct"], checks


@pytest.mark.parametrize("fault,number", [
    (_altered, "byte_diff"), (_half_left_out, "order_diff"),
    (_unchanged, "byte_diff")])
def test_faults_come_out_not_correct(fault, number):
    result, checks = run_tiny(tiny_cell(), run_pass_hook=fault)
    assert not result["correct"]
    assert checks[number]["value"] > checks[number]["limit"]


def test_control_comes_out_not_correct():
    result, checks = run_tiny(tiny_cell(), control="int8")
    assert not result["correct"]
    assert checks["byte_diff"]["value"] > 0


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "correct-10x",
         "--seed", str(2 ** 31 + 99), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
