"""Nothing a run loads is JAX or the JAX package, by whole top-level
names: `consent_tpu_torch` is the program, `consent_tpu` is not."""

import json
import os
import subprocess
import sys

from gpubench.harness import spec
from gpubench.harness.imports import forbidden_modules


def test_top_level_names_compared_whole():
    assert forbidden_modules(["consent_tpu_torch", "consent_tpu_torch.cli",
                              "consent_tpu_tools", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["consent_tpu", "consent_tpu.ops.align",
                              "jax", "jax.numpy", "jaxlib.xla_client",
                              "flax.linen", "torch"]) == sorted(
        ["consent_tpu", "consent_tpu.ops.align", "jax", "jax.numpy",
         "jaxlib.xla_client", "flax.linen"])


def test_a_run_loads_no_jax():
    """A whole run of a tiny cell on the CPU, in a fresh process: after
    it, sys.modules holds nothing forbidden."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {spec.ROOT!r})\n"
        "import torch; torch.set_num_threads(2)\n"
        "from gpubench.tests.helpers import tiny_cell, run_tiny\n"
        "from gpubench.harness.imports import forbidden_modules\n"
        "res, _ = run_tiny(tiny_cell())\n"
        "print(json.dumps([res['correct'], forbidden_modules(sys.modules),"
        " 'consent_tpu_torch' in sys.modules]))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ok, bad, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert ok and bad == [] and port


def test_benchmark_sources_read_no_jax_package():
    """No file of the benchmark imports JAX or the JAX package, or reads
    the JAX package's benchmarks or chip_smoke.py."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|consent_tpu)\b"
                     r"(?!_torch)", re.M)
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if not f.endswith(".py") or "tests" in dirpath:
                continue
            src = open(os.path.join(dirpath, f)).read()
            assert not pat.search(src), f
            assert not re.search(r"^\s*(from|import)\s+(chip_smoke|bench|"
                                 r"benchmarks)\b", src, re.M), f
            assert not re.search(r"open\([^)]*(benchmarks/|bench\.py|"
                                 r"chip_smoke)", src), f
