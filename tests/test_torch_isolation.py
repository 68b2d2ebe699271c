"""Guards of the PyTorch port: it imports neither jax nor consent_tpu,
its device entry points refuse to run on a missing card, its engine
selects devices as the JAX package's does, and its copied host modules
and functions still match the JAX package's originals."""

import ast
import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules copied from consent_tpu with only the package name changed;
# config.py also appends from_reference
VERBATIM = [
    "config.py", "io/seqs.py", "io/fasta.py", "io/paf.py",
    "core/windows.py", "core/sparse_counts.py", "core/postprocess.py",
    "core/npalign.py", "utils/hostpool.py", "overlap/minimizer.py",
    "testing/simulate.py", "testing/metrics.py", "pipeline/stitch.py",
    "pipeline/checkpoint.py", "core/dbg.py", "tools.py",
]

# functions copied from consent_tpu into modules that differ elsewhere
VERBATIM_FUNCTIONS = [
    ("parallel/multihost.py", "shard_piles"),
    ("parallel/multihost.py", "shard_path"),
    ("parallel/multihost.py", "merge_shards"),
    ("ops/kmer.py", "count_kmers_host"),
    ("ops/kmer.py", "count_anchors_host"),
    ("ops/kmer.py", "solidity_mask"),
    ("ops/consensus.py", "unpack_votes_host"),
    ("ops/consensus.py", "wire_decode_votes"),
    ("ops/consensus.py", "assemble_consensus_batch"),
    ("ops/consensus.py", "assemble_consensus"),
]

ISOLATED = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    sys.modules["jax"] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "consent_tpu" or name.startswith("consent_tpu."):
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import torch
    torch.cuda.is_available = lambda: False     # a host with no card

    import consent_tpu_torch
    names = ["consent_tpu_torch"]
    for m in pkgutil.walk_packages(consent_tpu_torch.__path__,
                                   "consent_tpu_torch."):
        importlib.import_module(m.name)
        names.append(m.name)
    bad = [n for n in sys.modules
           if n == "consent_tpu" or n.startswith("consent_tpu.")
           or n == "jax" and sys.modules[n] is not None]
    assert not bad, bad
    assert "consent_tpu_torch.parallel.mesh" in names

    from consent_tpu_torch import cli, correct_preset
    from consent_tpu_torch.pipeline import device_align, engine

    def raises(fn):
        try:
            fn()
        except RuntimeError as e:
            assert "CUDA is not available" in str(e), e
            return
        raise AssertionError(f"{fn} ran without a card")

    cfg = correct_preset()
    raises(lambda: engine.ConsensusEngine(cfg))
    raises(lambda: engine.ConsensusEngine(cfg, device="cuda"))
    raises(lambda: device_align.FixedAligner(cfg))
    raises(lambda: next(engine.process_piles(iter([]), None, cfg)))
    raises(lambda: cli.main_correct(["--in", "x.fa", "--out", "y.fa"]))
    raises(lambda: cli.main_polish(["--contigs", "x.fa", "--reads", "y.fa",
                                    "--out", "z.fa"]))
    print("MODULES", len(names))
    """
)


def test_port_imports_no_jax_and_needs_a_card():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", ISOLATED], cwd=REPO,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    n = int(res.stdout.split("MODULES")[1])
    assert n >= 25


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_modules_match_originals(rel):
    with open(os.path.join(REPO, "consent_tpu", rel)) as f:
        orig = re.sub(r"\bconsent_tpu\b", "consent_tpu_torch", f.read())
    with open(os.path.join(REPO, "consent_tpu_torch", rel)) as f:
        port = f.read()
    if rel == "config.py":
        assert port.startswith(orig)
        assert "def from_reference" in port[len(orig):]
    else:
        assert port == orig


def _function_source(path, name):
    with open(path) as f:
        src = f.read()
    for node in ast.parse(src).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.get_source_segment(src, node)
    raise AssertionError(f"{name} not found in {path}")


@pytest.mark.parametrize("rel, name", VERBATIM_FUNCTIONS,
                         ids=[f"{r}:{n}" for r, n in VERBATIM_FUNCTIONS])
def test_copied_functions_match_originals(rel, name):
    orig = _function_source(os.path.join(REPO, "consent_tpu", rel), name)
    port = _function_source(os.path.join(REPO, "consent_tpu_torch", rel), name)
    assert port == re.sub(r"\bconsent_tpu\b", "consent_tpu_torch", orig)


def test_console_scripts_name_the_port_entry_points():
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if k.startswith("consent-torch-")}
    assert sorted(port) == ["consent-torch-correct", "consent-torch-eval",
                            "consent-torch-merge-shards",
                            "consent-torch-polish"]
    for name, target in port.items():
        mod, fn = target.split(":")
        assert mod.startswith("consent_tpu_torch.")
        assert callable(getattr(importlib.import_module(mod), fn))
        assert scripts[name.replace("-torch", "")] == target.replace(
            "consent_tpu_torch.", "consent_tpu.")


def test_native_source_is_the_originals():
    with open(os.path.join(REPO, "consent_tpu", "native", "host.cpp")) as f:
        orig = f.read()
    with open(os.path.join(REPO, "consent_tpu_torch", "native",
                           "host.cpp")) as f:
        assert f.read() == orig


def test_unported_paths_raise():
    """Device selection as the JAX package's engine makes it
    (consent_tpu/pipeline/engine.py:93-115): n_devices above the local
    count clamps to it, frag_devices is chosen automatically when one
    window's fragment slots exceed device_lanes, and max_lanes scales
    with the devices.  A config key the JAX package lacks still raises."""
    import dataclasses

    from consent_tpu_torch import correct_preset
    from consent_tpu_torch.config import from_reference
    from consent_tpu_torch.pipeline import engine

    cfg = correct_preset()
    four = ["cpu"] * 4

    def pick(devices=None, **kw):
        eng = engine.ConsensusEngine(dataclasses.replace(cfg, **kw),
                                     device="cpu", devices=devices)
        return eng.n_devices, eng.frag_devices, eng.mesh.shape, eng.max_lanes

    lanes = cfg.device_lanes
    assert pick(n_devices=2) == (1, 1, (1, 1), lanes)      # one local CPU
    assert pick(frag_devices=2) == (1, 1, (1, 1), lanes)
    assert pick(four, n_devices=16) == (4, 1, (4, 1), 4 * lanes)
    assert pick(four) == (4, 1, (4, 1), 4 * lanes)
    # s_cap = 152 slots > 128 lanes: the frag axis takes every device
    assert pick(four, device_lanes=128) == (4, 4, (1, 4), 512)
    assert pick(four, device_lanes=128, n_devices=2) == (2, 2, (1, 2), 256)
    assert pick(four, frag_devices=2) == (4, 2, (2, 2), 4 * lanes)
    with pytest.raises(ValueError):
        from_reference({**dataclasses.asdict(cfg), "extra_knob": 1})
