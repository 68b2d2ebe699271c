"""Guards of the PyTorch port: it imports neither jax nor consent_tpu,
its device entry points refuse to run on a missing card, the paths it
does not have yet raise, and its copied host modules still match the
JAX package's originals."""

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


def test_native_source_is_the_originals():
    with open(os.path.join(REPO, "consent_tpu", "native", "host.cpp")) as f:
        orig = f.read()
    with open(os.path.join(REPO, "consent_tpu_torch", "native",
                           "host.cpp")) as f:
        assert f.read() == orig


def test_unported_paths_raise(tmp_path):
    import dataclasses

    from consent_tpu_torch import cli, correct_preset
    from consent_tpu_torch.config import from_reference
    from consent_tpu_torch.pipeline import engine

    cfg = correct_preset()
    for bad in (dict(n_devices=2), dict(frag_devices=2)):
        with pytest.raises(NotImplementedError):
            engine.ConsensusEngine(dataclasses.replace(cfg, **bad),
                                   device="cpu")
    fa = tmp_path / "r.fa"
    fa.write_text(">r\nACGT\n")
    base = ["--in", str(fa), "--out", str(tmp_path / "o.fa"),
            "--device", "cpu", "--overlapper", "native"]
    for extra in (["--resume"], ["--process-count", "2"],
                  ["--profile-dir", str(tmp_path)]):
        with pytest.raises(NotImplementedError):
            cli.main_correct(base + extra)
    with pytest.raises(ValueError):
        from_reference({**dataclasses.asdict(cfg), "extra_knob": 1})
