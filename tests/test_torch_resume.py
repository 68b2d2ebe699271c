"""The port's driver features on the CPU: --resume (run key, retries,
quarantine, repair), multi-host shards and their merge, the launcher's
RANK / WORLD_SIZE, consent-eval and --profile-dir.  Each run is held
against the port's own plain run; only consent-eval is compared with
the JAX package."""

import json
import os

import pytest
import torch

from consent_tpu import tools as j_tools
from consent_tpu.io import seqs
from consent_tpu.testing import simulate
from consent_tpu_torch import cli, tools
from consent_tpu_torch.ops import cuda_align
from consent_tpu_torch.parallel import multihost
from consent_tpu_torch.pipeline import engine
from consent_tpu_torch.pipeline.checkpoint import ChunkStore, ResumeMismatch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """A small read set (20 reads of 600 bases at 8% error, 1.5 kb
    genome) and the port's plain consent-correct run on it: (flags
    without --out, output text, output path, truth FASTA)."""
    tmp = tmp_path_factory.mktemp("resume")
    genome, reads = simulate.simulate(
        genome_len=1500, coverage=8.0, read_len=600,
        error_rate=0.08, seed=21,
    )
    reads_fa = tmp / "reads.fasta"
    with open(reads_fa, "w") as f:
        for r in reads:
            f.write(f">{r.name}\n{seqs.decode(r.codes)}\n")
    truth_fa = tmp / "truth.fasta"
    with open(truth_fa, "w") as f:
        for r in reads:
            t = genome[r.g_beg : r.g_end]
            if r.reverse:
                t = seqs.revcomp(t)
            f.write(f">{r.name}\n{seqs.decode(t)}\n")
    flags = ["--in", str(reads_fa), "--windowSize", "200",
             "--windowOverlap", "20", "--overlapper", "native",
             "--nproc", "2", "--device", "cpu"]
    out = tmp / "plain.fasta"
    assert cli.main_correct(flags + ["--out", str(out)]) == 0
    text = out.read_text()
    assert text.count(">") > len(reads) // 2
    return flags, text, out, truth_fa


def test_resume_twice_matches_plain_run(plain, tmp_path):
    flags, want, _, _ = plain
    out = tmp_path / "resumed.fasta"
    # the first pass writes every chunk; the second finds them all done
    # and only assembles
    for _ in range(2):
        assert cli.main_correct(flags + ["--out", str(out), "--resume"]) == 0
        assert out.read_text() == want
    store = ChunkStore(str(out))
    assert store.n_complete_prefix() == 1 and not store.quarantined_chunks()


def test_resume_config_mismatch_aborts(plain, tmp_path):
    """A store written under one config refuses a run under another
    (an empty PAF keeps the first run free of work)."""
    flags, _, _, _ = plain
    paf = tmp_path / "empty.paf"
    paf.write_text("")
    out = tmp_path / "guard.fasta"
    assert cli.main_correct(flags + ["--out", str(out), "--resume",
                                     "--paf", str(paf)]) == 0
    changed = [("40" if a == "20" else a) for a in flags]  # windowOverlap
    with pytest.raises(ResumeMismatch):
        cli.main_correct(changed + ["--out", str(out), "--resume",
                                    "--paf", str(paf)])


def test_chunk_failure_is_quarantined_and_repaired(plain, tmp_path,
                                                   monkeypatch, capsys):
    """A chunk that fails every retry is quarantined, the run goes on
    and returns 1; a --resume rerun with the fault gone repairs it."""
    flags, want, _, _ = plain
    monkeypatch.setattr(cli, "CHUNK_PILES", 4)
    real = engine.process_piles
    calls = {"n": 0}

    def flaky(piles, index, cfg, **kw):
        calls["n"] += 1
        if calls["n"] in (2, 3):  # chunk 1: first attempt and its retry
            raise RuntimeError("injected chunk failure")
        yield from real(piles, index, cfg, **kw)

    monkeypatch.setattr(engine, "process_piles", flaky)
    out = tmp_path / "quar.fasta"
    assert cli.main_correct(flags + ["--out", str(out), "--resume"]) == 1
    assert "chunk 1 quarantined" in capsys.readouterr().err
    partial = out.read_text()
    assert partial and len(partial) < len(want)
    assert ChunkStore(str(out)).quarantined_chunks() == [1]

    monkeypatch.setattr(engine, "process_piles", real)
    assert cli.main_correct(flags + ["--out", str(out), "--resume"]) == 0
    assert out.read_text() == want
    assert not ChunkStore(str(out)).quarantined_chunks()


def test_kernel_failure_under_resume_exits_1(plain, tmp_path, monkeypatch):
    """An aligner launch that fails (as a CUDA kernel does with an
    error code) quarantines every chunk it reaches: the run returns 1,
    never 0."""
    flags, _, _, _ = plain

    def failing(*a, **k):
        raise RuntimeError("banded_posterior launch failed: CUDA error 700")

    monkeypatch.setattr(cuda_align, "posterior_summary", failing)
    out = tmp_path / "kfail.fasta"
    rc = cli.main_correct(flags + ["--out", str(out), "--resume",
                                   "--chunk-retries", "0"])
    assert rc == 1
    assert ChunkStore(str(out)).quarantined_chunks() == [0]
    assert out.read_text() == ""


@pytest.mark.parametrize("resume", [False, True], ids=["plain", "resume"])
def test_two_shards_merge_to_the_plain_run(plain, tmp_path, resume):
    flags, want, _, _ = plain
    merged = tmp_path / "merged.fasta"
    extra = ["--resume", "--stats"] if resume else []
    for idx in (0, 1):
        assert cli.main_correct(flags + [
            "--out", str(merged), "--process-index", str(idx),
            "--process-count", "2"] + extra) == 0
        shard = multihost.shard_path(str(merged), idx)
        heads = [ln for ln in open(shard) if ln.startswith(">")]
        assert heads and all(" #" in h for h in heads)
    assert cli.main_merge_shards(
        ["--out", str(merged), "--process-count", "2"]) == 0
    assert merged.read_text() == want


@pytest.mark.parametrize("env, want", [
    ({}, (0, 1)),
    ({"WORLD_SIZE": "1", "RANK": "0"}, (0, 1)),
    ({"WORLD_SIZE": "4", "RANK": "3"}, (3, 4)),
])
def test_init_distributed_reads_rank_and_world_size(monkeypatch, env, want):
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    assert multihost.init_distributed() == want


@pytest.mark.parametrize("extra", [["--per-record"],
                                   ["--profile", "--trimmed"]],
                         ids=["identity", "profile"])
def test_main_eval_prints_the_jax_line(plain, capsys, extra):
    _, _, out, truth_fa = plain
    argv = ["--test", str(out), "--truth", str(truth_fa)] + extra
    assert j_tools.main_eval(argv) == 0
    want = capsys.readouterr()
    assert tools.main_eval(argv) == 0
    got = capsys.readouterr()
    assert "mean_identity=" in want.err
    assert (got.out, got.err) == (want.out, want.err)


def test_profile_dir_writes_a_trace(plain, tmp_path):
    flags, want, _, _ = plain
    out = tmp_path / "traced.fasta"
    trace_dir = tmp_path / "trace"
    assert cli.main_correct(flags + ["--out", str(out), "--profile-dir",
                                     str(trace_dir)]) == 0
    assert out.read_text() == want
    (trace,) = os.listdir(trace_dir)
    with open(trace_dir / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    # the stage spans, the pool threads' among them, as host ranges
    names = {e.get("name") for e in events}
    assert {"pipeline.stitch", "host_post.run", "geometry.run"} <= names
