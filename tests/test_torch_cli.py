"""The port's consent-correct CLI on the CPU against the JAX package's:
the same flags must write the same FASTA bytes."""

import torch

from consent_tpu import cli as j_cli
from consent_tpu.io import seqs
from consent_tpu.testing import simulate
from consent_tpu_torch import cli as t_cli

torch.set_num_threads(2)


def test_main_correct_fasta_bytes_match_jax(tmp_path):
    # the tests/test_cli.py small dataset
    genome, reads = simulate.simulate(
        genome_len=2000, coverage=10.0, read_len=700,
        error_rate=0.08, seed=21,
    )
    reads_fa = tmp_path / "reads.fasta"
    with open(reads_fa, "w") as f:
        for r in reads:
            f.write(f">{r.name}\n{seqs.decode(r.codes)}\n")
    common = ["--in", str(reads_fa), "--windowSize", "200",
              "--windowOverlap", "20", "--overlapper", "native",
              "--nproc", "2"]
    j_out, t_out = tmp_path / "jax.fasta", tmp_path / "torch.fasta"
    assert j_cli.main_correct(common + ["--out", str(j_out)]) == 0
    assert t_cli.main_correct(
        common + ["--out", str(t_out), "--device", "cpu"]) == 0
    want, got = j_out.read_bytes(), t_out.read_bytes()
    assert want.count(b">") > len(reads) // 2
    assert want == got
