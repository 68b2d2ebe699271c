"""Command-line driver: consent-correct on PyTorch / CUDA.

Flag-for-flag the JAX package's consent-correct (the reference bash
driver's flags and defaults), plus `--device` (default cuda; the run
fails when it is asked for and there is no card).

Overlap sources, in priority order:
  * --paf FILE: a precomputed, query-grouped PAF (the reference's
    contract with minimap2),
  * minimap2 on PATH: invoked with the reference's exact argument
    strings,
  * built-in minimizer overlapper (consent_tpu_torch.overlap.minimizer).

Run as `python -m consent_tpu_torch.cli --in reads.fa --out out.fa`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

from consent_tpu_torch.config import correct_preset
from consent_tpu_torch.io import paf as paf_mod
from consent_tpu_torch.io import seqs
from consent_tpu_torch.io.fasta import ReadIndex, write_fasta_record
from consent_tpu_torch.pipeline import engine


def _common_flags(p: argparse.ArgumentParser) -> None:
    from consent_tpu_torch import __version__

    p.add_argument(
        "--version", "-v", action="version",
        version=f"consent-tpu-torch v{__version__} "
                f"(reference parity: CONSENT v2.2.2)",
    )
    p.add_argument("--out", required=True)
    p.add_argument("--type", choices=["PB", "ONT"], default="PB")
    p.add_argument("--windowSize", "-l", type=int, default=500)
    p.add_argument("--minSupport", "-s", type=int, default=3)
    p.add_argument("--maxSupport", "-S", type=int, default=150)
    p.add_argument("--maxMSA", "-M", type=int, default=150)
    p.add_argument("--merSize", "-k", type=int, default=9)
    p.add_argument("--solid", "-f", type=int, default=4)
    p.add_argument("--anchorSupport", "-c", type=int, default=8)
    p.add_argument("--minAnchors", "-a", type=int, default=2)
    p.add_argument("--windowOverlap", "-o", type=int, default=50)
    p.add_argument("--nproc", "-j", type=int, default=os.cpu_count())
    p.add_argument("--minimapIndex", "-m", default="1G",
                   help="minimap2 -I index chunk size "
                        "(reference: CONSENT-correct:24,185)")
    p.add_argument("--tmpdir", "-t", default=".")
    p.add_argument("--paf", help="precomputed query-grouped PAF")
    p.add_argument(
        "--overlapper", choices=["auto", "native", "minimap2"],
        default="auto",
    )
    p.add_argument("--consensus-rounds", type=int, default=2,
                   help="realign-vote refinement rounds (measured "
                        "accuracy/throughput tradeoff in config.py)")
    p.add_argument(
        "--resume", action="store_true",
        help="chunk-level checkpoint/resume (not supported yet)",
    )
    p.add_argument(
        "--chunk-retries", type=int, default=1,
        help="with --resume: retries per failed chunk (not supported yet)",
    )
    p.add_argument("--stats", action="store_true",
                   help="print per-stage timing stats to stderr")
    p.add_argument("--profile-dir", default=None,
                   help="write a profiler trace here (not supported yet)")
    p.add_argument("--process-index", type=int, default=None,
                   help="multi-host: this host's index (not supported yet)")
    p.add_argument("--process-count", type=int, default=None,
                   help="multi-host: total hosts (not supported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default) or cpu")


def _cfg_from_args(args):
    return correct_preset(
        window_size=args.windowSize,
        min_support=args.minSupport,
        max_support=args.maxSupport,
        max_msa=args.maxMSA,
        mer_size=args.merSize,
        solid_thresh=args.solid,
        common_kmers=args.anchorSupport,
        min_anchors=args.minAnchors,
        window_overlap=args.windowOverlap,
        consensus_rounds=args.consensus_rounds,
        n_workers=args.nproc,
        # indel-heavy ONT reads keep deeper warm refinement rounds
        warm_frac=0.5 if getattr(args, "type", "PB") == "ONT" else 0.25,
    )


def _minimap2_args(reads_type: str) -> list:
    """The reference's exact minimap2 invocations
    (CONSENT-correct:185,187)."""
    if reads_type == "ONT":
        return (
            "-k15 -w5 -m100 -g10000 -r2000 --max-chain-skip 25 "
            "--dual=yes -PD --no-long-join"
        ).split()
    return "--dual=yes -PD --no-long-join -w5 -g1000 -m30 -n1".split()


def _run_minimap2(reads_type, target, query, out_paf, nproc,
                  index_size="1G"):
    cmd = (
        ["minimap2"]
        + _minimap2_args(reads_type)
        + ["-t", str(nproc), "-I", str(index_size), target, query]
    )
    with open(out_paf, "w") as f:
        subprocess.run(cmd, stdout=f, check=True)


def _piles_from_file(path, max_support, unlink=False):
    """Pile iterator over a PAF file; the handle closes on exhaustion.
    unlink=True removes the file as soon as it is opened."""
    with open(path) as f:
        if unlink:
            os.unlink(path)
        yield from paf_mod.iter_piles(f, max_support)


def _correct_pile_stream(args, index):
    if args.paf:
        return _piles_from_file(args.paf, args.maxSupport)
    use_minimap = (
        args.overlapper == "minimap2"
        or (args.overlapper == "auto" and shutil.which("minimap2"))
    )
    if use_minimap:
        tmp = tempfile.NamedTemporaryFile(
            dir=args.tmpdir, suffix=".paf", delete=False
        )
        tmp.close()
        _run_minimap2(args.type, args.infile, args.infile, tmp.name,
                      args.nproc, index_size=args.minimapIndex)
        grouped = tmp.name + ".grouped"
        paf_mod.group_paf_by_query(tmp.name, grouped)
        os.unlink(tmp.name)
        return _piles_from_file(grouped, args.maxSupport, unlink=True)
    # native overlapper
    from consent_tpu_torch.overlap import minimizer as mz

    named = [(n, index[n]) for n in index.names()]
    params = mz.OverlapParams()
    return mz.all_vs_all_piles(named, params, args.maxSupport)


def main_correct(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="consent-correct",
        description="Long-read self-correction on PyTorch / CUDA",
    )
    p.add_argument("--in", dest="infile", required=True)
    p.add_argument(
        "--proof", "-p", default=None,
        help="extra proof-read FASTA indexed alongside the input; "
             "disables trimming (reference -p, "
             "CONSENT-correction.cpp:70-73)",
    )
    _common_flags(p)
    args = p.parse_args(argv)

    from consent_tpu_torch.pipeline.device_align import resolve_device

    resolve_device(args.device)     # fail before any work without a card
    cfg = _cfg_from_args(args)
    index = ReadIndex.from_file(args.infile)
    if args.proof:
        import dataclasses as _dc

        index.add_file(args.proof)
        cfg = _dc.replace(cfg, trim=False)
    piles = _correct_pile_stream(args, index)
    n_in, n_out = _drive(piles, index, cfg, args, "consent-correct")
    print(f"[consent-correct] {n_out}/{n_in} reads corrected -> {args.out}",
          file=sys.stderr)
    return 0


def _drive(piles, index, cfg, args, label):
    """Run the pipeline over a pile stream in one process on one
    device, with stage stats.  Multi-host sharding, chunk-level resume
    and profiler traces are not ported yet and raise."""
    from consent_tpu_torch.utils.observe import GLOBAL_STATS, profiler_trace

    if (args.process_count or 1) > 1:
        raise NotImplementedError(
            "--process-count > 1: multi-host runs are not supported yet"
        )
    if args.resume:
        raise NotImplementedError("--resume is not supported yet")

    n_in = n_out = 0
    with profiler_trace(args.profile_dir), GLOBAL_STATS.timer(
        f"{label}.pipeline"
    ):
        with open(args.out, "w") as out:
            for name, codes, solid in engine.process_piles(
                iter(piles), index, cfg, device=args.device
            ):
                n_in += 1
                if len(codes) == 0:
                    continue
                n_out += 1
                write_fasta_record(out, name, seqs.decode(codes, solid))
    if args.stats:
        GLOBAL_STATS.report()
    return n_in, n_out


if __name__ == "__main__":
    sys.exit(main_correct())
