"""Command-line drivers: consent-correct / consent-polish on PyTorch / CUDA.

Flag-for-flag the JAX package's drivers (the reference bash drivers'
flags and defaults), plus `--device` (default cuda; the run fails when
it is asked for and there is no card).

Overlap sources, in priority order:
  * --paf FILE: a precomputed, query-grouped PAF (the reference's
    contract with minimap2),
  * minimap2 on PATH: invoked with the reference's exact argument
    strings (CONSENT-correct:185-187, CONSENT-polish:189),
  * built-in minimizer overlapper (consent_tpu_torch.overlap.minimizer).

Run as `python -m consent_tpu_torch.cli --in reads.fa --out out.fa`
(consent-correct), or through the console scripts consent-torch-correct,
consent-torch-polish and consent-torch-merge-shards.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

from consent_tpu_torch.config import correct_preset, polish_preset
from consent_tpu_torch.io import paf as paf_mod
from consent_tpu_torch.io import seqs
from consent_tpu_torch.io.fasta import ReadIndex, write_fasta_record
from consent_tpu_torch.pipeline import engine


def _common_flags(p: argparse.ArgumentParser, correct: bool) -> None:
    d_minsup = 3 if correct else 1
    d_maxsup = 150 if correct else 20000
    from consent_tpu_torch import __version__

    p.add_argument(
        "--version", "-v", action="version",
        version=f"consent-tpu-torch v{__version__} "
                f"(reference parity: CONSENT v2.2.2)",
    )
    p.add_argument("--out", required=True)
    p.add_argument("--type", choices=["PB", "ONT"], default="PB")
    p.add_argument("--windowSize", "-l", type=int, default=500)
    p.add_argument("--minSupport", "-s", type=int, default=d_minsup)
    p.add_argument("--maxSupport", "-S", type=int, default=d_maxsup)
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
        help="chunk-level checkpoint/resume under <out>.chunks/",
    )
    p.add_argument(
        "--chunk-retries", type=int, default=1,
        help="with --resume: retries per failed chunk before it is "
             "quarantined (recorded in the manifest; the run continues "
             "and a --resume rerun retries quarantined chunks)",
    )
    p.add_argument("--stats", action="store_true",
                   help="print per-stage timing stats to stderr")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace here")
    p.add_argument("--process-index", type=int, default=None,
                   help="multi-host: this host's index (piles shard "
                        "round-robin; output goes to <out>.shardNNNNN)")
    p.add_argument("--process-count", type=int, default=None,
                   help="multi-host: total hosts")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default) or cpu")


def _cfg_from_args(args, correct: bool):
    preset = correct_preset if correct else polish_preset
    return preset(
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


def _minimap2_args(kind: str, reads_type: str) -> list:
    """The reference's exact minimap2 invocations
    (CONSENT-correct:185,187; CONSENT-polish:189)."""
    if kind == "correct" and reads_type == "ONT":
        return (
            "-k15 -w5 -m100 -g10000 -r2000 --max-chain-skip 25 "
            "--dual=yes -PD --no-long-join"
        ).split()
    return "--dual=yes -PD --no-long-join -w5 -g1000 -m30 -n1".split()


def _run_minimap2(kind, reads_type, target, query, out_paf, nproc,
                  index_size="1G"):
    cmd = (
        ["minimap2"]
        + _minimap2_args(kind, reads_type)
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


def _use_minimap2(args) -> bool:
    return args.overlapper == "minimap2" or (
        args.overlapper == "auto" and bool(shutil.which("minimap2"))
    )


def _correct_pile_stream(args, index):
    if args.paf:
        return _piles_from_file(args.paf, args.maxSupport)
    if _use_minimap2(args):
        tmp = tempfile.NamedTemporaryFile(
            dir=args.tmpdir, suffix=".paf", delete=False
        )
        tmp.close()
        _run_minimap2("correct", args.type, args.infile, args.infile,
                      tmp.name, args.nproc, index_size=args.minimapIndex)
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
    _common_flags(p, correct=True)
    args = p.parse_args(argv)

    from consent_tpu_torch.pipeline.device_align import resolve_device

    resolve_device(args.device)     # fail before any work without a card
    cfg = _cfg_from_args(args, correct=True)
    index = ReadIndex.from_file(args.infile)
    if args.proof:
        import dataclasses as _dc

        index.add_file(args.proof)
        cfg = _dc.replace(cfg, trim=False)
    piles = _correct_pile_stream(args, index)
    n_in, n_out, n_quar = _drive(piles, index, cfg, args,
                                 "consent-correct")
    print(f"[consent-correct] {n_out}/{n_in} reads corrected -> {args.out}",
          file=sys.stderr)
    # quarantined chunks mean reads are missing from the output —
    # exit non-zero so downstream pipelines can detect the truncation
    return 1 if n_quar else 0


CHUNK_PILES = 256


def _drive(piles, index, cfg, args, label):
    """Run the pipeline over a pile stream on one device.

    One code path for every mode: multi-host sharding (explicit
    --process-index/--process-count, or PyTorch's RANK/WORLD_SIZE),
    chunk-level resume with a config/input run-key guard, stage stats,
    and profiler tracing all compose.  Multi-host shards stream — no
    materialization — and their records carry pile-ordinal tags that
    consent-merge-shards strips while restoring global order."""
    import collections
    import dataclasses as _dc

    from consent_tpu_torch.parallel import multihost
    from consent_tpu_torch.utils.observe import GLOBAL_STATS, profiler_trace

    proc_idx, proc_cnt = args.process_index, args.process_count
    if proc_cnt is None:
        proc_idx, proc_cnt = multihost.init_distributed()
    proc_idx = int(proc_idx or 0)
    proc_cnt = int(proc_cnt or 1)
    multi = proc_cnt > 1

    ordinals: collections.deque = collections.deque()
    if multi:
        def _shard(src):
            for i, p in enumerate(src):
                if i % proc_cnt == proc_idx:
                    ordinals.append(i)
                    yield p

        stream = _shard(iter(piles))
        out_path = multihost.shard_path(args.out, proc_idx)
    else:
        stream = iter(piles)
        out_path = args.out

    n_in = n_out = 0
    n_quarantined = 0

    def results():
        """Per input pile: (header, decoded seq), or None if dropped."""
        nonlocal n_in, n_out
        for name, codes, solid in engine.process_piles(
            stream, index, cfg, device=args.device
        ):
            n_in += 1
            ordinal = ordinals.popleft() if multi else None
            if len(codes) == 0:
                yield None
                continue
            n_out += 1
            header = f"{name} #{ordinal}" if multi else name
            yield header, seqs.decode(codes, solid)

    with profiler_trace(args.profile_dir), GLOBAL_STATS.timer(
        f"{label}.pipeline"
    ):
        if args.resume:
            import itertools

            from consent_tpu_torch.pipeline.checkpoint import ChunkStore

            run_key = {
                "config": _dc.asdict(cfg),
                "label": label,
                "process": [proc_idx, proc_cnt],
                "in": getattr(args, "infile", None)
                      or getattr(args, "contigs", None),
                "paf": args.paf,
            }
            store = ChunkStore(out_path, run_key=run_key)
            retries = max(0, getattr(args, "chunk_retries", 1))

            def run_chunk(batch, batch_ords):
                recs = []
                n_kept = 0
                for j, (name, codes, solid) in enumerate(
                    engine.process_piles(iter(batch), index, cfg,
                                         device=args.device)
                ):
                    if len(codes) == 0:
                        continue
                    n_kept += 1
                    header = (
                        f"{name} #{batch_ords[j]}" if multi else name
                    )
                    recs.append((header, seqs.decode(codes, solid)))
                return recs, n_kept

            chunk_idx = 0
            while True:
                batch = list(itertools.islice(stream, CHUNK_PILES))
                if not batch:
                    break
                batch_ords = (
                    [ordinals.popleft() for _ in batch] if multi else None
                )
                if store.is_done(chunk_idx):
                    chunk_idx += 1
                    continue
                # shard-level failure isolation: retry, then quarantine
                # and continue (a --resume rerun retries exactly the
                # quarantined chunks)
                err = None
                for attempt in range(1 + retries):
                    try:
                        recs, n_kept = run_chunk(batch, batch_ords)
                    except Exception as e:  # noqa: BLE001
                        err = e
                        print(
                            f"[{label}] chunk {chunk_idx} failed "
                            f"(attempt {attempt + 1}/{1 + retries}): "
                            f"{e!r}",
                            file=sys.stderr,
                        )
                        continue
                    store.write_chunk(chunk_idx, recs)
                    n_in += len(batch)
                    n_out += n_kept
                    break
                else:
                    store.quarantine(chunk_idx, repr(err))
                    print(
                        f"[{label}] chunk {chunk_idx} quarantined "
                        f"after {1 + retries} attempts; continuing "
                        f"(rerun with --resume to retry it)",
                        file=sys.stderr,
                    )
                chunk_idx += 1
            store.assemble(out_path)
            quarantined = store.quarantined_chunks()
            if quarantined:
                # incomplete output must be machine-detectable: the
                # drivers exit non-zero when chunks are missing (a
                # --resume rerun retries exactly these chunks)
                n_quarantined = len(quarantined)
                print(
                    f"[{label}] WARNING: {len(quarantined)} chunk(s) "
                    f"quarantined and missing from {out_path}: "
                    f"{quarantined}",
                    file=sys.stderr,
                )
        else:
            with open(out_path, "w") as out:
                for item in results():
                    if item is not None:
                        write_fasta_record(out, *item)
    if args.stats:
        GLOBAL_STATS.report()
    return n_in, n_out, n_quarantined


def _polish_pile_stream(args, contig_index, read_index):
    if args.paf:
        # expects the reference's reformatted, contig-grouped PAF
        return _piles_from_file(args.paf, args.maxSupport)
    if _use_minimap2(args):
        raw = tempfile.NamedTemporaryFile(
            dir=args.tmpdir, suffix=".paf", delete=False
        )
        raw.close()
        _run_minimap2("polish", args.type, args.contigs, args.reads,
                      raw.name, args.nproc, index_size=args.minimapIndex)
        srt = raw.name + ".sorted"
        ref = raw.name + ".reformatted"
        paf_mod.sort_by_target(raw.name, srt)
        paf_mod.reformat_file(srt, ref)
        os.unlink(raw.name)
        os.unlink(srt)
        return _piles_from_file(ref, args.maxSupport, unlink=True)
    from consent_tpu_torch.overlap import minimizer as mz

    contigs = [(n, contig_index[n]) for n in contig_index.names()]
    reads = [(n, read_index[n]) for n in read_index.names()]
    return mz.map_to_targets_piles(
        contigs, reads, mz.OverlapParams(), args.maxSupport
    )


def main_polish(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="consent-polish",
        description="Assembly polishing on PyTorch / CUDA",
    )
    p.add_argument("--contigs", required=True)
    p.add_argument("--reads", required=True)
    _common_flags(p, correct=False)
    args = p.parse_args(argv)

    from consent_tpu_torch.pipeline.device_align import resolve_device

    resolve_device(args.device)     # fail before any work without a card
    cfg = _cfg_from_args(args, correct=False)
    contig_index = ReadIndex.from_file(args.contigs)
    read_index = ReadIndex.from_file(args.reads)
    # the polishing core indexes contigs AND reads into one map
    # (CONSENT-polishing.cpp:114-117)
    merged = ReadIndex()
    for n in contig_index.names():
        merged.add(n, contig_index[n])
    for n in read_index.names():
        merged.add(n, read_index[n])

    piles = _polish_pile_stream(args, contig_index, read_index)
    n_in, n_out, n_quar = _drive(piles, merged, cfg, args,
                                 "consent-polish")
    print(f"[consent-polish] {n_out}/{n_in} contigs polished -> {args.out}",
          file=sys.stderr)
    return 1 if n_quar else 0


def main_merge_shards(argv=None) -> int:
    """Merge per-host output shards back into pile order."""
    p = argparse.ArgumentParser(prog="consent-merge-shards")
    p.add_argument("--out", required=True, help="final FASTA path; "
                   "shards are <out>.shardNNNNN")
    p.add_argument("--process-count", type=int, required=True)
    args = p.parse_args(argv)
    from consent_tpu_torch.parallel import multihost
    from consent_tpu_torch.pipeline.checkpoint import ChunkStore

    multihost.merge_shards(args.out, args.process_count, args.out)
    # surface any quarantined chunks left behind by --resume shards
    for pidx in range(args.process_count):
        sdir = multihost.shard_path(args.out, pidx) + ".chunks"
        if not os.path.isdir(sdir):
            continue
        q = ChunkStore(
            multihost.shard_path(args.out, pidx)
        ).quarantined_chunks()
        if q:
            print(
                f"[consent-merge-shards] WARNING: shard {pidx} has "
                f"{len(q)} quarantined chunk(s) {q} — their reads are "
                f"missing; rerun that shard with --resume",
                file=sys.stderr,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main_correct())
