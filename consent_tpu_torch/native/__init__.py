"""ctypes bindings for the native host library (host.cpp, with
stitch_rounds.cpp's table of a chunk's stitch jobs and spans_wire.cpp's
packer of the stitch aligner's wire rows).

Compiled with g++ on first use into the gitignored build/ directory
(utils/build.py).  The pipeline requires the library: get_lib() raises
when it cannot be built or loaded.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from consent_tpu_torch.utils.observe import GLOBAL_STATS as STATS

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host.cpp")
_SRC_ROUNDS = os.path.join(_HERE, "stitch_rounds.cpp")
_SRC_WIRE = os.path.join(_HERE, "spans_wire.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built on first use; raises
    RuntimeError when g++ fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from consent_tpu_torch.utils.build import build_shared

        # -march=native: the library is always compiled on the host that
        # runs it (first-use build); fall back to plain -O3 for toolchains
        # that reject the flag
        base = ["g++", "-shared", "-fPIC", "-std=c++17"]
        path = build_shared(
            "consent_host", [_SRC, _SRC_ROUNDS, _SRC_WIRE],
            [base + ["-O3", "-march=native"], base + ["-O3"]],
        )
        lib = ctypes.CDLL(path)

        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")

        lib.encode_seq.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p]
        lib.revcomp.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.count_kmers.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int, i32p
        ]
        lib.count_kmers_touched.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int, i32p, i64p
        ]
        lib.count_kmers_touched.restype = ctypes.c_int64
        lib.polish_correction.argtypes = [
            u8p, u8p, ctypes.c_int64, i32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            u8p, u8p, ctypes.c_int64,
        ]
        lib.polish_correction.restype = ctypes.c_int64
        lib.count_anchors.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int
        ]
        lib.count_anchors.restype = ctypes.c_int64
        lib.host_post_window.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64,
            u8p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            i32p, i64p, i64p,
            u8p, u8p, ctypes.c_int64, i32p,
        ]
        lib.host_post_window.restype = ctypes.c_int64
        lib.host_post_batch.argtypes = [
            u8p, i64p, i64p, i64p, ctypes.c_int64,
            u8p, i64p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, i32p,
            u8p, u8p, ctypes.c_int64, i64p,
            i64p, i32p, ctypes.c_int64, i64p,
            i32p,
        ]
        lib.host_post_batch.restype = ctypes.c_int64
        lib.assemble_windows.argtypes = [
            i8p, i8p, u8p, i32p, i32p, i32p, i32p, i32p,
            i32p, ctypes.c_int64, ctypes.c_int64,
            u8p, ctypes.c_int64, i64p,
        ]
        lib.assemble_windows.restype = ctypes.c_int64
        lib.local_align_span.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i64p,
        ]
        lib.local_align_span.restype = ctypes.c_int64
        lib.stitch_apply_step.argtypes = [
            u8p, u8p, ctypes.c_int64,
            u8p, u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
            u8p, u8p, ctypes.c_int64, ctypes.c_int64,
            i64p, i32p, ctypes.c_int64,
            i64p, i32p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64,
            u8p, u8p, ctypes.c_int64,
            u8p, u8p, ctypes.c_int64,
            i64p,
        ]
        lib.stitch_apply_step.restype = None
        lib.posterior_spans_batch.argtypes = [
            u8p, i64p, i64p, u8p, i64p, i64p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p,
        ]
        lib.posterior_spans_batch.restype = None
        upp = np.ctypeslib.ndpointer(np.uintp, flags="C_CONTIGUOUS")
        lib.stitch_apply_round.argtypes = [
            ctypes.c_int64,
            upp, upp, upp, upp, upp, upp, upp, upp, upp, upp,
            i64p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, u8p, i64p, u8p, u8p, i64p, i64p,
        ]
        lib.stitch_apply_round.restype = None
        i64 = ctypes.c_int64
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.sr_new.argtypes = [
            i64, i64p, u8p, i64p, u64p, u64p, i64p, i64p, i64p, u64p, u64p,
            i64p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, i64, i64,
        ]
        lib.sr_new.restype = ctypes.c_void_p
        lib.sr_free.argtypes = [ctypes.c_void_p]
        lib.sr_free.restype = None
        lib.sr_requests.argtypes = [
            ctypes.c_void_p, i64p, i64, u8p, i64, i64p, i64p, u8p, i64,
            i64p, i64p,
        ]
        lib.sr_requests.restype = i64
        lib.sr_apply.argtypes = [ctypes.c_void_p, i64p, i64, i32p]
        lib.sr_apply.restype = i64
        lib.sr_results.argtypes = [ctypes.c_void_p, i64p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
        lib.sr_results.restype = None
        lib.spans_wire_pack.argtypes = [
            u8p, i64p, i64p, u8p, i64p, i64p, i64, i64, i64, i64, u8p,
        ]
        lib.spans_wire_pack.restype = None
        _lib = lib
        return _lib


def polish_correction_native(codes, solid, counts, k, solid_thresh,
                             max_branches=50, zone=3):
    """Native DBG repair; returns (codes, solid), or None when the
    output capacity check fails (caller falls back to core.dbg)."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    solid = np.ascontiguousarray(
        np.asarray(solid).astype(np.uint8)
    )
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    cap = 2 * len(codes) + 256
    out_c = np.empty(cap, dtype=np.uint8)
    out_s = np.empty(cap, dtype=np.uint8)
    n = lib.polish_correction(
        codes, solid, len(codes), counts, k, solid_thresh,
        max_branches, zone,
        out_c, out_s, cap,
    )
    if n < 0:
        return None
    return out_c[:n].copy(), out_s[:n].astype(bool)


def count_anchors_native(frag_list, k, support):
    """Native anchor count over one window's sequences (template first);
    the same statistic as ops.kmer.count_anchors_host."""
    lib = get_lib()
    if not frag_list:
        return 0
    lens = np.array([len(f) for f in frag_list], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    blob = np.concatenate(
        [np.ascontiguousarray(f, dtype=np.uint8) for f in frag_list]
    ) if lens.sum() else np.zeros(1, np.uint8)
    return int(lib.count_anchors(blob, lens, offsets, len(frag_list), k,
                                 support))


def count_kmers_native(frag_list, k):
    """Native dense k-mer counting: [4^k] int32 counts."""
    lib = get_lib()
    if not frag_list:
        return np.zeros(4 ** k, dtype=np.int32)
    lens = np.array([len(f) for f in frag_list], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    blob = np.concatenate(
        [np.ascontiguousarray(f, dtype=np.uint8) for f in frag_list]
    ) if lens.sum() else np.zeros(1, np.uint8)
    counts = np.zeros(4 ** k, dtype=np.int32)
    lib.count_kmers(blob, lens, offsets, len(frag_list), k, counts)
    return counts


def count_kmers_sparse_native(frag_list, k):
    """Native dense k-mer counting that also returns the sorted
    distinct k-mers, skipping the 4^k flatnonzero scan; returns
    (dense, sorted_kmers)."""
    lib = get_lib()
    counts = np.zeros(4 ** k, dtype=np.int32)
    if not frag_list:
        return counts, np.empty(0, dtype=np.int64)
    lens = np.array([len(f) for f in frag_list], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    blob = np.concatenate(
        [np.ascontiguousarray(f, dtype=np.uint8) for f in frag_list]
    ) if lens.sum() else np.zeros(1, np.uint8)
    cap = int(np.maximum(lens - k + 1, 0).sum())
    touched = np.empty(max(cap, 1), dtype=np.int64)
    nt = lib.count_kmers_touched(blob, lens, offsets, len(frag_list),
                                 k, counts, touched)
    keys = np.sort(touched[:nt])
    return counts, keys


def host_post_window_native(frag_list, cons, k, solid_thresh,
                            max_branches, zone, min_anchors,
                            bmean_sup, status=None):
    """Whole per-window host post chain in ONE native call (counts,
    anchor gate, solidity, DBG polish); returns (codes, solid,
    SparseCounts), or None when an output capacity check fails.
    `status`, an int32 [1] array, receives host.cpp's status: 0
    polished, 1 the template kept at the anchor gate, 2 a consensus
    shorter than k."""
    if not frag_list:
        return None
    lib = get_lib()
    from consent_tpu_torch.core.sparse_counts import SparseCounts

    lens = np.array([len(f) for f in frag_list], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    blob = np.concatenate(
        [np.ascontiguousarray(f, dtype=np.uint8) for f in frag_list]
    ) if lens.sum() else np.zeros(1, np.uint8)
    cons = np.ascontiguousarray(cons, dtype=np.uint8)
    dense = np.zeros(4 ** k, dtype=np.int32)
    cap = int(np.maximum(lens - k + 1, 0).sum())
    touched = np.empty(max(cap, 1), dtype=np.int64)
    nt = np.zeros(1, dtype=np.int64)
    out_cap = 2 * max(len(cons), int(lens[0])) + 256
    out_c = np.empty(out_cap, dtype=np.uint8)
    out_s = np.empty(out_cap, dtype=np.uint8)
    if status is None:
        status = np.zeros(1, dtype=np.int32)
    n = lib.host_post_window(
        blob, lens, offsets, len(frag_list), cons, len(cons),
        k, solid_thresh, max_branches, zone, min_anchors, bmean_sup,
        dense, touched, nt, out_c, out_s, out_cap, status,
    )
    if n < 0:
        return None
    keys = np.sort(touched[: nt[0]])
    sparse = SparseCounts(keys, dense[keys].astype(np.int32))
    return out_c[:n].copy(), out_s[:n].astype(bool), sparse


def host_post_batch_native(frag_lists, cons_list, bmean_sups, k,
                           solid_thresh, max_branches, zone,
                           min_anchors, status=None):
    """Whole host post chain for MANY windows in ONE native call
    (host.cpp host_post_batch); returns a list of (codes, solid,
    SparseCounts), or None when an output capacity check fails.  Per-window
    results are byte-identical to host_post_window_native; `status`
    (int32, a slot a window) receives their statuses.

    Timed as `host_post.native` (the call, the GIL released) and
    `host_post.marshal` (packing before it and unpacking after it, the
    GIL held), each with its thread's CPU seconds (`.cpu`)."""
    lib = get_lib()
    from consent_tpu_torch.core.sparse_counts import SparseCounts

    with STATS.cpu_timer("host_post.marshal"):
        n_win = len(frag_lists)
        win_frag_off = np.zeros(n_win + 1, dtype=np.int64)
        all_frags = []
        for w, fl in enumerate(frag_lists):
            all_frags.extend(fl)
            win_frag_off[w + 1] = len(all_frags)
        lens = np.array([len(f) for f in all_frags], dtype=np.int64)
        if len(lens) == 0:
            lens = np.zeros(0, dtype=np.int64)
        offsets = np.zeros(len(lens), dtype=np.int64)
        if len(lens):
            offsets[1:] = np.cumsum(lens)[:-1]
        blob = (
            np.concatenate(
                [np.ascontiguousarray(f, dtype=np.uint8) for f in all_frags]
            )
            if lens.sum()
            else np.zeros(1, np.uint8)
        )
        cons_off = np.zeros(n_win + 1, dtype=np.int64)
        for w, c in enumerate(cons_list):
            cons_off[w + 1] = cons_off[w] + len(c)
        cons_blob = (
            np.concatenate(
                [np.ascontiguousarray(c, dtype=np.uint8) for c in cons_list]
            )
            if cons_off[-1]
            else np.zeros(1, np.uint8)
        )
        sup = np.asarray(bmean_sups, dtype=np.int32)

        keys_cap = int(np.maximum(lens - k + 1, 0).sum())
        out_cap = 0
        for w in range(n_win):
            tpl_len = int(lens[win_frag_off[w]]) if (
                win_frag_off[w + 1] > win_frag_off[w]
            ) else 0
            out_cap += 2 * max(len(cons_list[w]), tpl_len) + 256
        out_c = np.empty(max(out_cap, 1), dtype=np.uint8)
        out_s = np.empty(max(out_cap, 1), dtype=np.uint8)
        out_off = np.zeros(n_win + 1, dtype=np.int64)
        keys = np.empty(max(keys_cap, 1), dtype=np.int64)
        vals = np.empty(max(keys_cap, 1), dtype=np.int32)
        keys_off = np.zeros(n_win + 1, dtype=np.int64)
        if status is None:
            status = np.zeros(max(n_win, 1), dtype=np.int32)
    with STATS.cpu_timer("host_post.native"):
        n = lib.host_post_batch(
            blob, lens if len(lens) else np.zeros(1, np.int64),
            offsets if len(offsets) else np.zeros(1, np.int64),
            win_frag_off, n_win,
            cons_blob, cons_off,
            k, solid_thresh, max_branches, zone, min_anchors, sup,
            out_c, out_s, out_cap, out_off,
            keys, vals, max(keys_cap, 1), keys_off,
            status,
        )
    if n < 0:
        return None
    with STATS.cpu_timer("host_post.marshal", 0):
        res = []
        for w in range(n_win):
            o0, o1 = out_off[w], out_off[w + 1]
            k0, k1 = keys_off[w], keys_off[w + 1]
            res.append(
                (
                    out_c[o0:o1].copy(),
                    out_s[o0:o1].astype(bool),
                    SparseCounts(keys[k0:k1].copy(), vals[k0:k1].copy()),
                )
            )
    return res


def assemble_windows_native(col_base, col_del, ins_len, ins_pack,
                            pre_len, pre_pack, suf_len, suf_pack,
                            w_lens):
    """Batch consensus assembly (assemble_consensus_batch fast path);
    returns a list of uint8 arrays, or None when its output capacity
    check fails."""
    lib = get_lib()
    cb = np.ascontiguousarray(col_base, dtype=np.int8)
    B, W = cb.shape
    cd = np.ascontiguousarray(col_del, dtype=np.int8)
    il = np.ascontiguousarray(ins_len, dtype=np.uint8)
    ip = np.ascontiguousarray(ins_pack, dtype=np.int32)
    wl = np.ascontiguousarray(w_lens, dtype=np.int32)
    pl = np.ascontiguousarray(pre_len, dtype=np.int32)
    pp = np.ascontiguousarray(pre_pack, dtype=np.int32)
    sl = np.ascontiguousarray(suf_len, dtype=np.int32)
    sp = np.ascontiguousarray(suf_pack, dtype=np.int32)
    cap = int((np.minimum(wl, W) * 17).sum() + 32 * B + 64)
    out = np.empty(cap, dtype=np.uint8)
    offs = np.empty(B + 1, dtype=np.int64)
    n = lib.assemble_windows(cb, cd, il, ip, pl, pp, sl, sp, wl,
                             B, W, out, cap, offs)
    if n < 0:
        return None
    return [out[offs[b] : offs[b + 1]] for b in range(B)]


_EMPTY_I64 = np.zeros(1, dtype=np.int64)
_EMPTY_I32 = np.zeros(1, dtype=np.int32)
_EMPTY_U8 = np.zeros(1, dtype=np.uint8)


def stitch_apply_native(out_c, out_s, cons_c, cons_s, raw_cons_len,
                        span, al_pos, i_window, old_end,
                        old_c, old_s, old_keys, old_vals,
                        cur_keys, cur_vals, k, solid_thresh,
                        scoring, track_old):
    """One StitchJob.apply step in native code; returns
    (new_out_c, new_out_s, spliced_c, spliced_s, new_old_end, tracked)
    or None when a capacity check fails.  out_s/cons_s/old_s are
    uint8 0/1 arrays; outputs keep that convention (the caller views
    them as bool)."""
    lib = get_lib()
    cur_len = len(out_c)
    q_begin, q_end, r_begin, r_end = span
    cons_piece = q_end - q_begin + 1
    out_cap = cur_len + cons_piece + 16
    new_out_c = np.empty(out_cap, dtype=np.uint8)
    new_out_s = np.empty(out_cap, dtype=np.uint8)
    cur_cap = cons_piece + max(0, old_end - (r_begin + al_pos) + 1) + 16
    new_cur_c = np.empty(cur_cap, dtype=np.uint8)
    new_cur_s = np.empty(cur_cap, dtype=np.uint8)
    meta = np.zeros(8, dtype=np.int64)
    has_old = old_c is not None
    lib.stitch_apply_step(
        out_c, out_s, cur_len,
        cons_c, cons_s, len(cons_c), raw_cons_len,
        q_begin, q_end, r_begin, r_end,
        al_pos, i_window, old_end,
        old_c if has_old else _EMPTY_U8,
        old_s if has_old else _EMPTY_U8,
        len(old_c) if has_old else 0,
        1 if has_old else 0,
        old_keys if old_keys is not None else _EMPTY_I64,
        old_vals if old_vals is not None else _EMPTY_I32,
        len(old_keys) if old_keys is not None else 0,
        cur_keys, cur_vals, len(cur_keys),
        k, solid_thresh,
        scoring["match"], scoring["mismatch"],
        scoring["gap_open"], scoring["gap_extend"],
        1 if track_old else 0,
        new_out_c, new_out_s, out_cap,
        new_cur_c, new_cur_s, cur_cap,
        meta,
    )
    if meta[0] < 0:
        return None
    modified = bool(meta[4])
    spliced = int(meta[1])
    return (
        new_out_c[: meta[0]] if modified else None,
        new_out_s[: meta[0]] if modified else None,
        new_cur_c[:spliced] if meta[3] else None,
        new_cur_s[:spliced] if meta[3] else None,
        int(meta[2]),
        bool(meta[3]),
        spliced,
    )


def local_align_native(q, r, match=2, mismatch=-2, gap_open=3, gap_extend=1):
    """Native affine local alignment; returns an object with npalign's
    fields (opt/q_begin/q_end/r_begin/r_end/n_ins/n_del)."""
    lib = get_lib()
    q = np.ascontiguousarray(q, dtype=np.uint8)
    r = np.ascontiguousarray(r, dtype=np.uint8)
    out = np.zeros(7, dtype=np.int64)
    lib.local_align_span(q, len(q), r, len(r),
                         match, mismatch, gap_open, gap_extend, out)

    class _Res:
        pass

    res = _Res()
    (res.opt, res.q_begin, res.q_end, res.r_begin, res.r_end,
     res.n_ins, res.n_del) = (int(x) for x in out)
    return res


def posterior_spans_native(q_rows, q_off, q_len, r_rows, r_off, r_len,
                           match, mismatch, gap_open, gap_extend):
    """Batched posterior-span local alignment (the device stitch
    aligner's exact span contract: union bounding box of matched cells
    over all optimal local alignments).  Pair i is query q_rows[q_off[i]
    : q_off[i] + q_len[i]] against ref r_rows[r_off[i] : ...] (uint8
    codes; int64 offsets and lengths).  Returns an [n, 5] int32 array
    (qb, qe, rb, re, valid)."""
    n = len(q_len)
    out = np.empty((n, 5), np.int32)
    get_lib().posterior_spans_batch(
        q_rows, q_off, q_len, r_rows, r_off, r_len, n,
        match, mismatch, gap_open, gap_extend, out.reshape(-1),
    )
    return out


def spans_wire_pack(q_rows, q_off, q_len, r_rows, r_off, r_len, Lq, Lr,
                    lanes):
    """The stitch aligner's wire rows of pairs laid out as for
    posterior_spans_native: [lanes, Lq / 4 + Lr / 4 + 8] uint8, each
    lane's query and ref 2-bit packed (pack_bases_host) and padded to Lq
    and Lr, then their int32 lengths; the lanes past the pairs zero."""
    wire = np.empty((lanes, Lq // 4 + Lr // 4 + 8), np.uint8)
    get_lib().spans_wire_pack(q_rows, q_off, q_len, r_rows, r_off, r_len,
                              len(q_len), lanes, Lq, Lr, wire)
    return wire
