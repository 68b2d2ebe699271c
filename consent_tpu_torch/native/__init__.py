"""ctypes bindings for the native host library (host.cpp).

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

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host.cpp")
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
            "consent_host", [_SRC],
            [base + ["-O3", "-march=native"], base + ["-O3"]],
        )
        lib = ctypes.CDLL(path)

        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

        lib.encode_seq.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p]
        lib.revcomp.argtypes = [u8p, ctypes.c_int64, u8p]
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
        _lib = lib
        return _lib


def host_post_window_native(frag_list, cons, k, solid_thresh,
                            max_branches, zone, min_anchors,
                            bmean_sup):
    """Whole per-window host post chain in ONE native call (counts,
    anchor gate, solidity, DBG polish); returns (codes, solid,
    SparseCounts), or None when an output capacity check fails."""
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
                           min_anchors):
    """Whole host post chain for MANY windows in ONE native call
    (host.cpp host_post_batch); returns a list of (codes, solid,
    SparseCounts), or None when an output capacity check fails.  Per-window
    results are byte-identical to host_post_window_native."""
    lib = get_lib()
    from consent_tpu_torch.core.sparse_counts import SparseCounts

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
    status = np.zeros(max(n_win, 1), dtype=np.int32)

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


def posterior_spans_native(qs, rs, match, mismatch, gap_open,
                           gap_extend):
    """Batched posterior-span local alignment (the device stitch
    aligner's exact span contract: union bounding box of matched cells
    over all optimal local alignments).  qs/rs: lists of uint8 code
    arrays.  Returns an [n, 5] int32 array (qb, qe, rb, re, valid)."""
    lib = get_lib()
    n = len(qs)
    q_len = np.fromiter((len(q) for q in qs), np.int64, n)
    r_len = np.fromiter((len(r) for r in rs), np.int64, n)
    q_off = np.zeros(n, np.int64)
    np.cumsum(q_len[:-1], out=q_off[1:] if n > 1 else q_off[:0])
    r_off = np.zeros(n, np.int64)
    np.cumsum(r_len[:-1], out=r_off[1:] if n > 1 else r_off[:0])
    qbuf = (np.concatenate(qs).astype(np.uint8, copy=False)
            if n else np.empty(0, np.uint8))
    rbuf = (np.concatenate(rs).astype(np.uint8, copy=False)
            if n else np.empty(0, np.uint8))
    qbuf = np.ascontiguousarray(qbuf)
    rbuf = np.ascontiguousarray(rbuf)
    out = np.empty((n, 5), np.int32)
    lib.posterior_spans_batch(
        qbuf, q_off, q_len, rbuf, r_off, r_len, n,
        match, mismatch, gap_open, gap_extend, out.reshape(-1),
    )
    return out
