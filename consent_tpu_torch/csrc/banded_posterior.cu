// Banded posterior alignment on Hopper (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel consent_tpu/ops/pallas_align.py:
// _kernel_banded (wrapper pallas_banded_posterior_summary).  Same
// contract as the plain PyTorch version,
// consent_tpu_torch/ops/align.py:posterior_summary with sc.band > 0,
// bit for bit in all six outputs for bases coded 0-3 (io/seqs.py: every
// caller's alphabet; ins_pack packs each base in 2 bits).
//
// What it computes, per lane (one (fragment, template) pair): a banded
// affine-gap local alignment.  Row i of the DP holds BW slots; slot b is
// kernel column chat = i + b - BW/2, i.e. true template column
// chat + d0.  Forward: H/F per slot, the match-entering score hm staged
// as int16, opt = max hm.  Backward: the continuation scores, and every
// cell with hm + bh_diag == opt lies on an optimal path and is folded
// into per-column first and last matched rows; matched, the aligned base
// and the next 16 query bases (2 bits each) follow from the last row
// when the outputs are written.  Horizontal gaps are scored over a
// window of `window` columns (16 on the main path), exactly when the
// window spans the band.
//
// What bounds it on this card: integer instructions on the ALU pipe.
// Counted as the card issues them, with Hopper's DPX instructions (one
// VIADDMNMX for max(a + b, c), one VIMNMX3 for a 3-way max, either with
// a max with 0), a band cell needs 16 ALU instructions over both passes
// (chip_smoke.py: alu_per_cell); the adds can issue as IMAD on the FMA
// pipe.  probes/int_rate.py measured VIADDMNMX and VIMNMX3 at 64 per
// clock per SM on the H100: 16.7 T/s over 132 SMs at 1.98 GHz.  Only
// rows below a lane's query length hold cells.  On the main path's data
// (N = 4,096 lanes, query lengths uniform in [256, 512], band 128) that
// is ~203 M cells, 3.2 G instructions, 0.194 ms.  The int16 hm staging
// moves 2 B per cell each way, 0.81 GB, 0.24 ms at 3.35 TB/s; it is not
// part of the function's inputs or outputs, so not of its bound, and it
// overlaps the arithmetic.
//
// Design: one warp per lane, LANES_PER_BLOCK warps per block, no block
// barrier.  Each thread owns SPT = BW/32 consecutive slots (a template
// parameter: bands of 32, 64 and every multiple of 128 up to 1,024, so
// SPT is 1, 2 or a multiple of 4; nothing in the shift and scan code
// asks for a power of two), and H, F and the backward
// states live in registers.  In band coordinates the diagonal
// predecessor is the same slot of the previous row: no exchange.  The
// vertical predecessor is slot b+1 (b-1 backward): in-thread for all but
// one slot, one shuffle for that one.  The windowed horizontal max is a
// log-step doubling whose values decay by the gap extension as they
// travel (max(x, shifted - D*extend), one VIADDMNMX per slot and step,
// the band-edge mask folded into the added constant): shifts below SPT
// are register moves, the rest warp shuffles.  When the window spans
// the band the gap is exact and the doubling becomes a warp-wide
// inclusive max scan (in-thread, then 5 shuffles).  Rows stop
// at the lane's query length: the rows past it change no state and hold
// no match (their hm is below NEG/2), so the forward pass runs rows
// [0, q_len) and the backward pass starts at q_len - 1 from (0, NEG).
// Rows whose whole band lies inside the template skip the per-slot range
// test (one warp-uniform branch per row).  hm is staged in a global
// scratch the wrapper allocates ([N, Lq, BW] int16; only rows below the
// lane's query length are written and read), one coalesced 2*SPT-byte
// store and load per thread and row (16-byte accesses when SPT is a
// multiple of 8, 8-byte ones otherwise), loaded two rows ahead in the
// backward pass; recomputing hm from (H, F) checkpoints in shared
// memory instead (probes/banded_recompute.cu) ran at half the speed on
// the H100, as its extra shared memory leaves a quarter of the warps
// resident.  The per-column accumulators (first and last matched
// row, int32, 8 B per column) sit in shared memory beside the query,
// the query packed 2 bits per base and the template in kernel-column
// coordinates: 6.4 KB per lane at the main path's shapes, so 32 warps
// (8 blocks) fit on an SM at 64 registers a thread.  A column is folded
// at most once per row, by shared-memory atomics (min for the first
// row, max for the last) that only on-path cells issue, behind one
// branch per row.

#include <cstdint>
#include <cuda_runtime.h>

#include "posterior_tiled.cuh"

namespace {

constexpr int NEG = -(1 << 14);
constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES_PER_BLOCK = 4;
constexpr int SMEM_PER_BLOCK_MAX = 227 * 1024;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Shared memory of one lane: i_first, i_last [W] int32; the template by
// kernel column (chat + BW/2) [Lq + BW] uint8; the query [Lq] uint8; the
// query packed 16 bases per word [Lq/16 + 2] uint32.
__host__ __device__ constexpr int packed_words(int Lq) { return (Lq >> 4) + 2; }

__host__ __device__ constexpr int lane_smem_bytes(int Lq, int W, int BW) {
    return align16(8 * W) + align16(Lq + BW) + align16(Lq) +
           align16(4 * packed_words(Lq));
}

// Where the value at distance D from slot j of a thread lives (slot
// b - D for FROM_LOWER, b + D otherwise, b = lane * SPT + j): toff
// threads away (0: the same thread), in slot sj there.  Every index is
// a constant once the loops over j are unrolled.
__host__ __device__ constexpr int src_toff(int spt, int j, int d,
                                           bool lower) {
    return (lower ? j - d >= 0 : j + d < spt)
               ? 0
               : (lower ? (spt - 1 - (j - d)) / spt : (j + d) / spt);
}

__host__ __device__ constexpr int src_slot(int spt, int j, int d,
                                           bool lower) {
    return lower ? j - d + src_toff(spt, j, d, lower) * spt
                 : j + d - src_toff(spt, j, d, lower) * spt;
}

// Whether the thread toff lanes away, in the shift's direction, exists.
__device__ __forceinline__ bool has_src(int lane, int toff, bool lower) {
    return toff == 0 || (lower ? lane >= toff : lane + toff < 32);
}

// The value at distance D from slot j: a register move in-thread, one
// shuffle otherwise.  Unmasked: where the source lies past the band's
// edge this is some value of the lane's own.
template <int SPT, int D, bool FROM_LOWER>
__device__ __forceinline__ int fetch(const int (&v)[SPT], int j) {
    const int toff = src_toff(SPT, j, D, FROM_LOWER);
    const int sj = src_slot(SPT, j, D, FROM_LOWER);
    if (toff == 0) return v[sj];
    return FROM_LOWER ? __shfl_up_sync(FULL, v[sj], toff)
                      : __shfl_down_sync(FULL, v[sj], toff);
}

// out[j] = the value at distance D from slot j, NEG past the band's edge.
template <int SPT, int D, bool FROM_LOWER>
__device__ __forceinline__ void shift(const int (&v)[SPT], int (&out)[SPT],
                                      int lane) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
        const int x = fetch<SPT, D, FROM_LOWER>(v, j);
        out[j] = has_src(lane, src_toff(SPT, j, D, FROM_LOWER), FROM_LOWER)
                     ? x
                     : NEG;
    }
}

// One doubling step per power of two D below the window (D < BW/2, so a
// source is at most 16 threads away): inc covers the 2D slots up to b
// (FROM_LOWER) or from b, each decayed by extend per slot of distance.
// One DPX max(x + c, inc) per slot: c is the decay, or, past the band's
// edge, the decay plus 2 * NEG, which leaves a value below -2^14 that
// can never be the winning (positive) gap term.
template <int SPT, bool FROM_LOWER, int D = 1>
__device__ __forceinline__ void widen(int (&inc)[SPT], int window, int ext,
                                      int lane) {
    if constexpr (D < 16 * SPT) {
        if (D < window) {
            int sh[SPT];
#pragma unroll
            for (int j = 0; j < SPT; ++j)
                sh[j] = fetch<SPT, D, FROM_LOWER>(inc, j);
            const int decay = -D * ext;
            const int dead = decay + 2 * NEG;
#pragma unroll
            for (int j = 0; j < SPT; ++j)
                inc[j] = __viaddmax_s32(
                    sh[j],
                    has_src(lane, src_toff(SPT, j, D, FROM_LOWER), FROM_LOWER)
                        ? decay
                        : dead,
                    inc[j]);
            widen<SPT, FROM_LOWER, 2 * D>(inc, window, ext, lane);
        }
    }
}

// The horizontal-gap term of each slot: the best score of a gap that
// ends at (starts from) the slot, over the `window` slots before (after)
// it: max over k of x[k] - gap_open - (|b - k| - 1) * extend.  When the
// window spans the band this is an exact prefix (suffix) max: a scan.
template <int SPT, bool FROM_LOWER>
__device__ __forceinline__ void gap_term(const int (&x)[SPT], int (&e)[SPT],
                                         int window, int ext, int go,
                                         int lane) {
    int inc[SPT];
    if (window >= 32 * SPT) {
        // in-thread inclusive scan, from the thread's first slot in the
        // scan's direction
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            const int j = FROM_LOWER ? k : SPT - 1 - k;
            inc[j] = k == 0 ? x[j]
                            : max(inc[FROM_LOWER ? j - 1 : j + 1] - ext, x[j]);
        }
        int tot = FROM_LOWER ? inc[SPT - 1] : inc[0];
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
            const int y = FROM_LOWER ? __shfl_up_sync(FULL, tot, d)
                                     : __shfl_down_sync(FULL, tot, d);
            const int decay = -d * SPT * ext;
            tot = __viaddmax_s32(
                y, has_src(lane, d, FROM_LOWER) ? decay : decay + 2 * NEG,
                tot);
        }
        int ex = FROM_LOWER ? __shfl_up_sync(FULL, tot, 1)
                            : __shfl_down_sync(FULL, tot, 1);
        if (FROM_LOWER ? lane == 0 : lane == 31) ex = NEG;
        // ex is the scan at the slot just before the thread's first
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
            const int k = FROM_LOWER ? j : SPT - 1 - j;
            const int prev = k == 0 ? NEG : inc[FROM_LOWER ? j - 1 : j + 1];
            e[j] = max(ex - k * ext, prev) - go;
        }
        return;
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) inc[j] = x[j];
    widen<SPT, FROM_LOWER>(inc, window, ext, lane);
    shift<SPT, 1, FROM_LOWER>(inc, e, lane);
#pragma unroll
    for (int j = 0; j < SPT; ++j) e[j] -= go;
}

// Substitution scores of one row's SPT slots: t points at the template
// byte of the thread's first slot; c0 is that slot's kernel column minus
// jlo, and a slot is inside the template when c0 + j < span.
template <int SPT, bool EDGE>
__device__ __forceinline__ void row_sub(int (&sub)[SPT], const uint8_t* t,
                                        int qb, int c0, unsigned span,
                                        int match, int mismatch) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
        int s = t[j] == qb ? match : mismatch;
        if (EDGE && static_cast<unsigned>(c0 + j) >= span) s = NEG;
        sub[j] = s;
    }
}

// hm staging: SPT int16 per thread and row, in vector accesses.
template <int SPT>
struct HmRow {
    uint32_t w[SPT == 1 ? 1 : SPT / 2];
};

template <int SPT>
__device__ __forceinline__ void store_hm(int16_t* p, const int (&hm)[SPT]) {
    if constexpr (SPT == 1) {
        *p = static_cast<int16_t>(hm[0]);
    } else {
        uint32_t w[SPT / 2];
#pragma unroll
        for (int k = 0; k < SPT / 2; ++k)
            w[k] = __byte_perm(hm[2 * k], hm[2 * k + 1], 0x5410);
        if constexpr (SPT == 2) {
            *reinterpret_cast<uint32_t*>(p) = w[0];
        } else if constexpr (SPT % 8 == 0) {
#pragma unroll
            for (int k = 0; k < SPT / 8; ++k)
                reinterpret_cast<uint4*>(p)[k] = make_uint4(
                    w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
        } else {
            // 4, 12, 20, 28 slots: the thread's 2*SPT bytes start on an
            // 8-byte boundary only
#pragma unroll
            for (int k = 0; k < SPT / 4; ++k)
                reinterpret_cast<uint2*>(p)[k] =
                    make_uint2(w[2 * k], w[2 * k + 1]);
        }
    }
}

template <int SPT>
__device__ __forceinline__ HmRow<SPT> load_hm(const int16_t* p) {
    HmRow<SPT> r;
    if constexpr (SPT == 1) {
        r.w[0] = static_cast<uint32_t>(*p);
    } else if constexpr (SPT == 2) {
        r.w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (SPT % 8 == 0) {
#pragma unroll
        for (int k = 0; k < SPT / 8; ++k) {
            const uint4 v = reinterpret_cast<const uint4*>(p)[k];
            r.w[4 * k] = v.x;
            r.w[4 * k + 1] = v.y;
            r.w[4 * k + 2] = v.z;
            r.w[4 * k + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < SPT / 4; ++k) {
            const uint2 v = reinterpret_cast<const uint2*>(p)[k];
            r.w[2 * k] = v.x;
            r.w[2 * k + 1] = v.y;
        }
    }
    return r;
}

template <int SPT>
__device__ __forceinline__ int hm_at(const HmRow<SPT>& r, int j) {
    const uint32_t w = r.w[SPT == 1 ? 0 : j >> 1];
    return (j & 1) ? static_cast<int>(w) >> 16
                   : static_cast<int>(static_cast<int16_t>(w & 0xffffu));
}

// The kernel's arguments.
struct Args {
    const uint8_t* q;        // [N, Lq]
    const int32_t* q_len;    // [N]
    const uint8_t* r;        // [N, W]
    const int32_t* r_len;    // [N]
    const int32_t* d0;       // [N]
    int N, Lq, W, match, mismatch, gap_open, gap_extend, window;
    int32_t* opt;            // [N]
    uint8_t* matched;        // [N, W] outputs
    int32_t* i_first;
    int32_t* i_last;
    int32_t* base;
    int32_t* ins_pack;
    int16_t* hm_stage;       // [N, Lq, BW] scratch
};

// One lane as its warp sees it: the lane's shared memory, its geometry
// and the scoring.
struct Lane {
    int* acc_if;             // [W] first matched row per kernel column
    int* acc_il;             // [W] last matched row
    const uint8_t* tk;       // [Lq + BW] template by kernel column + BW/2
    const uint8_t* qs;       // [Lq] query
    const uint32_t* qpk;     // query packed 16 bases per word
    int lane, b0, Lq, W, qmax, d0;
    // rows i with i - fast_lo < fast_n (unsigned) lie wholly inside the
    // template; elsewhere a slot is inside when its kernel column minus
    // jlo (= i + c0_row + j) is below span
    int fast_lo, c0_row;
    unsigned fast_n, span;
    int match, mismatch, go, ge, window;
};

// Loads the lane's query and template into its shared memory and
// clears its accumulators.
template <int SPT>
__device__ __forceinline__ Lane lane_setup(const Args& a, int n, int lane,
                                           unsigned char* mem) {
    constexpr int BW = 32 * SPT;
    constexpr int OFF = BW / 2;
    const int Lq = a.Lq, W = a.W;
    Lane L;
    L.acc_if = reinterpret_cast<int*>(mem);
    L.acc_il = L.acc_if + W;
    uint8_t* tk = mem + align16(8 * W);
    uint8_t* qs = tk + align16(Lq + BW);
    uint32_t* qpk = reinterpret_cast<uint32_t*>(qs + align16(Lq));
    L.tk = tk;
    L.qs = qs;
    L.qpk = qpk;
    L.lane = lane;
    L.b0 = lane * SPT;
    L.Lq = Lq;
    L.W = W;
    const uint8_t* qn = a.q + static_cast<size_t>(n) * Lq;
    const uint8_t* rn = a.r + static_cast<size_t>(n) * W;
    const int qlen = a.q_len[n];
    L.qmax = max(min(qlen, Lq), 0);
    L.d0 = a.d0[n];
    // valid kernel columns: [clip(-d0, 0, W), clip(r_len - d0, 0, W))
    const int jlo = min(max(-L.d0, 0), W);
    const int jhi = min(max(min(a.r_len[n], W) - L.d0, 0), W);
    L.span = static_cast<unsigned>(max(jhi - jlo, 0));
    L.fast_lo = jlo + OFF;
    L.fast_n = static_cast<unsigned>(max(jhi - jlo - BW + 1, 0));
    L.c0_row = L.b0 - OFF - jlo;
    L.match = a.match;
    L.mismatch = a.mismatch;
    L.go = a.gap_open;
    L.ge = a.gap_extend;
    L.window = a.window;

    for (int k = lane; k < W; k += 32) {
        L.acc_if[k] = Lq;
        L.acc_il[k] = -1;
    }
    for (int k = lane; k < Lq; k += 32) qs[k] = qn[k];
    for (int k = lane; k < L.qmax + BW; k += 32) {
        const int c = k - OFF;
        tk[k] = (c >= jlo && c < jhi) ? rn[c + L.d0] : 0;
    }
    __syncwarp();
    // packed query: position p holds q[p] below qmax, q[Lq - 1] in
    // [Lq, q_len) (the plain version's clamped gather), else 0
    for (int k = lane; k < packed_words(Lq); k += 32) {
        uint32_t w = 0;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
            const int p = 16 * k + t;
            const int v = p < L.qmax ? qs[p] : (p < qlen ? qs[Lq - 1] : 0);
            w |= static_cast<uint32_t>(v & 3) << (2 * t);
        }
        qpk[k] = w;
    }
    __syncwarp();
    return L;
}

template <int SPT>
__device__ __forceinline__ void row_scores(const Lane& L, int i,
                                           int (&sub)[SPT]) {
    const uint8_t* t = L.tk + i + L.b0;
    const int qb = L.qs[i];
    if (static_cast<unsigned>(i - L.fast_lo) < L.fast_n)
        row_sub<SPT, false>(sub, t, qb, 0, 0, L.match, L.mismatch);
    else
        row_sub<SPT, true>(sub, t, qb, i + L.c0_row, L.span, L.match,
                           L.mismatch);
}

// Forward row i: (h, f) of row i-1 become those of row i; hm is the
// row's match-entering score.
template <int SPT>
__device__ __forceinline__ void forward_row(const Lane& L, int i,
                                            int (&h)[SPT], int (&f)[SPT],
                                            int (&hm)[SPT]) {
    int sub[SPT], fv[SPT], fn[SPT], ht[SPT], e[SPT];
    row_scores<SPT>(L, i, sub);
#pragma unroll
    for (int j = 0; j < SPT; ++j) fv[j] = max(h[j] - L.go, f[j] - L.ge);
    shift<SPT, 1, false>(fv, fn, L.lane);            // from slot b+1
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
        hm[j] = h[j] + sub[j];                       // diagonal = same slot
        ht[j] = max(max(hm[j], fn[j]), 0);
    }
    gap_term<SPT, true>(ht, e, L.window, L.ge, L.go, L.lane);
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
        h[j] = max(ht[j], e[j]);
        f[j] = fn[j];
    }
}

// Backward row i: (bh, bf) of row i+1 become those of row i, and every
// cell of the row with hm + bh_diag == optc is folded into the
// accumulators (bh_diag, the continuation from (i+1, chat+1), is the
// same slot's bh of row i+1).
template <int SPT>
__device__ __forceinline__ void backward_row(const Lane& L, int i,
                                             int (&bh)[SPT], int (&bf)[SPT],
                                             const int (&hm)[SPT], int optc) {
    constexpr int OFF = 16 * SPT;
    int sub[SPT], fv[SPT], bfn[SPT], bt[SPT], be[SPT];
    row_scores<SPT>(L, i, sub);
#pragma unroll
    for (int j = 0; j < SPT; ++j) fv[j] = max(bh[j] - L.go, bf[j] - L.ge);
    shift<SPT, 1, true>(fv, bfn, L.lane);            // from slot b-1
#pragma unroll
    for (int j = 0; j < SPT; ++j)
        bt[j] = max(max(sub[j] + bh[j], bfn[j]), 0);
    gap_term<SPT, false>(bt, be, L.window, L.ge, L.go, L.lane);
    // on-path cells are rare: one branch per row
    bool any = false;
#pragma unroll
    for (int j = 0; j < SPT; ++j) any |= hm[j] + bh[j] == optc;
    if (any) {
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
            const int c = i + L.b0 + j - OFF;
            if (hm[j] + bh[j] == optc && hm[j] > NEG / 2 && c >= 0 &&
                c < L.W) {
                atomicMin(&L.acc_if[c], i);
                atomicMax(&L.acc_il[c], i);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
        bh[j] = max(bt[j], be[j]);
        bf[j] = bfn[j];
    }
}

// kernel column -> true column j = chat + d0; columns with no kernel
// column get the unmatched fills.  matched, the base and the packed
// insertion follow from the last matched row.
__device__ __forceinline__ void write_outputs(const Lane& L, const Args& a,
                                              int n) {
    __syncwarp();
    for (int j = L.lane; j < L.W; j += 32) {
        const size_t o = static_cast<size_t>(n) * L.W + j;
        const int c = j - L.d0;
        int fi = L.Lq, la = -1, bs = 0, ins = 0;
        if (c >= 0 && c < L.W) {
            fi = L.acc_if[c];
            la = L.acc_il[c];
            if (la >= 0) {
                bs = L.qs[la];
                const int p = la + 1;             // the next 16 bases
                const uint64_t w =
                    (static_cast<uint64_t>(L.qpk[(p >> 4) + 1]) << 32) |
                    L.qpk[p >> 4];
                ins = static_cast<int>(
                    static_cast<uint32_t>(w >> (2 * (p & 15))));
            }
        }
        a.matched[o] = la >= 0;
        a.i_first[o] = fi;
        a.i_last[o] = la;
        a.base[o] = bs;
        a.ins_pack[o] = ins;
    }
}

// Registers a thread may use: 64 at up to 4 slots (8 blocks of 4 warps,
// 32 warps per SM), more for wider bands.
template <int SPT>
constexpr int min_blocks() {
    return SPT <= 4 ? 8 : (SPT == 8 ? 4 : 1);
}

template <int SPT>
__global__ void __launch_bounds__(LANES_PER_BLOCK * 32, min_blocks<SPT>())
banded_posterior_kernel(const Args a) {
    constexpr int BW = 32 * SPT;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n = blockIdx.x * (blockDim.x >> 5) + warp;
    if (n >= a.N) return;  // whole warps only: no block-wide barrier follows
    extern __shared__ __align__(16) unsigned char smem[];
    const Lane L = lane_setup<SPT>(
        a, n, lane, smem + warp * lane_smem_bytes(a.Lq, a.W, BW));
    int16_t* hm_n = a.hm_stage + static_cast<size_t>(n) * a.Lq * BW + L.b0;

    // ---------------- forward ----------------
    int h[SPT], f[SPT], hm[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
        h[j] = 0;
        f[j] = NEG;
    }
    int optv = 0;
    int16_t* hp = hm_n;
    for (int i = 0; i < L.qmax; ++i, hp += BW) {
        forward_row<SPT>(L, i, h, f, hm);
#pragma unroll
        for (int j = 0; j < SPT; ++j) optv = max(optv, hm[j]);
        store_hm<SPT>(hp, hm);
    }
    const int opt = __reduce_max_sync(FULL, optv);
    if (lane == 0) a.opt[n] = opt;
    // no cell can equal this when nothing scored
    const int optc = opt > 0 ? opt : INT32_MIN;

    // ---------------- backward + posterior fold ----------------
    int bh[SPT], bf[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
        bh[j] = 0;
        bf[j] = NEG;
    }
    // hm rows are loaded two rows ahead of their use
    HmRow<SPT> cur{}, nxt{};
    if (L.qmax > 0)
        cur = load_hm<SPT>(hm_n + static_cast<size_t>(L.qmax - 1) * BW);
    if (L.qmax > 1)
        nxt = load_hm<SPT>(hm_n + static_cast<size_t>(L.qmax - 2) * BW);
    for (int i = L.qmax - 1; i >= 0; --i) {
        HmRow<SPT> ahead{};
        if (i >= 2)
            ahead = load_hm<SPT>(hm_n + static_cast<size_t>(i - 2) * BW);
#pragma unroll
        for (int j = 0; j < SPT; ++j) hm[j] = hm_at<SPT>(cur, j);
        backward_row<SPT>(L, i, bh, bf, hm, optc);
        cur = nxt;
        nxt = ahead;
    }
    write_outputs(L, a, n);
}

// Launches `kernel` over N lanes, up to LANES_PER_BLOCK warps a block,
// each with `per_lane` bytes of shared memory.
inline int launch_lanes(void (*kernel)(Args), const Args& a, int per_lane,
                        cudaStream_t stream) {
    const int lanes = min(LANES_PER_BLOCK, SMEM_PER_BLOCK_MAX / per_lane);
    if (lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = lanes * per_lane;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<(a.N + lanes - 1) / lanes, lanes * 32, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// BW must be 32, 64 or a multiple of 128 up to 1,024 (one instantiation
// per slots-per-thread: 1, 2, 4, 8, ..., 32); any other band, or a lane
// whose shared memory does not fit a block, returns
// cudaErrorInvalidValue without launching.  Wider bands go to
// banded_posterior_tiled_launch (ops/cuda_align.py: banded_variant).
extern "C" int banded_posterior_launch(
    const void* q, const void* q_len, const void* r, const void* r_len,
    const void* d0, int N, int Lq, int W, int BW, int match, int mismatch,
    int gap_open, int gap_extend, int window, void* opt, void* matched,
    void* i_first, void* i_last, void* base, void* ins_pack, void* hm_stage,
    void* stream) {
    const Args a{static_cast<const uint8_t*>(q),
                 static_cast<const int32_t*>(q_len),
                 static_cast<const uint8_t*>(r),
                 static_cast<const int32_t*>(r_len),
                 static_cast<const int32_t*>(d0),
                 N, Lq, W, match, mismatch, gap_open, gap_extend, window,
                 static_cast<int32_t*>(opt), static_cast<uint8_t*>(matched),
                 static_cast<int32_t*>(i_first), static_cast<int32_t*>(i_last),
                 static_cast<int32_t*>(base), static_cast<int32_t*>(ins_pack),
                 static_cast<int16_t*>(hm_stage)};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int per_lane = lane_smem_bytes(Lq, W, BW);
    switch (BW) {
        case 32: return launch_lanes(banded_posterior_kernel<1>, a, per_lane, s);
        case 64: return launch_lanes(banded_posterior_kernel<2>, a, per_lane, s);
        case 128: return launch_lanes(banded_posterior_kernel<4>, a, per_lane, s);
        case 256: return launch_lanes(banded_posterior_kernel<8>, a, per_lane, s);
        case 384: return launch_lanes(banded_posterior_kernel<12>, a, per_lane, s);
        case 512: return launch_lanes(banded_posterior_kernel<16>, a, per_lane, s);
        case 640: return launch_lanes(banded_posterior_kernel<20>, a, per_lane, s);
        case 768: return launch_lanes(banded_posterior_kernel<24>, a, per_lane, s);
        case 896: return launch_lanes(banded_posterior_kernel<28>, a, per_lane, s);
        case 1024: return launch_lanes(banded_posterior_kernel<32>, a, per_lane, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Bands above 1,024 (any multiple of 128 up to W): one block per lane,
// the DP rows in global scratch (posterior_tiled.cuh; hm_stage holds
// N x Lq x W int16, rows N x 4 x W int32).
extern "C" int banded_posterior_tiled_launch(
    const void* q, const void* q_len, const void* r, const void* r_len,
    const void* d0, int N, int Lq, int W, int BW, int match, int mismatch,
    int gap_open, int gap_extend, int window, int capped, void* opt,
    void* matched, void* i_first, void* i_last, void* base, void* ins_pack,
    void* hm_stage, void* rows, void* stream) {
    if (BW < 1) return static_cast<int>(cudaErrorInvalidValue);
    return tiled::launch_c(q, q_len, r, r_len, d0, N, Lq, W, BW, match,
                           mismatch, gap_open, gap_extend, window, capped,
                           opt, matched, i_first, i_last, base, ins_pack,
                           hm_stage, rows, stream);
}
