// Posterior alignment, one block per lane, the DP rows in global scratch
// (CUDA C++, sm_90a): the variant both kernels use for the shapes their
// register designs do not take.
//
//   * csrc/banded_posterior.cu: bands above 1,024 (the one-warp-per-lane
//     kernel keeps band / 32 slots a thread in registers, 32 at most).
//     The JAX package's pallas_banded_posterior_summary takes any
//     multiple of 128 up to the template width
//     (consent_tpu/ops/pallas_align.py:528-530).
//   * csrc/full_posterior.cu: templates wider than 16,384 columns (the
//     one-block-per-lane kernel keeps 16 columns a thread at most).
//
// Same contract as the plain PyTorch version,
// consent_tpu_torch/ops/align.py:posterior_summary, bit for bit in all
// six outputs for bases coded 0-3, and the same formulation: the DP runs
// over every template column j of a row in true-column coordinates, a
// band (band > 0) masking cells whose kernel column j - d0 lies outside
// [i - band/2, i + band/2), and the horizontal gap term is the plain
// version's max of Ht[k] + k * extend over the window before (after) j,
// less j * extend.  Every add and subtract is wrapped to int16 (w16)
// where the plain version's int16 tensors wrap, and the window's max
// takes the plain version's NEG padding where its doubling scan reaches
// past the row's first (last) column; so a lane thousands of columns
// wide, whose scores and j * extend offsets pass 2^15, wraps where the
// plain version wraps.
//
// What bounds it: nothing it is built for.  It exists so that every
// shape the JAX package accepts runs on the card; the main path never
// reaches it (the consensus band is 128, the stitch's templates are 640
// columns).  A row costs W cells whatever the band, one tile of the
// block's threads after another, each with the row's state read from
// and written to global memory and, for exact gaps, a block-wide max
// scan carried from tile to tile (two __syncthreads).
//
// Layout.  Block n is lane n; thread t owns column t of each tile of
// blockDim.x columns (tiles walk left to right forward, right to left
// backward, so a windowed gap reads the columns of the tile before from
// this row).  Per-lane scratch the wrapper allocates: hm [Lq, W] int16
// (rows below the lane's query length), and four int32 rows of W: H of
// the previous and of this row (the diagonal and vertical predecessors
// are read from the previous one), F, and the gap max's inputs.  The
// outputs double as the per-column accumulators of the backward pass:
// each column's thread alone reads and writes them.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace tiled {

constexpr int NEG = -(1 << 14);
constexpr int INS_PACK = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;

struct Args {
    const uint8_t* q;        // [N, Lq]
    const int32_t* q_len;    // [N]
    const uint8_t* r;        // [N, W]
    const int32_t* r_len;    // [N]
    const int32_t* d0;       // [N]; unread when band == 0
    int N, Lq, W, band, match, mismatch, gap_open, gap_extend;
    int window;              // columns the gap max covers (>= W: all)
    int capped;              // 1: the plain version's doubling scan
    int32_t* opt;            // [N]
    uint8_t* matched;        // [N, W] outputs
    int32_t* i_first;
    int32_t* i_last;
    int32_t* base;
    int32_t* ins_pack;
    int16_t* hm_stage;       // [N, Lq, W] scratch
    int32_t* rows;           // [N, 4, W] scratch
};

// x as the plain version's int16 arithmetic leaves it.
__device__ __forceinline__ int w16(int x) {
    return static_cast<int>(static_cast<int16_t>(x));
}

// The 16 query bases after row i, 2 bits each from the LSB, summed as
// the plain version sums them: positions at or past q_len add nothing,
// positions in [Lq, q_len) repeat q[Lq - 1] (its clamped gather).
__device__ __forceinline__ int pack_ins(const uint8_t* qn, int i, int qlen,
                                       int Lq) {
    uint32_t p = 0;
    for (int k = 0; k < INS_PACK; ++k) {
        const int idx = i + 1 + k;
        if (idx < qlen)
            p += static_cast<uint32_t>(qn[min(idx, Lq - 1)]) << (2 * k);
    }
    return static_cast<int>(p);
}

// Max of x over the threads before (REV: after) this one in the block,
// INT_MIN when there are none; total gets the block's max.  Holds two
// __syncthreads (wsum is [32] shared ints, free again on return).
template <bool REV>
__device__ __forceinline__ int block_scan(int x, int* wsum, int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    int v = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = REV ? __shfl_down_sync(FULL, v, d)
                          : __shfl_up_sync(FULL, v, d);
        if (REV ? lane + d < 32 : lane >= d) v = max(v, y);
    }
    int ex = REV ? __shfl_down_sync(FULL, v, 1) : __shfl_up_sync(FULL, v, 1);
    if (REV ? lane == 31 : lane == 0) ex = INT_MIN;
    if (REV ? lane == 0 : lane == 31) wsum[warp] = v;
    __syncthreads();
    const int ws = lane < nw ? wsum[lane] : INT_MIN;
    const int other = __reduce_max_sync(
        FULL, (REV ? lane > warp : lane < warp) ? ws : INT_MIN);
    total = __reduce_max_sync(FULL, ws);
    __syncthreads();
    return max(ex, other);
}

// The plain version's gap max at column j of this tile: the max of the
// row's x over the window before j (REV: after j), with NEG where its
// doubling scan pads past the row's edge; NEG at the row's first (REV:
// last) column.  carry holds the max over the earlier tiles when the
// window spans the row; otherwise the inputs go through xr.
template <bool REV>
__device__ __forceinline__ int gap_max(int x, int j, bool live, int W,
                                       int window, bool capped, int* xr,
                                       int& carry, int* wsum) {
    int v;
    if (window >= W) {
        int total;
        v = max(carry, block_scan<REV>(live ? x : INT_MIN, wsum, total));
        carry = max(carry, total);
        if (capped) v = max(v, NEG);
    } else {
        if (live) xr[j] = x;
        __syncthreads();
        v = INT_MIN;
        if (live) {
            const int lo = REV ? j + 1 : max(0, j - window);
            const int hi = REV ? min(W - 1, j + window) : j - 1;
            for (int k = lo; k <= hi; ++k) v = max(v, xr[k]);
            if (REV ? j + window > W - 1 : j - window < 0) v = max(v, NEG);
        }
    }
    return (REV ? j == W - 1 : j == 0) ? NEG : v;
}

__global__ void __launch_bounds__(MAX_THREADS)
posterior_tiled_kernel(const Args a) {
    __shared__ int wsum[32];
    const int T = blockDim.x, t = threadIdx.x;
    const int n = blockIdx.x;
    const int Lq = a.Lq, W = a.W, band = a.band, off = a.band / 2;
    const int go = a.gap_open, ge = a.gap_extend, oe = go - ge;
    const bool capped = a.capped != 0;
    const uint8_t* qn = a.q + static_cast<size_t>(n) * Lq;
    const uint8_t* rn = a.r + static_cast<size_t>(n) * W;
    const int qlen = a.q_len[n];
    const int qmax = max(min(qlen, Lq), 0);
    const int rlen = a.r_len[n];
    const int d0 = band ? a.d0[n] : 0;
    int* hp = a.rows + static_cast<size_t>(n) * 4 * W;  // previous row's H
    int* hc = hp + W;                                    // this row's H
    int* fr = hc + W;                                    // F
    int* xr = fr + W;                                    // gap max inputs
    int16_t* hm_n = a.hm_stage + static_cast<size_t>(n) * Lq * W;
    const size_t o = static_cast<size_t>(n) * W;
    for (int j = t; j < W; j += T) {
        hp[j] = 0;
        fr[j] = NEG;
        a.matched[o + j] = 0;
        a.i_first[o + j] = Lq;
        a.i_last[o + j] = -1;
        a.base[o + j] = 0;
        a.ins_pack[o + j] = 0;
    }
    __syncthreads();

    // cell (i, j): whether it has a slot of the banded DP (every cell at
    // full width), and its substitution score (NEG outside the template,
    // the band or the kernel's template window)
    auto cell = [&](int i, int j, int qi, bool& geom) {
        bool ok = j < rlen;
        geom = true;
        if (band) {
            const int chat = j - d0;
            const int rel = chat - i + off;
            geom = rel >= 0 && rel < band;
            ok = ok && geom && chat >= 0 && chat < W;
        }
        return ok ? (qi == rn[j] ? a.match : a.mismatch) : NEG;
    };

    // ---------------- forward: rows below q_len ----------------
    int optv = 0;
    for (int i = 0; i < qmax; ++i) {
        const int qi = qn[i];
        int carry = INT_MIN;
        for (int j0 = 0; j0 < W; j0 += T) {
            const int j = j0 + t;
            const bool live = j < W;
            const int jx = w16(j * ge);
            bool geom = false;
            int hm = 0, fn = NEG, ht = NEG, x = INT_MIN;
            if (live) {
                const int sub = cell(i, j, qi, geom);
                hm = w16((j > 0 ? hp[j - 1] : 0) + sub);
                fn = max(w16(hp[j] - go), w16(fr[j] - ge));
                ht = geom ? max(max(hm, fn), 0) : NEG;
                x = w16(ht + jx);
            }
            const int pe = gap_max<false>(x, j, live, W, a.window, capped,
                                          xr, carry, wsum);
            if (live) {
                const int e = w16(w16(pe - jx) - oe);
                hc[j] = geom ? max(ht, e) : NEG;
                fr[j] = geom ? fn : NEG;
                hm_n[static_cast<size_t>(i) * W + j] =
                    static_cast<int16_t>(hm);
                optv = max(optv, hm);
            }
        }
        int* sw = hp;
        hp = hc;
        hc = sw;
        __syncthreads();
    }
    int opt;
    block_scan<false>(optv, wsum, opt);
    if (t == 0) a.opt[n] = opt;

    // ------- backward + posterior fold: from the last row below q_len -------
    for (int j = t; j < W; j += T) {
        hp[j] = 0;
        fr[j] = NEG;
    }
    __syncthreads();
    const int last_tile = (W - 1) / T;
    for (int i = qmax - 1; i >= 0; --i) {
        const int qi = qn[i];
        int carry = INT_MIN;
        for (int tile = last_tile; tile >= 0; --tile) {
            const int j = tile * T + t;
            const bool live = j < W;
            const int jx = w16(j * ge);
            bool geom = false;
            int bhd = 0, bfn = NEG, bt = NEG, x = INT_MIN;
            if (live) {
                const int sub = cell(i, j, qi, geom);
                bhd = j + 1 < W ? hp[j + 1] : 0;           // BH[i+1][j+1]
                bfn = max(w16(hp[j] - go), w16(fr[j] - ge));
                bt = geom ? max(max(w16(sub + bhd), bfn), 0) : NEG;
                x = w16(bt - jx);
            }
            const int se = gap_max<true>(x, j, live, W, a.window, capped, xr,
                                         carry, wsum);
            if (live) {
                const int be = w16(w16(se + jx) - oe);
                hc[j] = geom ? max(bt, be) : NEG;
                fr[j] = geom ? bfn : NEG;
                const int hm = hm_n[static_cast<size_t>(i) * W + j];
                if (opt > 0 && hm > NEG / 2 && w16(hm + bhd) == opt) {
                    // descending rows: i_first converges to the minimum,
                    // i_last and the captured bases keep the first (=
                    // largest) row seen
                    if (!a.matched[o + j]) {
                        a.matched[o + j] = 1;
                        a.i_last[o + j] = i;
                        a.base[o + j] = qn[i];
                        a.ins_pack[o + j] = pack_ins(qn, i, qlen, Lq);
                    }
                    a.i_first[o + j] = i;
                }
            }
        }
        int* sw = hp;
        hp = hc;
        hc = sw;
        __syncthreads();
    }
}

// One block per lane, up to 1,024 threads (one per column of a tile).
inline int launch(const Args& a, cudaStream_t stream) {
    if (a.N < 1 || a.W < 1 || a.Lq < 0 || a.band < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = min(MAX_THREADS, (a.W + 31) / 32 * 32);
    posterior_tiled_kernel<<<a.N, threads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// The C entry point both libraries export under their kernel's name.
inline int launch_c(const void* q, const void* q_len, const void* r,
                    const void* r_len, const void* d0, int N, int Lq, int W,
                    int band, int match, int mismatch, int gap_open,
                    int gap_extend, int window, int capped, void* opt,
                    void* matched, void* i_first, void* i_last, void* base,
                    void* ins_pack, void* hm_stage, void* rows,
                    void* stream) {
    const Args a{static_cast<const uint8_t*>(q),
                 static_cast<const int32_t*>(q_len),
                 static_cast<const uint8_t*>(r),
                 static_cast<const int32_t*>(r_len),
                 static_cast<const int32_t*>(d0),
                 N, Lq, W, band, match, mismatch, gap_open, gap_extend,
                 window, capped,
                 static_cast<int32_t*>(opt), static_cast<uint8_t*>(matched),
                 static_cast<int32_t*>(i_first), static_cast<int32_t*>(i_last),
                 static_cast<int32_t*>(base), static_cast<int32_t*>(ins_pack),
                 static_cast<int16_t*>(hm_stage),
                 static_cast<int32_t*>(rows)};
    return launch(a, static_cast<cudaStream_t>(stream));
}

}  // namespace tiled
