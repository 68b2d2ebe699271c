// Full-width posterior alignment on Hopper (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel consent_tpu/ops/pallas_align.py:_kernel
// (wrapper pallas_posterior_summary).  Same contract as the plain
// PyTorch version, consent_tpu_torch/ops/align.py:posterior_summary with
// sc.band == 0, bit for bit in all six outputs.
//
// What it computes, per lane: an affine-gap local alignment over all W
// template columns (the stitch aligner: 640 x 640, scoring 2/-2/3/1,
// exact gaps).  Forward: H/F per column, the match-entering score hm
// staged as int16, opt = max hm.  Backward: the continuation scores, and
// every cell with hm + bh_diag == opt is folded into per-column
// summaries (matched, i_first, i_last, aligned base, the next 16 query
// bases packed 2 bits each).  With exact gaps the horizontal term is an
// exact prefix max over the row (a suffix max backward); with a gap
// cap it is a max over the last `window` columns.
//
// What bounds it on this card: integer instructions on the ALU pipe.
// Counted as the card issues them, with Hopper's DPX instructions (one
// VIADDMNMX for max(a + b, c), one VIMNMX3 for a 3-way max, either with
// a max with 0), a cell with exact gaps needs 12 ALU instructions over
// both passes (chip_smoke.py: alu_per_cell); its adds can issue as IMAD
// on the FMA pipe beside them.  probes/int_rate.py measured VIADDMNMX
// and VIMNMX3 at 64 per clock per SM on the H100, the rate of a plain
// VIMNMX.  At 1,024 lanes x 640 x 640 = 419 M cells that is 5.0 G
// instructions, 0.30 ms at 16.7 T/s (132 SMs x 64 lanes x 1.98 GHz).
// The hm staging of this design is 640 x 640 x 2 B = 800 KiB per lane,
// written once and read once: 1.68 GB, 0.50 ms at 3.35 TB/s, above
// that floor.
//
// Design: one block per lane; each thread owns C consecutive columns
// (C = 1 up to 1,024 columns, 2 up to 2,048, 4 up to MAX_W = 4,096) and
// keeps their DP state and posterior accumulators in registers.  The
// exact prefix max is a running max over the thread's own columns, then
// a block scan of the threads' totals: a shuffle scan inside each warp,
// then each warp folds in the totals of the warps before it from shared
// memory.  The diagonal predecessor (column j-1 of the previous row)
// goes through shared memory: two __syncthreads per row.  hm does not
// fit shared memory, so it is staged in a global scratch the wrapper
// allocates ([N, Lq, W] int16).  ins_pack is computed only where a
// column is first matched, from the query row in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 14);
constexpr int INS_PACK = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_W = 4096;     // 4 columns per thread, 1,024 threads

__device__ __forceinline__ int pack_ins(const uint8_t* qs, int i, int qmax) {
    uint32_t p = 0;
    for (int k = 0; k < INS_PACK; ++k) {
        const int idx = i + 1 + k;
        if (idx < qmax) p += static_cast<uint32_t>(qs[idx]) << (2 * k);
    }
    return static_cast<int>(p);
}

// Exclusive prefix max of x over the block's threads (identity NEG).
// Holds one __syncthreads; wsum is [32] shared ints.
__device__ __forceinline__ int block_prefix_max_excl(int x, int lane,
                                                     int warp, int* wsum) {
    int v = x;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v = max(v, y);
    }
    if (lane == 31) wsum[warp] = v;
    int ex = __shfl_up_sync(FULL, v, 1);
    if (lane == 0) ex = NEG;
    __syncthreads();
    const int pw = __reduce_max_sync(FULL, lane < warp ? wsum[lane] : NEG);
    return max(ex, pw);
}

// Exclusive suffix max of x over the block's threads (identity NEG).
__device__ __forceinline__ int block_suffix_max_excl(int x, int lane,
                                                     int warp, int nw,
                                                     int* wsum) {
    int v = x;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_down_sync(FULL, v, d);
        if (lane + d < 32) v = max(v, y);
    }
    if (lane == 0) wsum[warp] = v;
    int ex = __shfl_down_sync(FULL, v, 1);
    if (lane == 31) ex = NEG;
    __syncthreads();
    const int pw = __reduce_max_sync(
        FULL, (lane > warp && lane < nw) ? wsum[lane] : NEG);
    return max(ex, pw);
}

// C columns per thread: thread t owns columns [t*C, t*C + C), and
// columns at or past W (the block's padding up to a whole warp) hold
// NEG in every scan and write nothing.
template <int C>
__global__ void __launch_bounds__(1024) full_posterior_kernel(
    const uint8_t* __restrict__ q, const int32_t* __restrict__ q_len,
    const uint8_t* __restrict__ r, const int32_t* __restrict__ r_len,
    int Lq, int W, int match, int mismatch, int gap_open, int gap_extend,
    int window, int32_t* __restrict__ opt_out,
    uint8_t* __restrict__ matched_out, int32_t* __restrict__ ifirst_out,
    int32_t* __restrict__ ilast_out, int32_t* __restrict__ base_out,
    int32_t* __restrict__ ins_out, int16_t* __restrict__ hm_stage) {
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nw = T >> 5;
    const int n = blockIdx.x;
    const int j0 = t * C;
    const bool exact = window >= W;

    extern __shared__ int smem[];
    int* hs = smem;                   // [W] previous row's H (BH)
    int* xs = hs + W;                 // [W] windowed-scan inputs
    int* wsum = xs + W;               // [32] per-warp scan totals
    uint8_t* qs = reinterpret_cast<uint8_t*>(wsum + 32);   // [Lq]

    const uint8_t* qn = q + static_cast<size_t>(n) * Lq;
    for (int k = t; k < Lq; k += T) qs[k] = qn[k];
    const int qlen = q_len[n];
    const int qmax = min(qlen, Lq);
    const int rlen = r_len[n];
    int16_t* hm_n = hm_stage + static_cast<size_t>(n) * Lq * W;
    const int oe = gap_open - gap_extend;
    bool live[C], in_ref[C];
    int rj[C], jext[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        live[c] = j < W;
        in_ref[c] = live[c] && j < rlen;
        rj[c] = live[c] ? r[static_cast<size_t>(n) * W + j] : 0;
        jext[c] = j * gap_extend;
        if (live[c]) hs[j] = 0;
    }
    __syncthreads();

    // ---------------- forward ----------------
    int h[C], f[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        h[c] = 0;
        f[c] = NEG;
    }
    int optv = 0;
    for (int i = 0; i < Lq; ++i) {
        const bool vq = i < qlen;
        const int qi = qs[i];
        int hm[C], fn[C], ht[C], x[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int j = j0 + c;
            const int sub =
                (vq && in_ref[c]) ? (qi == rj[c] ? match : mismatch) : NEG;
            hm[c] = (live[c] && j >= 1 ? hs[j - 1] : 0) + sub;
            fn[c] = max(h[c] - gap_open, f[c] - gap_extend);
            ht[c] = max(max(hm[c], fn[c]), 0);
            x[c] = live[c] ? ht[c] + jext[c] : NEG;
        }
        int pe[C];
        if (exact) {
            int run = NEG;                        // this thread's columns
#pragma unroll
            for (int c = 0; c < C; ++c) {
                pe[c] = run;
                run = max(run, x[c]);
            }
            const int ex = block_prefix_max_excl(run, lane, warp, wsum);
#pragma unroll
            for (int c = 0; c < C; ++c) pe[c] = max(pe[c], ex);
        } else {
#pragma unroll
            for (int c = 0; c < C; ++c)
                if (live[c]) xs[j0 + c] = x[c];
            __syncthreads();
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int j = j0 + c;
                pe[c] = NEG;                      // max over [j-window, j-1]
                if (!live[c]) continue;
                for (int k = max(0, j - window); k < j; ++k)
                    pe[c] = max(pe[c], xs[k]);
            }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int e = pe[c] - jext[c] - oe;
            if (vq) {
                h[c] = max(ht[c], e);
                f[c] = fn[c];
            }
            if (live[c]) {
                hm_n[static_cast<size_t>(i) * W + j0 + c] =
                    static_cast<int16_t>(hm[c]);
                hs[j0 + c] = h[c];
            }
            optv = max(optv, hm[c]);
        }
        __syncthreads();
    }
    const int wmax = __reduce_max_sync(FULL, optv);
    if (lane == 0) wsum[warp] = wmax;
    __syncthreads();
    const int opt =
        max(__reduce_max_sync(FULL, lane < nw ? wsum[lane] : NEG), 0);
    if (t == 0) opt_out[n] = opt;
#pragma unroll
    for (int c = 0; c < C; ++c)
        if (live[c]) hs[j0 + c] = 0;
    __syncthreads();

    // ---------------- backward + posterior fold ----------------
    int bh[C], bf[C], m[C], ifirst[C], ilast[C], bs[C], ins[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        bh[c] = 0;
        bf[c] = NEG;
        m[c] = 0;
        ifirst[c] = Lq;
        ilast[c] = -1;
        bs[c] = 0;
        ins[c] = 0;
    }
    for (int i = Lq - 1; i >= 0; --i) {
        const bool vq = i < qlen;
        const int qi = qs[i];
        int bhd[C], bfn[C], bt[C], x[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int j = j0 + c;
            const int sub =
                (vq && in_ref[c]) ? (qi == rj[c] ? match : mismatch) : NEG;
            bhd[c] = (j + 1 < W) ? hs[j + 1] : 0;          // BH[i+1][j+1]
            bfn[c] = max(bh[c] - gap_open, bf[c] - gap_extend);
            bt[c] = max(max(sub + bhd[c], bfn[c]), 0);
            x[c] = live[c] ? bt[c] - jext[c] : NEG;
        }
        int se[C];
        if (exact) {
            int run = NEG;                        // this thread's columns
#pragma unroll
            for (int c = C - 1; c >= 0; --c) {
                se[c] = run;
                run = max(run, x[c]);
            }
            const int ex = block_suffix_max_excl(run, lane, warp, nw, wsum);
#pragma unroll
            for (int c = 0; c < C; ++c) se[c] = max(se[c], ex);
        } else {
#pragma unroll
            for (int c = 0; c < C; ++c)
                if (live[c]) xs[j0 + c] = x[c];
            __syncthreads();
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int j = j0 + c;
                se[c] = NEG;                      // max over [j+1, j+window]
                if (!live[c]) continue;
                const int kend = min(W - 1, j + window);
                for (int k = j + 1; k <= kend; ++k) se[c] = max(se[c], xs[k]);
            }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int be = se[c] + jext[c] - oe;
            if (vq) {
                bh[c] = max(bt[c], be);
                bf[c] = bfn[c];
            }
            if (!live[c]) continue;
            const int hm = hm_n[static_cast<size_t>(i) * W + j0 + c];
            if (opt > 0 && hm > NEG / 2 && hm + bhd[c] == opt) {
                // descending i: i_first converges to the minimum, i_last
                // and the captured bases keep the first (= largest) row
                if (!m[c]) {
                    ilast[c] = i;
                    bs[c] = qs[i];
                    ins[c] = pack_ins(qs, i, qmax);
                }
                ifirst[c] = i;
                m[c] = 1;
            }
            hs[j0 + c] = bh[c];
        }
        __syncthreads();
    }

#pragma unroll
    for (int c = 0; c < C; ++c) {
        if (!live[c]) continue;
        const size_t o = static_cast<size_t>(n) * W + j0 + c;
        matched_out[o] = static_cast<uint8_t>(m[c]);
        ifirst_out[o] = ifirst[c];
        ilast_out[o] = ilast[c];
        base_out[o] = bs[c];
        ins_out[o] = ins[c];
    }
}

template <int C>
int launch(const void* q, const void* q_len, const void* r,
           const void* r_len, int N, int Lq, int W, int match, int mismatch,
           int gap_open, int gap_extend, int window, void* opt,
           void* matched, void* i_first, void* i_last, void* base,
           void* ins_pack, void* hm_stage, cudaStream_t stream) {
    const int threads = ((W + C - 1) / C + 31) / 32 * 32;
    const size_t smem = (2 * W + 32) * sizeof(int) + Lq;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            full_posterior_kernel<C>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    full_posterior_kernel<C><<<N, threads, smem, stream>>>(
        static_cast<const uint8_t*>(q), static_cast<const int32_t*>(q_len),
        static_cast<const uint8_t*>(r), static_cast<const int32_t*>(r_len),
        Lq, W, match, mismatch, gap_open, gap_extend, window,
        static_cast<int32_t*>(opt), static_cast<uint8_t*>(matched),
        static_cast<int32_t*>(i_first), static_cast<int32_t*>(i_last),
        static_cast<int32_t*>(base), static_cast<int32_t*>(ins_pack),
        static_cast<int16_t*>(hm_stage));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int full_posterior_launch(
    const void* q, const void* q_len, const void* r, const void* r_len,
    int N, int Lq, int W, int match, int mismatch, int gap_open,
    int gap_extend, int window, void* opt, void* matched, void* i_first,
    void* i_last, void* base, void* ins_pack, void* hm_stage, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W >= 1 && W <= 1024)
        return launch<1>(q, q_len, r, r_len, N, Lq, W, match, mismatch,
                         gap_open, gap_extend, window, opt, matched, i_first,
                         i_last, base, ins_pack, hm_stage, st);
    if (W <= 2048)
        return launch<2>(q, q_len, r, r_len, N, Lq, W, match, mismatch,
                         gap_open, gap_extend, window, opt, matched, i_first,
                         i_last, base, ins_pack, hm_stage, st);
    if (W <= MAX_W)
        return launch<4>(q, q_len, r, r_len, N, Lq, W, match, mismatch,
                         gap_open, gap_extend, window, opt, matched, i_first,
                         i_last, base, ins_pack, hm_stage, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
