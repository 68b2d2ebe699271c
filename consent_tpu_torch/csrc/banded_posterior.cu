// Banded posterior alignment on Hopper (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel consent_tpu/ops/pallas_align.py:
// _kernel_banded (wrapper pallas_banded_posterior_summary).  Same
// contract as the plain PyTorch version,
// consent_tpu_torch/ops/align.py:posterior_summary with sc.band > 0,
// bit for bit in all six outputs.
//
// What it computes, per lane (one (fragment, template) pair): a banded
// affine-gap local alignment.  Row i of the DP holds BW slots; slot b is
// kernel column chat = i + b - BW/2, i.e. true template column
// chat + d0.  Forward: H/F per slot, the match-entering score hm staged
// as int16, opt = max hm.  Backward: the continuation scores, and every
// cell with hm + bh_diag == opt is folded into per-column summaries
// (matched, i_first, i_last, aligned base, the next 16 query bases
// packed 2 bits each).  Horizontal gaps are scored over a window of
// `window` columns (16 on the main path).
//
// What bounds it on this card: integer instructions on the ALU pipe.
// Counted as the card issues them, with Hopper's DPX instructions (one
// VIADDMNMX for max(a + b, c), one VIMNMX3 for a 3-way max, either with
// a max with 0), a band cell needs 16 ALU instructions over both passes
// (chip_smoke.py: alu_per_cell); its adds can issue as IMAD on the FMA
// pipe beside them.  probes/int_rate.py measured VIADDMNMX and VIMNMX3
// at 64 per clock per SM on the H100, the rate of a plain VIMNMX, and
// nvcc emits VIADDMNMX for a plain max(a + b, c) on sm_90a.  At B*S =
// 4,096 lanes x 512 rows x 128 slots = 268 M cells that is 4.3 G
// instructions, 0.26 ms at 16.7 T/s (132 SMs x 64 lanes x 1.98 GHz).
// The hm staging of this design is 512 x 128 x 2 B = 128 KiB per lane,
// written once and read once: 1.07 GB, 0.32 ms at 3.35 TB/s, above
// that floor; recomputing hm in the backward pass would remove it at
// the cost of the forward pass's 8 instructions per cell.
//
// Design: one block per lane, one thread per band slot, DP state in
// registers.  In band coordinates the diagonal predecessor is the same
// slot of the previous row (no exchange); the vertical predecessor is
// slot b+1 (b-1 backward) and goes through shared memory, as does the
// windowed horizontal max (each thread reads the <= 16 values it
// needs): two __syncthreads per row.  The per-column accumulators live
// in shared memory (5 x W x 4 B); within a row each slot owns a
// distinct column, so the fold has no races.  hm is staged in a global
// scratch the wrapper allocates ([N, Lq, BW] int16): kept in shared
// memory it would allow one block per SM and leave the SMs latency
// bound, while the global round trip costs less than the arithmetic.
// ins_pack is computed only where a column is first matched, from the
// query row in shared memory.  The wrapper's pre-rotation of the
// template by d0 becomes plain indexing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 14);
constexpr int INS_PACK = 16;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int pack_ins(const uint8_t* qs, int i, int qmax) {
    uint32_t p = 0;
    for (int k = 0; k < INS_PACK; ++k) {
        const int idx = i + 1 + k;
        if (idx < qmax) p += static_cast<uint32_t>(qs[idx]) << (2 * k);
    }
    return static_cast<int>(p);
}

__global__ void banded_posterior_kernel(
    const uint8_t* __restrict__ q, const int32_t* __restrict__ q_len,
    const uint8_t* __restrict__ r, const int32_t* __restrict__ r_len,
    const int32_t* __restrict__ d0p, int Lq, int W, int match,
    int mismatch, int gap_open, int gap_extend, int window,
    int32_t* __restrict__ opt_out, uint8_t* __restrict__ matched_out,
    int32_t* __restrict__ ifirst_out, int32_t* __restrict__ ilast_out,
    int32_t* __restrict__ base_out, int32_t* __restrict__ ins_out,
    int16_t* __restrict__ hm_stage) {
    const int BW = blockDim.x;
    const int OFF = BW / 2;
    const int b = threadIdx.x;
    const int n = blockIdx.x;

    extern __shared__ int smem[];
    int* vts = smem;                  // [BW] vertical-move scores
    int* xs = vts + BW;               // [BW] horizontal-scan inputs
    int* red = xs + BW;               // [32] opt reduction
    int* acc_if = red + 32;           // [W] per kernel column
    int* acc_il = acc_if + W;
    int* acc_base = acc_il + W;
    int* acc_ins = acc_base + W;
    uint8_t* acc_m = reinterpret_cast<uint8_t*>(acc_ins + W);   // [W]
    uint8_t* qs = acc_m + W;          // [Lq]
    uint8_t* rs = qs + Lq;            // [W]

    const uint8_t* qn = q + static_cast<size_t>(n) * Lq;
    const uint8_t* rn = r + static_cast<size_t>(n) * W;
    for (int k = b; k < Lq; k += BW) qs[k] = qn[k];
    for (int k = b; k < W; k += BW) {
        rs[k] = rn[k];
        acc_m[k] = 0;
        acc_if[k] = Lq;
        acc_il[k] = -1;
        acc_base[k] = 0;
        acc_ins[k] = 0;
    }
    const int qlen = q_len[n];
    const int qmax = min(qlen, Lq);
    const int d0 = d0p[n];
    // valid kernel columns: [clip(-d0, 0, W), clip(r_len - d0, 0, W))
    const int jlo = min(max(-d0, 0), W);
    const int jhi = min(max(min(r_len[n], W) - d0, 0), W);
    int16_t* hm_n = hm_stage + static_cast<size_t>(n) * Lq * BW;
    const int bext = b * gap_extend;
    const int oe = gap_open - gap_extend;
    __syncthreads();

    // ---------------- forward ----------------
    int h = 0, f = NEG, optv = 0;
    for (int i = 0; i < Lq; ++i) {
        const int chat = i + b - OFF;
        const bool vq = i < qlen;
        int sub = NEG;
        if (vq && chat >= jlo && chat < jhi)
            sub = (qs[i] == rs[chat + d0]) ? match : mismatch;
        const int hm = h + sub;                   // diagonal = same slot
        vts[b] = max(h - gap_open, f - gap_extend);
        __syncthreads();
        const int fn = (b + 1 < BW) ? vts[b + 1] : NEG;
        const int ht = max(max(hm, fn), 0);
        xs[b] = ht + bext;
        __syncthreads();
        int pe = NEG;                             // max over [b-window, b-1]
        for (int k = max(0, b - window); k < b; ++k) pe = max(pe, xs[k]);
        const int e = pe - bext - oe;
        if (vq) {
            h = max(ht, e);
            f = fn;
        }
        hm_n[static_cast<size_t>(i) * BW + b] = static_cast<int16_t>(hm);
        optv = max(optv, hm);
    }
    const int wmax = __reduce_max_sync(FULL, optv);
    if ((b & 31) == 0) red[b >> 5] = wmax;
    __syncthreads();
    int opt = 0;
    for (int w = 0; w < (BW >> 5); ++w) opt = max(opt, red[w]);
    if (b == 0) opt_out[n] = opt;

    // ---------------- backward + posterior fold ----------------
    int bh = 0, bf = NEG;
    for (int i = Lq - 1; i >= 0; --i) {
        const int chat = i + b - OFF;
        const bool vq = i < qlen;
        int sub = NEG;
        if (vq && chat >= jlo && chat < jhi)
            sub = (qs[i] == rs[chat + d0]) ? match : mismatch;
        const int bhd = bh;                       // (i+1, chat+1) = same slot
        vts[b] = max(bh - gap_open, bf - gap_extend);
        __syncthreads();
        const int bfn = (b >= 1) ? vts[b - 1] : NEG;
        const int bt = max(max(sub + bhd, bfn), 0);
        xs[b] = bt - bext;
        __syncthreads();
        int se = NEG;                             // max over [b+1, b+window]
        const int kend = min(BW - 1, b + window);
        for (int k = b + 1; k <= kend; ++k) se = max(se, xs[k]);
        const int be = se + bext - oe;
        if (vq) {
            bh = max(bt, be);
            bf = bfn;
        }
        const int hm = hm_n[static_cast<size_t>(i) * BW + b];
        if (opt > 0 && hm > NEG / 2 && hm + bhd == opt && chat >= 0 &&
            chat < W) {
            // descending i: i_first converges to the minimum, i_last and
            // the captured bases keep the first (= largest) row seen
            if (!acc_m[chat]) {
                acc_il[chat] = i;
                acc_base[chat] = qs[i];
                acc_ins[chat] = pack_ins(qs, i, qmax);
            }
            acc_if[chat] = i;
            acc_m[chat] = 1;
        }
    }
    __syncthreads();

    // kernel column -> true column j = chat + d0; columns with no kernel
    // column get the unmatched fills
    for (int j = b; j < W; j += BW) {
        const size_t o = static_cast<size_t>(n) * W + j;
        const int c = j - d0;
        if (c >= 0 && c < W) {
            matched_out[o] = acc_m[c];
            ifirst_out[o] = acc_if[c];
            ilast_out[o] = acc_il[c];
            base_out[o] = acc_base[c];
            ins_out[o] = acc_ins[c];
        } else {
            matched_out[o] = 0;
            ifirst_out[o] = Lq;
            ilast_out[o] = -1;
            base_out[o] = 0;
            ins_out[o] = 0;
        }
    }
}

}  // namespace

extern "C" int banded_posterior_launch(
    const void* q, const void* q_len, const void* r, const void* r_len,
    const void* d0, int N, int Lq, int W, int BW, int match, int mismatch,
    int gap_open, int gap_extend, int window, void* opt, void* matched,
    void* i_first, void* i_last, void* base, void* ins_pack, void* hm_stage,
    void* stream) {
    const size_t smem = (2 * BW + 32 + 4 * W) * sizeof(int) + 2 * W + Lq;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            banded_posterior_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    banded_posterior_kernel<<<N, BW, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(q), static_cast<const int32_t*>(q_len),
        static_cast<const uint8_t*>(r), static_cast<const int32_t*>(r_len),
        static_cast<const int32_t*>(d0), Lq, W, match, mismatch, gap_open,
        gap_extend, window, static_cast<int32_t*>(opt),
        static_cast<uint8_t*>(matched), static_cast<int32_t*>(i_first),
        static_cast<int32_t*>(i_last), static_cast<int32_t*>(base),
        static_cast<int32_t*>(ins_pack), static_cast<int16_t*>(hm_stage));
    return static_cast<int>(cudaGetLastError());
}
