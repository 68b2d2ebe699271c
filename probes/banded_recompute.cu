// The banded posterior kernel with hm recomputed instead of staged.
//
// Built only by probes/banded_hm.py, which times it against the kernel
// the port ships (consent_tpu_torch/csrc/banded_posterior.cu, whose
// pieces this file reuses) at the main path's shapes.  The forward pass
// keeps (H, F) of every 32nd row as int16 checkpoints in shared memory
// and stages no hm; the backward pass walks the 32-row segments from the
// last, reruns each segment's forward rows from its checkpoint into a
// 32-row hm buffer in shared memory, then folds the segment's rows in
// descending order.  Each thread reads back only its own slots, so no
// exchange is needed.  Cost: the forward arithmetic twice, and
// 2 x Lq/32 x BW x 2 B + 32 x BW x 2 B = 16 KB more shared memory per
// lane at Lq = 512, band 128 (22.8 KB in all, so 8 lanes per SM against
// 32); saves the hm round trip through device memory (2 B per cell each
// way).

#include "../consent_tpu_torch/csrc/banded_posterior.cu"

namespace {

constexpr int SEG = 32;

__host__ __device__ constexpr int segments(int Lq) { return (Lq + SEG - 1) / SEG; }

__host__ __device__ constexpr int recompute_extra_bytes(int Lq, int BW) {
    return align16(segments(Lq) * 2 * BW * 2) + align16(SEG * BW * 2);
}

template <int SPT>
__global__ void __launch_bounds__(LANES_PER_BLOCK * 32, min_blocks<SPT>())
banded_recompute_kernel(const Args a) {
    constexpr int BW = 32 * SPT;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n = blockIdx.x * (blockDim.x >> 5) + warp;
    if (n >= a.N) return;
    extern __shared__ __align__(16) unsigned char smem[];
    const int base_bytes = lane_smem_bytes(a.Lq, a.W, BW);
    unsigned char* mem =
        smem + warp * (base_bytes + recompute_extra_bytes(a.Lq, BW));
    const Lane L = lane_setup<SPT>(a, n, lane, mem);
    // checkpoints [segment][H, F][BW], then one segment of hm [SEG][BW]
    int16_t* ck = reinterpret_cast<int16_t*>(mem + base_bytes) + L.b0;
    int16_t* hs = reinterpret_cast<int16_t*>(
                      mem + base_bytes + align16(segments(a.Lq) * 4 * BW)) +
                  L.b0;

    int h[SPT], f[SPT], hm[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
        h[j] = 0;
        f[j] = NEG;
    }
    int optv = 0;
    for (int i = 0; i < L.qmax; ++i) {
        if (i % SEG == 0) {
            store_hm<SPT>(ck + (i / SEG) * 2 * BW, h);
            store_hm<SPT>(ck + ((i / SEG) * 2 + 1) * BW, f);
        }
        forward_row<SPT>(L, i, h, f, hm);
#pragma unroll
        for (int j = 0; j < SPT; ++j) optv = max(optv, hm[j]);
    }
    const int opt = __reduce_max_sync(FULL, optv);
    if (lane == 0) a.opt[n] = opt;
    const int optc = opt > 0 ? opt : INT32_MIN;

    int bh[SPT], bf[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
        bh[j] = 0;
        bf[j] = NEG;
    }
    for (int s = L.qmax > 0 ? (L.qmax - 1) / SEG : -1; s >= 0; --s) {
        const int lo = s * SEG;
        const int hi = min(lo + SEG, L.qmax);
        const HmRow<SPT> hc = load_hm<SPT>(ck + s * 2 * BW);
        const HmRow<SPT> fc = load_hm<SPT>(ck + (s * 2 + 1) * BW);
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
            h[j] = hm_at<SPT>(hc, j);
            f[j] = hm_at<SPT>(fc, j);
        }
        for (int i = lo; i < hi; ++i) {
            forward_row<SPT>(L, i, h, f, hm);
            store_hm<SPT>(hs + (i - lo) * BW, hm);
        }
        for (int i = hi - 1; i >= lo; --i) {
            const HmRow<SPT> row = load_hm<SPT>(hs + (i - lo) * BW);
#pragma unroll
            for (int j = 0; j < SPT; ++j) hm[j] = hm_at<SPT>(row, j);
            backward_row<SPT>(L, i, bh, bf, hm, optc);
        }
    }
    write_outputs(L, a, n);
}

}  // namespace

// Band 128 only (the main path's); same arguments as
// banded_posterior_launch, hm_stage unused.
extern "C" int banded_recompute_launch(
    const void* q, const void* q_len, const void* r, const void* r_len,
    const void* d0, int N, int Lq, int W, int BW, int match, int mismatch,
    int gap_open, int gap_extend, int window, void* opt, void* matched,
    void* i_first, void* i_last, void* base, void* ins_pack, void* hm_stage,
    void* stream) {
    if (BW != 128) return static_cast<int>(cudaErrorInvalidValue);
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
    return launch_lanes(banded_recompute_kernel<4>, a,
                        lane_smem_bytes(Lq, W, BW) +
                            recompute_extra_bytes(Lq, BW),
                        static_cast<cudaStream_t>(stream));
}
