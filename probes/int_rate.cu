// Issue-rate probe for Hopper's integer instructions (CUDA C++, sm_90a).
//
// Each variant runs the same loop: 8 accumulators per thread, updated 4
// times per iteration (32 operations), each update reading the next
// accumulator so that no two iterations fold into one.  The variants
// differ only in the operation: plain int32 add and max, the add-max
// pair written in C (the compiler picks the instructions), and the DPX
// intrinsics of compute capability 9.0 (fused add-max, 3-way max, max
// with ReLU, and the packed 16-bit fused add-max).  probes/int_rate.py
// times them and reads the compiled SASS to say which instructions
// each loop issues.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int OP>
__device__ __forceinline__ int step(int x, int y, int p) {
    if constexpr (OP == 0) return x + y;
    else if constexpr (OP == 1) return max(x, y);
    else if constexpr (OP == 2) return max(x + p, y);
    else if constexpr (OP == 3) return __viaddmax_s32(x, p, y);
    else if constexpr (OP == 4) return __vimax3_s32(x, y, p);
    else if constexpr (OP == 5) return __vimax_s32_relu(x, y);
    else if constexpr (OP == 6) return __viaddmax_s32_relu(x, p, y);
    else
        return static_cast<int>(__viaddmax_s16x2(
            static_cast<unsigned>(x), static_cast<unsigned>(p),
            static_cast<unsigned>(y)));
}

template <int OP>
__global__ void __launch_bounds__(256) rate_kernel(int iters, int p, int q,
                                                   int* out,
                                                   long long* clocks) {
    int a[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = threadIdx.x * 8 + k + blockIdx.x;
    long long c0 = 0, t0 = 0;
    if (threadIdx.x == 0 && blockIdx.x == 0) {
        c0 = clock64();
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    }
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int rep = 0; rep < 4; ++rep) {
#pragma unroll
            for (int k = 0; k < 8; ++k) a[k] = step<OP>(a[k], a[(k + 1) & 7], p);
        }
    }
    int s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) s ^= a[k];
    if (s == q) out[blockIdx.x * blockDim.x + threadIdx.x] = s;
    if (threadIdx.x == 0 && blockIdx.x == 0) {
        long long t1;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
        clocks[0] = clock64() - c0;
        clocks[1] = t1 - t0;
    }
}

using Kernel = void (*)(int, int, int, int*, long long*);
constexpr Kernel KERNELS[] = {
    rate_kernel<0>, rate_kernel<1>, rate_kernel<2>, rate_kernel<3>,
    rate_kernel<4>, rate_kernel<5>, rate_kernel<6>, rate_kernel<7>,
};

}  // namespace

extern "C" int int_rate_launch(int op, int blocks, int iters, int p, int q,
                               void* out, void* clocks, void* stream) {
    if (op < 0 || op >= 8) return static_cast<int>(cudaErrorInvalidValue);
    KERNELS[op]<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        iters, p, q, static_cast<int*>(out),
        static_cast<long long*>(clocks));
    return static_cast<int>(cudaGetLastError());
}
