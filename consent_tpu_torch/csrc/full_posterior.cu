// Full-width posterior alignment on Hopper (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel consent_tpu/ops/pallas_align.py:_kernel
// (wrapper pallas_posterior_summary).  Same contract as the plain
// PyTorch version, consent_tpu_torch/ops/align.py:posterior_summary with
// sc.band == 0, bit for bit in all six outputs for bases coded 0-3
// (io/seqs.py codes every input so).
//
// What it computes, per lane: an affine-gap local alignment over all W
// template columns (the stitch aligner: 640 x 640, scoring 2/-2/3/1,
// exact gaps).  Forward: H/F per column, the match-entering score hm
// staged as int16, opt = max hm.  Backward: the continuation scores, and
// every cell with hm + bh_diag == opt is folded into per-column first
// and last matched rows; matched, the aligned base and the next 16
// query bases (2 bits each) follow from the last row when the outputs
// are written.  With exact gaps the horizontal term is a max over every
// column before (after) the cell; with a gap cap, over the last
// `window`.
//
// What bounds it on this card, at the lane counts the stitch launches:
// the latency of one lane's chain of dependent steps, not the ALU rate.
// The stitch splits each chunk's jobs into up to 4 interleaved groups
// and pads each device call to a power of two (pipeline/stitch.py,
// pipeline/device_align.py), so a launch carries 16 to 256 lanes, most
// of them 256, some of them padding (q_len = 0).  256 lanes are 64
// blocks of 4 warps on 132 SMs: every lane runs at once on a scheduler
// of its own, and the launch lasts as long as its longest lane.  One
// warp issues at most one instruction a cycle and an integer one every
// other cycle (16 integer lanes per scheduler), so a lane's time is its
// instructions per step, plus the memory waits that nothing else hides,
// times its steps.  The work itself (6 DPX instructions per cell with
// two cells per instruction, chip_smoke.py: alu_per_cell) is ~0.03 ms
// at N = 256 over the card's 16.7 T/s.
//
// Design, for exact gaps and W <= 1,024 (full_posterior_warp_kernel):
// one warp per lane, 4 lanes a block, no block barrier, and a wavefront:
// thread t owns C consecutive columns (C = the width rounded up to 128
// columns, over 32: a template parameter 4, 8, ..., 32; 20 at the main
// width of 640, 24/28/32 at 768/896/1,024) and works on row s - t at
// step s, so the exact horizontal gap is Gotoh's recurrence along the
// row, carried from thread to thread, not a scan: per step one shuffle
// passes (H of the edge column, the gap term leaving it) to the next
// thread.  The DP is int16, two columns per register (Hopper's DPX s16x2
// add-max instructions; the plain version's arithmetic is int16 too),
// the gap terms kept offset by gap_open so that every update is one
// add-max.  Rows stop at each lane's query length in both passes: a
// padding lane (q_len = 0) runs no step and writes the empty summary.
// Substitution scores come from a per-lane profile in shared memory
// (4 bases x the row), loaded two steps ahead.  hm is staged in a
// global scratch the wrapper allocates ([N, Lq + 32, stage_cols(W)]
// int16) by step, [register pair][thread], so every store and load is
// one contiguous 256-byte access of the warp, loaded two steps ahead in
// the backward pass; only the steps' active rows are written.  On-path
// cells are found without a branch per column: hm + bh_diag - opt + 1,
// floored at 0, is 1 exactly on a path, and one IMAD per register packs
// it into a 32-bit mask that a loop over its set bits folds into the
// lane's first and last matched rows in shared memory.
//
// Capped gaps, widths above 1,024 (up to MAX_W = 16,384) and gap scores
// outside the warp kernel's int16 range go to full_posterior_block_kernel
// (the port's first design): one block per lane, each thread owning 1, 2,
// 4, 8 or 16 columns (per-thread arrays; at 8 and 16 they spill to local
// memory), the exact prefix max as a shuffle scan in each warp plus the
// warp totals through shared memory, the diagonal through shared memory
// (two __syncthreads per row), a capped window as a loop over it; rows
// stop at q_len here too.  Its arithmetic is int32 wrapped to int16 after
// every add, as the plain version's int16 tensors wrap: scores of a lane
// thousands of columns wide pass 2^15 (2 per matched base, plus the
// j * extend offset of the gap scan), and there the kernel must wrap
// where the plain version does.  full_posterior_launch picks the kernel.
//
// Templates wider than MAX_W go to full_posterior_tiled_launch: one
// block per lane with the DP rows in global scratch, walked in column
// tiles (posterior_tiled.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "posterior_tiled.cuh"

namespace {

constexpr int NEG = -(1 << 14);
constexpr int INS_PACK = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_W = 16384;       // block kernel: 1,024 threads x 16 columns
constexpr int WARP_MAX_W = 1024;   // warp kernel: 32 threads x 32 columns
constexpr int LANES_PER_BLOCK = 4;
constexpr int SMEM_PER_BLOCK_MAX = 227 * 1024;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Columns of one staged hm row: W rounded up to 128, which is 32 * C
// for the warp kernel (ops/cuda_align.py allocates the same).
__host__ __device__ constexpr int stage_cols(int W) {
    return (W + 127) & ~127;
}

// The 16 query bases after row i, 2 bits each from the LSB, summed as
// the plain version sums them: positions at or past q_len add nothing,
// positions in [Lq, q_len) repeat q[Lq - 1] (its clamped gather).
__device__ __forceinline__ int pack_ins(const uint8_t* qs, int i, int qlen,
                                       int Lq) {
    uint32_t p = 0;
    for (int k = 0; k < INS_PACK; ++k) {
        const int idx = i + 1 + k;
        if (idx < qlen)
            p += static_cast<uint32_t>(qs[min(idx, Lq - 1)]) << (2 * k);
    }
    return static_cast<int>(p);
}

// x as the plain version's int16 arithmetic leaves it: the low 16 bits,
// sign-extended.
__device__ __forceinline__ int w16(int x) {
    return static_cast<int>(static_cast<int16_t>(x));
}

// The kernels' arguments.
struct Args {
    const uint8_t* q;        // [N, Lq]
    const int32_t* q_len;    // [N]
    const uint8_t* r;        // [N, W]
    const int32_t* r_len;    // [N]
    int N, Lq, W, match, mismatch, gap_open, gap_extend, window;
    int32_t* opt;            // [N]
    uint8_t* matched;        // [N, W] outputs
    int32_t* i_first;
    int32_t* i_last;
    int32_t* base;
    int32_t* ins_pack;
    int16_t* hm_stage;       // [N, Lq + 32, stage_cols(W)] scratch
};

// ================ one warp per lane, a wavefront (W <= 1,024) =============
//
// Two int16 columns per 32-bit register, Hopper's DPX s16x2 ops.  Thread
// t owns columns [t*C, t*C + C) as two runs of H = C/2: register k holds
// column t*C + k (run A) in its low half and t*C + H + k (run B) in its
// high half, so the neighbours of register k are registers k - 1 and
// k + 1 but at the runs' ends.  Every value fits int16 with room to
// spare (scores stay below 2^13, NEG is -2^14) and no add wraps: the
// same int16 arithmetic as the plain version.
//
// The gap terms are Gotoh's recurrences along the row, kept offset by
// gap_open so that each is one add-max: with F' = F + open,
// E' = E + open (horizontal, forward) and the same backward,
//   F'[i][j]  = max(F'[i-1][j] - extend, H[i-1][j])
//   Ht[i][j]  = max(H[i-1][j-1] + sub, F'[i][j] - open, 0)
//   E'[i][j]  = max(E'[i][j-1] - extend, Ht[i][j-1])
//   H[i][j]   = max(Ht[i][j], E'[i][j] - open)
// which equal the plain version's exclusive prefix max of
// Ht[k] + k * extend (its E[j] = max_k Ht[k] - open - (j-1-k) * extend).

using u32 = uint32_t;
constexpr u32 NEG2 = 0xc000c000u;               // (NEG, NEG)

__device__ __forceinline__ u32 pack2(int lo, int hi) {
    return __byte_perm(static_cast<u32>(lo), static_cast<u32>(hi), 0x5410);
}
__device__ __forceinline__ int lo16(u32 w) {
    return static_cast<int>(static_cast<int16_t>(w & 0xffffu));
}
__device__ __forceinline__ int hi16(u32 w) {
    return static_cast<int>(w) >> 16;
}

// Shared memory of one lane: i_first, i_last [W] int32; the substitution
// profile [4][C/4][32] uint2 (base b's scores of a thread's registers
// 2m and 2m + 1, NEG at and past the template's end); the query [Lq].
__host__ __device__ constexpr int lane_smem_bytes(int Lq, int W, int C) {
    return align16(8 * W) + 4 * C * 32 * 2 + align16(Lq);
}

// hm staging: one slot of 32 * H words per step, laid out [H/2][32]
// uint2, so each of a thread's H/2 8-byte accesses is one contiguous
// 256-byte access of the warp.
template <int H>
__device__ __forceinline__ void store_hm(u32* slot, int lane,
                                         const u32 (&hm)[H]) {
#pragma unroll
    for (int m = 0; m < H / 2; ++m)
        reinterpret_cast<uint2*>(slot)[m * 32 + lane] =
            make_uint2(hm[2 * m], hm[2 * m + 1]);
}

template <int H>
struct HmRow {
    u32 w[H];
};

template <int H>
__device__ __forceinline__ HmRow<H> load_hm(const u32* slot, int lane) {
    HmRow<H> r;
#pragma unroll
    for (int m = 0; m < H / 2; ++m) {
        const uint2 v = reinterpret_cast<const uint2*>(slot)[m * 32 + lane];
        r.w[2 * m] = v.x;
        r.w[2 * m + 1] = v.y;
    }
    return r;
}

// One row's substitution scores from the profile: pr points at the
// thread's entry of base 0.  Bases are coded 0-3 (io/seqs.py codes every
// input so); the mask keeps any other byte inside the profile.
template <int H>
__device__ __forceinline__ void row_sub(u32 (&sub)[H], const uint2* pr,
                                        int qb) {
    const uint2* p = pr + (qb & 3) * (H / 2) * 32;
#pragma unroll
    for (int m = 0; m < H / 2; ++m) {
        const uint2 v = p[m * 32];
        sub[2 * m] = v.x;
        sub[2 * m + 1] = v.y;
    }
}

// Step s of a pass: thread t works on row s - t (forward) or
// q_len - 1 - (s - (31 - t)) (backward), so the row a thread needs from
// its neighbour was finished one step before.  At the end of a step each
// thread publishes one word, (H of its edge column, the gap term leaving
// it), and at the start of the next its neighbour reads it with one
// shuffle.  A thread outside its rows changes nothing: before its first
// row it publishes (0, NEG), the boundary values of row -1 (q_len); after
// its last only threads outside their rows read it.  hm of (row, thread)
// is staged at the forward step row + thread, so both passes store and
// load one contiguous slot per step.
template <int C>
__global__ void __launch_bounds__(LANES_PER_BLOCK * 32)
full_posterior_warp_kernel(const Args a) {
    constexpr int H = C / 2;                     // registers per thread
    constexpr int S = 32 * C;                    // staged slot width
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n = blockIdx.x * (blockDim.x >> 5) + warp;
    if (n >= a.N) return;  // whole warps only: no block-wide barrier follows
    const int Lq = a.Lq, W = a.W;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* mem = smem + warp * lane_smem_bytes(Lq, W, C);
    int* acc_if = reinterpret_cast<int*>(mem);   // [W] first matched row
    int* acc_il = acc_if + W;                    // [W] last matched row
    uint2* prof = reinterpret_cast<uint2*>(mem + align16(8 * W));
    uint8_t* qs = mem + align16(8 * W) + 4 * C * 32 * 2;   // [Lq] query

    const uint8_t* qn = a.q + static_cast<size_t>(n) * Lq;
    for (int k = lane; k < Lq; k += 32) qs[k] = qn[k];
    for (int k = lane; k < W; k += 32) {
        acc_if[k] = Lq;
        acc_il[k] = -1;
    }
    const int qlen = a.q_len[n];
    const int qmax = max(min(qlen, Lq), 0);
    const int j0 = lane * C;
    const int go = a.gap_open, ge = a.gap_extend;
    {
        // the profile: score of base b against each column, NEG at and
        // past the template's end (columns past W included)
        const int R = min(a.r_len[n], W);
        const uint8_t* rn = a.r + static_cast<size_t>(n) * W;
        int rb[C];
#pragma unroll
        for (int c = 0; c < C; ++c) rb[c] = j0 + c < R ? rn[j0 + c] : -1;
        uint2* pt = prof + lane;
        for (int b = 0; b < 4; ++b) {
#pragma unroll
            for (int m = 0; m < H / 2; ++m) {
                int s[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = (e & 1) ? H + 2 * m + (e >> 1)
                                          : 2 * m + (e >> 1);
                    s[e] = rb[c] < 0 ? NEG
                                     : (rb[c] == b ? a.match : a.mismatch);
                }
                pt[(b * (H / 2) + m) * 32] =
                    make_uint2(pack2(s[0], s[1]), pack2(s[2], s[3]));
            }
        }
    }
    __syncwarp();
    const uint2* pr = prof + lane;
    // the gap carried into run B (A) from the other run's end decays by
    // extend per column: fix-up addends, NEG in the half left alone
    u32 dk[H], dkb[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
        dk[k] = pack2(NEG, -k * ge);
        dkb[k] = pack2(-(H - 1 - k) * ge, NEG);
    }
    const u32 mgo = pack2(-go, -go);
    const u32 mge = pack2(-ge, -ge);
    const int steps = qmax > 0 ? qmax + 31 : 0;
    u32* hm_n = reinterpret_cast<u32*>(a.hm_stage) +
                static_cast<size_t>(n) * (Lq + 32) * (S / 2);

    // ---------------- forward ----------------
    // A thread's rows advance one per step, so the scores of row r are
    // loaded two steps ahead into the buffer of the step's parity, each
    // reloaded right after its use: a register copy of a load in flight
    // would wait for it.  Thread t is on row 0 at step t.
    auto load_row = [&](u32 (&buf)[H], int r) {
        if (r >= 0 && r < qmax) row_sub<H>(buf, pr, qs[r]);
    };
    u32 h[H], f[H], sub0[H], sub1[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
        h[k] = 0;
        f[k] = pack2(NEG + go, NEG + go);        // F' of row -1
    }
    load_row(sub0, lane & 1);
    load_row(sub1, 1 - (lane & 1));
    u32 optv = 0;
    u32 pub = pack2(0, NEG);                     // (H[last column], E' out)
    int hd_left = 0;        // H of the left thread's last column, row - 1
    auto fwd_step = [&](int s, u32 (&sub)[H]) {
        const u32 in = __shfl_up_sync(FULL, pub, 1);
        const int r = s - lane;
        if (r >= 0 && r < qmax) {
            u32 hm[H], ht[H], e[H];
            // H[r-1][j-1]: the previous register; for register 0, the
            // left thread's last column (low) and this thread's column
            // H - 1 (high)
            const u32 hd0 = __byte_perm(static_cast<u32>(hd_left), h[H - 1],
                                        0x5410);
#pragma unroll
            for (int k = 0; k < H; ++k) {
                const u32 hd = k ? h[k - 1] : hd0;
                hm[k] = __viaddmax_s16x2(hd, sub[k], NEG2);  // hd + sub
                f[k] = __viaddmax_s16x2(f[k], mge, h[k]);    // F'
                ht[k] = __viaddmax_s16x2_relu(f[k], mgo, hm[k]);
            }
            load_row(sub, r + 2);
            // E' along both runs at once, run B from NEG, then fixed up
            // with what leaves run A
            u32 carry = pack2(lane ? hi16(in) : NEG, NEG);
#pragma unroll
            for (int k = 0; k < H; ++k) {
                e[k] = carry;
                carry = __viaddmax_s16x2(carry, mge, ht[k]);
            }
            const int mid = lo16(carry);
            const u32 mid2 = pack2(0, mid);
#pragma unroll
            for (int k = 0; k < H; ++k) {
                e[k] = __viaddmax_s16x2(dk[k], mid2, e[k]);
                h[k] = __viaddmax_s16x2(e[k], mgo, ht[k]);
            }
#pragma unroll
            for (int k = 0; k < H; k += 2)
                optv = __vimax3_s16x2(optv, hm[k], hm[k + 1]);
            pub = pack2(hi16(h[H - 1]), max(hi16(carry), mid - H * ge));
            store_hm<H>(hm_n + static_cast<size_t>(s) * (S / 2), lane, hm);
        }
        hd_left = lane ? lo16(in) : 0;
    };
    for (int s = 0; s < steps; s += 2) {
        fwd_step(s, sub0);
        if (s + 1 < steps) fwd_step(s + 1, sub1);
    }
    const int opt = __reduce_max_sync(FULL, max(lo16(optv), hi16(optv)));
    if (lane == 0) a.opt[n] = opt;
    // hm + bh_diag <= opt in every cell; equality marks an on-path cell
    // (it implies hm > NEG/2 and a column below W: bh_diag <= opt <
    // 2^13).  1 - opt added and floored at 0 leaves 1 exactly there; no
    // cell is on a path when nothing scored.
    const u32 hit_add = opt > 0 ? pack2(1 - opt, 1 - opt) : NEG2;

    // ---------------- backward + posterior fold ----------------
    // h, f now hold BH and BF' = BF + open.  Columns at or past the
    // template's end keep BH = 0 (their scores are NEG, gap_open > 0),
    // which is also the boundary value past column W - 1.  Thread t is
    // on row q_len - 1 at step 31 - t; rows descend one per step.
#pragma unroll
    for (int k = 0; k < H; ++k) {
        h[k] = 0;
        f[k] = pack2(NEG + go, NEG + go);
    }
    {
        const int odd = (31 - lane) & 1;
        load_row(sub0, qmax - 1 - odd);
        load_row(sub1, qmax - 2 + odd);
    }
    pub = pack2(0, NEG);                         // (BH[first column], BE' out)
    int bhd_right = 0;      // BH of the right thread's first column, row + 1
    u32 seen = 0;           // bit b: the column of mask bit b matched
    // the slot of backward step s is qmax + 30 - s for every thread;
    // slots load four steps ahead (a load from device memory outlasts
    // two steps), one buffer per step modulo 4
    auto slot = [&](int s) {
        return hm_n + static_cast<size_t>(qmax + 30 - s) * (S / 2);
    };
    HmRow<H> hm0{}, hm1{}, hm2{}, hm3{};
    if (steps > 0) {       // steps >= 32: slots 0-3 exist
        hm0 = load_hm<H>(slot(0), lane);
        hm1 = load_hm<H>(slot(1), lane);
        hm2 = load_hm<H>(slot(2), lane);
        hm3 = load_hm<H>(slot(3), lane);
    }
    auto back_step = [&](int s, u32 (&sub)[H], HmRow<H>& cur) {
        const u32 in = __shfl_down_sync(FULL, pub, 1);
        const int r = qmax - 1 - s + (31 - lane);
        if (r >= 0 && r < qmax) {
            u32 bt[H], e[H], bhd[H];
            // BH[r+1][j+1]: the next register; for register H - 1, this
            // thread's column H (low) and the right thread's first
            // column (high)
            const u32 bhd_last = __byte_perm(h[0], static_cast<u32>(bhd_right),
                                             0x5432);
            // on-path mask: bit k for column j0 + k, bit 16 + k for
            // column j0 + H + k
            u32 mask = 0;
#pragma unroll
            for (int k = 0; k < H; ++k) {
                bhd[k] = k < H - 1 ? h[k + 1] : bhd_last;
                f[k] = __viaddmax_s16x2(f[k], mge, h[k]);    // BF'
                const u32 sb = __viaddmax_s16x2(sub[k], bhd[k], NEG2);
                bt[k] = __viaddmax_s16x2_relu(f[k], mgo, sb);
                const u32 on = __viaddmax_s16x2_relu(
                    __viaddmax_s16x2(cur.w[k], bhd[k], NEG2), hit_add, 0u);
                mask += on << k;
            }
            load_row(sub, r - 2);
            while (mask) {
                const int b = __ffs(mask) - 1;
                mask &= mask - 1;
                const int j = j0 + (b < 16 ? b : b - 16 + H);
                // descending rows: the first row stored last is the
                // smallest, the first one seen the largest
                acc_if[j] = r;
                if (!((seen >> b) & 1u)) {
                    acc_il[j] = r;
                    seen |= 1u << b;
                }
            }
            // BE' along both runs at once, leftwards, run A from NEG,
            // then fixed up with what leaves run B
            u32 carry = pack2(NEG, lane < 31 ? hi16(in) : NEG);
#pragma unroll
            for (int k = H - 1; k >= 0; --k) {
                e[k] = carry;
                carry = __viaddmax_s16x2(carry, mge, bt[k]);
            }
            const int mid = hi16(carry);
            const u32 mid2 = pack2(mid, 0);
#pragma unroll
            for (int k = 0; k < H; ++k) {
                e[k] = __viaddmax_s16x2(dkb[k], mid2, e[k]);
                h[k] = __viaddmax_s16x2(e[k], mgo, bt[k]);
            }
            pub = pack2(lo16(h[0]), max(lo16(carry), mid - H * ge));
        }
        bhd_right = lane < 31 ? lo16(in) : 0;
        if (s + 4 < steps) cur = load_hm<H>(slot(s + 4), lane);
    };
    for (int s = 0; s < steps; s += 4) {
        back_step(s, sub0, hm0);
        if (s + 1 < steps) back_step(s + 1, sub1, hm1);
        if (s + 2 < steps) back_step(s + 2, sub0, hm2);
        if (s + 3 < steps) back_step(s + 3, sub1, hm3);
    }

    // matched, the base and the packed insertion follow from the last
    // matched row
    __syncwarp();
    for (int j = lane; j < W; j += 32) {
        const size_t o = static_cast<size_t>(n) * W + j;
        const int la = acc_il[j];
        a.matched[o] = la >= 0;
        a.i_first[o] = acc_if[j];
        a.i_last[o] = la;
        a.base[o] = la >= 0 ? qs[la] : 0;
        a.ins_pack[o] = la >= 0 ? pack_ins(qs, la, qlen, Lq) : 0;
    }
}

// ===== one block per lane (capped gaps, W > 1,024, other gap scores) =====

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
// NEG in every scan and write nothing.  Every add and subtract is
// wrapped to int16 (w16) where the plain version's int16 op wraps.
template <int C>
__global__ void __launch_bounds__(1024) full_posterior_block_kernel(
    const Args a) {
    const int T = blockDim.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nw = T >> 5;
    const int n = blockIdx.x;
    const int Lq = a.Lq, W = a.W, window = a.window;
    const int gap_open = a.gap_open, gap_extend = a.gap_extend;
    const int match = a.match, mismatch = a.mismatch;
    const int S = stage_cols(W);
    const int j0 = t * C;
    const bool exact = window >= W;

    extern __shared__ __align__(16) unsigned char smem[];
    int* hs = reinterpret_cast<int*>(smem);   // [W] previous row's H (BH)
    int* xs = hs + W;                 // [W] windowed-scan inputs
    int* wsum = xs + W;               // [32] per-warp scan totals
    uint8_t* qs = reinterpret_cast<uint8_t*>(wsum + 32);   // [Lq]

    const uint8_t* qn = a.q + static_cast<size_t>(n) * Lq;
    for (int k = t; k < Lq; k += T) qs[k] = qn[k];
    const int qlen = a.q_len[n];
    const int qmax = max(min(qlen, Lq), 0);
    const int rlen = a.r_len[n];
    int16_t* hm_n = a.hm_stage + static_cast<size_t>(n) * (Lq + 32) * S;
    const int oe = gap_open - gap_extend;
    bool live[C], in_ref[C];
    int rj[C], jext[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        live[c] = j < W;
        in_ref[c] = live[c] && j < rlen;
        rj[c] = live[c] ? a.r[static_cast<size_t>(n) * W + j] : 0;
        jext[c] = w16(j * gap_extend);
        if (live[c]) hs[j] = 0;
    }
    __syncthreads();

    // ---------------- forward: rows below q_len ----------------
    int h[C], f[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        h[c] = 0;
        f[c] = NEG;
    }
    int optv = 0;
    for (int i = 0; i < qmax; ++i) {
        const int qi = qs[i];
        int hm[C], fn[C], ht[C], x[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int j = j0 + c;
            const int sub = in_ref[c] ? (qi == rj[c] ? match : mismatch) : NEG;
            hm[c] = w16((live[c] && j >= 1 ? hs[j - 1] : 0) + sub);
            fn[c] = max(w16(h[c] - gap_open), w16(f[c] - gap_extend));
            ht[c] = max(max(hm[c], fn[c]), 0);
            x[c] = live[c] ? w16(ht[c] + jext[c]) : NEG;
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
            const int e = w16(w16(pe[c] - jext[c]) - oe);
            h[c] = max(ht[c], e);
            f[c] = fn[c];
            if (live[c]) {
                hm_n[static_cast<size_t>(i) * S + j0 + c] =
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
    if (t == 0) a.opt[n] = opt;
#pragma unroll
    for (int c = 0; c < C; ++c)
        if (live[c]) hs[j0 + c] = 0;
    __syncthreads();

    // ------- backward + posterior fold: from the last row below q_len -------
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
    for (int i = qmax - 1; i >= 0; --i) {
        const int qi = qs[i];
        int bhd[C], bfn[C], bt[C], x[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int j = j0 + c;
            const int sub = in_ref[c] ? (qi == rj[c] ? match : mismatch) : NEG;
            bhd[c] = (j + 1 < W) ? hs[j + 1] : 0;          // BH[i+1][j+1]
            bfn[c] = max(w16(bh[c] - gap_open), w16(bf[c] - gap_extend));
            bt[c] = max(max(w16(sub + bhd[c]), bfn[c]), 0);
            x[c] = live[c] ? w16(bt[c] - jext[c]) : NEG;
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
            const int be = w16(w16(se[c] + jext[c]) - oe);
            bh[c] = max(bt[c], be);
            bf[c] = bfn[c];
            if (!live[c]) continue;
            const int hm = hm_n[static_cast<size_t>(i) * S + j0 + c];
            if (opt > 0 && hm > NEG / 2 && w16(hm + bhd[c]) == opt) {
                // descending i: i_first converges to the minimum, i_last
                // and the captured bases keep the first (= largest) row
                if (!m[c]) {
                    ilast[c] = i;
                    bs[c] = qs[i];
                    ins[c] = pack_ins(qs, i, qlen, Lq);
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
        a.matched[o] = static_cast<uint8_t>(m[c]);
        a.i_first[o] = ifirst[c];
        a.i_last[o] = ilast[c];
        a.base[o] = bs[c];
        a.ins_pack[o] = ins[c];
    }
}

// Opts a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
}

// N lanes, up to LANES_PER_BLOCK warps a block.
template <int C>
int launch_warps(const Args& a, cudaStream_t stream) {
    const int per_lane = lane_smem_bytes(a.Lq, a.W, C);
    const int lanes = min(LANES_PER_BLOCK, SMEM_PER_BLOCK_MAX / per_lane);
    if (lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(lanes) * per_lane;
    auto* kernel = full_posterior_warp_kernel<C>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
        err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(a.N + lanes - 1) / lanes, lanes * 32, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// One block per lane.
template <int C>
int launch_block(const Args& a, cudaStream_t stream) {
    const int threads = ((a.W + C - 1) / C + 31) / 32 * 32;
    const size_t smem = (2 * a.W + 32) * sizeof(int) + a.Lq;
    auto* kernel = full_posterior_block_kernel<C>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<a.N, threads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Takes every W in [1, MAX_W], exact and capped gaps: a warp per lane
// for exact gaps up to WARP_MAX_W columns (C = stage_cols(W) / 32), a
// block per lane for the rest, and for gap scores the warp kernel's
// int16 columns do not take (gap_open <= 0, a negative extension, or
// j * extension reaching 2^13).  hm_stage holds N x (Lq + 32) x
// stage_cols(W) int16.  Other widths return cudaErrorInvalidValue
// without launching.
extern "C" int full_posterior_launch(
    const void* q, const void* q_len, const void* r, const void* r_len,
    int N, int Lq, int W, int match, int mismatch, int gap_open,
    int gap_extend, int window, void* opt, void* matched, void* i_first,
    void* i_last, void* base, void* ins_pack, void* hm_stage, void* stream) {
    const Args a{static_cast<const uint8_t*>(q),
                 static_cast<const int32_t*>(q_len),
                 static_cast<const uint8_t*>(r),
                 static_cast<const int32_t*>(r_len),
                 N, Lq, W, match, mismatch, gap_open, gap_extend, window,
                 static_cast<int32_t*>(opt), static_cast<uint8_t*>(matched),
                 static_cast<int32_t*>(i_first), static_cast<int32_t*>(i_last),
                 static_cast<int32_t*>(base), static_cast<int32_t*>(ins_pack),
                 static_cast<int16_t*>(hm_stage)};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W < 1 || W > MAX_W || N < 1 || Lq < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (W <= WARP_MAX_W && window >= W && gap_open > 0 && gap_extend >= 0 &&
        W * gap_extend < (1 << 13)) {
        switch (stage_cols(W) / 32) {
            case 4: return launch_warps<4>(a, st);
            case 8: return launch_warps<8>(a, st);
            case 12: return launch_warps<12>(a, st);
            case 16: return launch_warps<16>(a, st);
            case 20: return launch_warps<20>(a, st);
            case 24: return launch_warps<24>(a, st);
            case 28: return launch_warps<28>(a, st);
            default: return launch_warps<32>(a, st);
        }
    }
    if (W <= 1024) return launch_block<1>(a, st);
    if (W <= 2048) return launch_block<2>(a, st);
    if (W <= 4096) return launch_block<4>(a, st);
    if (W <= 8192) return launch_block<8>(a, st);
    return launch_block<16>(a, st);
}

// Templates wider than MAX_W (any width): one block per lane, the DP
// rows in global scratch (posterior_tiled.cuh; hm_stage holds
// N x Lq x W int16, rows N x 4 x W int32).  band must be 0.
extern "C" int full_posterior_tiled_launch(
    const void* q, const void* q_len, const void* r, const void* r_len,
    const void* d0, int N, int Lq, int W, int band, int match, int mismatch,
    int gap_open, int gap_extend, int window, int capped, void* opt,
    void* matched, void* i_first, void* i_last, void* base, void* ins_pack,
    void* hm_stage, void* rows, void* stream) {
    if (band != 0) return static_cast<int>(cudaErrorInvalidValue);
    return tiled::launch_c(q, q_len, r, r_len, d0, N, Lq, W, 0, match,
                           mismatch, gap_open, gap_extend, window, capped,
                           opt, matched, i_first, i_last, base, ins_pack,
                           hm_stage, rows, stream);
}
