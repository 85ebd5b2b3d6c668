// Blind rotation of TFHE gate bootstrapping for NVIDIA Hopper (sm_90a).
//
// Replaces cufhe_tpu/ops/pallas_br.py:blind_rotate_pallas, the Pallas TPU
// kernel, and computes the same function bit for bit: for i = 0 .. n0-1,
//
//   acc <- acc + sum_r dec_r * BK_i[r]   (negacyclic products, mod 2^32)
//   dec  = Decomp(acc * X^abar_i - acc + offset)
//
// over a batch of B accumulators [B, k+1, N]. All torus arithmetic is
// uint32_t, whose wrap is the reduction mod 2^32; the int32 tensors of the
// caller are reinterpreted as uint32_t. Two kernels per step, launched in
// order on the caller's stream: rotdec_kernel, then extprod_kernel; or,
// at small batches, one persistent_extprod_kernel that walks all n0 steps
// (the end of this note).
//
// rotdec_kernel replaces the Pallas kernel's rotdec closure
// (pallas_br.py:428-487). For each row (b, j < k+1) and coefficient t < N:
//
//   temp = (acc * X^abar)[b, j, t] - acc[b, j, t] + off            (uint32)
//   dig_d = ((temp >> (32 - (d+1)*Bgbit)) & (Bg-1)) - Bg/2           d < l
//   dec[b, (j*l + d)*nd + dl, t] = int8 sub-digit dl of dig_d       dl < nd
//
// (the last sub-digit takes the rest), the A operand of the product in
// the Pallas kernel's row order rr. The TPU rotates with a ladder of nbit
// static rolls because a per-row dynamic gather is slow there; here the
// rotation is a gather out of shared memory.
//
// What bounds it on an H100: bytes. At tfhepp_128bit, B = 4096, a launch
// reads 33.5 MB of acc and writes 25.2 MB of dec, 58.7 MB, 17.5 us at
// 3.35 TB/s; its integer work (a dozen operations a coefficient and digit
// row) is a few microseconds of issue, if little is spent around it. The
// first version, a thread per coefficient with two 64-bit divisions by a
// runtime value and one-byte stores N bytes apart, spent 77.5 us a launch
// issuing instructions.
//
// What this version does about it: a block of kRotThreads threads owns
// whole rows, kRotThreads * kRotQuads * 4 coefficients of them where the
// row is long enough, so (b, j) costs one 32-bit division a thread. It
// copies its rows, which are contiguous in acc, into shared memory with
// 16-byte cp.async (every device-memory read a full 16-byte vector, all of
// a thread's loads in flight at once) and reads the rotation meanwhile. A
// thread then works on quads (4 coefficients) q = lane, lane + tpr, ... of
// its row: its own quad and the two aligned quads that hold the rotated
// window are 16-byte shared loads at consecutive addresses across the warp
// (no bank conflict); the window's word shift, (-abar) mod 4, is the same
// for the whole row. Each digit row of a quad is one 4-byte store, so a
// warp writes 128 contiguous bytes a store. l and nd are template
// arguments for the published sets, so the digit loops unroll:
// rotdec_kernel<3, 1> is 288 SASS instructions against 536 for the
// generic <0, 0> (cuobjdump -sass of the built library), and on an H100
// the launch at tfhepp_128bit, B = 4096, went from about 38 us to 28 us
// with that alone. A row is 4N bytes of shared memory: N <= 2^kRotMaxNbit (128 KB)
// is held, larger N are refused with cudaErrorInvalidValue.
//
// extprod_kernel: acc[b,o,c] += sum_li (sum_{r,t} dec[b,r,t] *
// L_li[r,o][N + c - t]) << 8*(li + 4 - NL), where L_li is limb li of the
// extended generator ext = [-bk, bk] (prepare_bk_ext). NL = 4 is the exact
// key; NL = 3 the reduced-precision pallas3 key, limbs 1-3 of the four
// (pallas_br.py:57-62, 907-920), whose instance issues 3/4 of the exact
// instance's MMAs. The arithmetic is the JAX kernel's bit for bit.
//
// What bounds it on an H100: int8 multiply-adds. At tfhepp_128bit one step
// at B = 4096 is a 4096 x 6144 x 8192 product (batch rows x contraction
// bytes (r, t) x columns (o, limb, c)), 2.06e11 MACs: 0.208 ms at the
// 1,979 TOPS dense int8 data-sheet rate (0.156 ms at three limbs), against
// about 0.04 ms of device-memory traffic. History: the earlier kernel on
// mma.sync m16n8k32, the key's Toeplitz operator built in registers as
// mma's B operand, ran 0.615-0.621 ms a launch exact and 0.465-0.467 ms at
// three limbs, a third of the bound, where the mma.sync probe
// (csrc/mxu_peak.cu) tops out at this shape; the wgmma probe reaches 80 %.
// wgmma reads its B operand only from shared memory, its A from shared
// memory or registers.
//
// What this version does about it: it computes the transposed product,
// acc^T = T^T dec^T, on wgmma m64n64k32 s8:
//  - M is the outputs (o, c), one m64 tile per consumer warpgroup and limb;
//    N the batch rows b; K the contraction (r, t).
//  - A is the key's negacyclic Toeplitz operator, T^T[(o,c), (r,t)] =
//    ext_li[r,o][N + c - t], built in registers (wgmma's register A, K-major
//    as .s8 requires). A warp's fragment of m64nNk32 is mma.m16n8k32's:
//    register 2*h2 + hi of lane (g, q) holds row g (hi = 0) or g + 8 (hi =
//    1) of the warp's 16, contraction bytes 16*h2 + 4q .. +3. Four
//    consecutive contraction bytes of one output are four consecutive key
//    bytes in reverse order, so each register is one __byte_perm of two
//    aligned words of a key window in shared memory (the earlier kernel's
//    trick): window bytes xa+3, xa+2, xa+1, xa with xa = 4m + sh, where sh
//    = (g + 1) mod 4 and the word m depend on the lane only (the formula
//    is at the consumer's code; tests/test_torch_extprod.py models it).
//  - Row g + 8 of a warp's 16 is the output 32 further on (rows g: outputs
//    c0 + 8*warp + g, rows g + 8: c0 + 32 + 8*warp + g), so within one key
//    row the upper rows' registers at k-step kk are the lower rows' at kk-1:
//    20 window loads a limb and stage instead of 32.
//  - B is dec [B, I*N] int8 as rotdec_kernel writes it, already K-major: a
//    producer warp brings [64 rows x 128 bytes] boxes by TMA (128-byte
//    swizzle, rows at or past B and bytes past I*N filled with zeros), and
//    each stage's key windows, one a limb and run of min(N, 128) outputs,
//    by cp.async.bulk, into a ring of kStages slots under full and empty
//    mbarriers.
//  - A block owns 128 outputs x NL limbs x 64 batch rows: two consumer
//    warpgroups of 64 outputs each, sharing the dec tile. A warpgroup
//    builds a stage's A registers (4 k-steps x NL limbs), then issues its
//    NL * 4 wgmma (one per limb and k-step, all k-steps on one B
//    descriptor) as one group and waits for it while the other
//    warpgroup's group runs. Every thread holds all NL limb sums of its
//    (c, b) positions, so the epilogue acc += sum_li sums_li << 8*(li + 4
//    - NL) runs in registers.
//  - Where output tiles x batch tiles leave SMs idle (small batches), the
//    contraction's stages are cut into gridDim.z ranges. Every block adds
//    its partial to acc with red.global.add.u32, one range or several:
//    adds mod 2^32 are exact in any order. ops/blind_rotate.py:
//    extprod_plan chooses the split; the grid and the ranges follow from
//    it here.
//  - Shapes: a stage is 128 contraction bytes; for N < 128 it spans 128/N
//    key rows, each with its own windows (SEG = min(N, 128) template
//    argument). Outputs past (k+1)*N (TINY_K2: 96) get zero fragments and
//    are not stored.
// On an H100 (PERF.md) it runs 0.35 ms a launch exact and 0.27 ms at
// three limbs, 60 % and 57 % of the bound. The same kernel with a plain
// read-add-write of acc where the split is 1 ran 0.46 / 0.39 ms, likely
// the loads' latency with the SM's one block idle behind them
// (red.global.add does not wait for its result). Measured on the way
// there, all with that read-add-write: a wgmma group per k-step instead
// of per stage, 0.50 / 0.44 ms; two 32-output key windows per warpgroup
// instead of one a run, 0.49 / 0.43; no window loads at all (a wrong
// result, to time the rest), 0.40 / 0.36; m64n128 with the limbs split
// over warpgroups (2 x 2, 3 x 1), 0.54 / 0.47; a second set of A
// registers to keep a group in flight across stages, 0.53 / 0.38 with
// ptxas serialising wgmma where N = 64.
// The int32 sums are exact while I*N*2^(dbits-1)*128 < 2^31 (2^24.6 at
// tfhepp_128bit); cufhe_blind_rotate refuses any set where it is not.
//
// Karatsuba leaves (depth D = 1 or 2; ops/blind_rotate.py:kar_depth, the
// JAX kernel's rule, pallas_br.py:160-190): the negacyclic Toeplitz
// operator of a key polynomial splits into 2x2 Toeplitz blocks [[A, T01],
// [T10, A]], and three leaf products replace four: A (x_l + x_r) adds to
// both output halves, (T01 - A) x_r to the first, (T10 - A) x_l to the
// second. Each leaf's operator is again a Toeplitz operator of half the
// size whose extended generator is a slice or difference of the parent's
// (prepare_bk_ext builds the 3^D leaf generators in uint32 before the limb
// split), so each leaf is the depth-0 product at LN = N >> D, and 3^D
// leaves do (3/4)^D of its multiply-adds: 9/16 at D = 2. Every step is
// linear mod 2^32: the result is the same uint32 words.
//  - rotdec_kernel<L, ND, D> writes the leaf operands: dec [B, 3^D, I, LN],
//    leaf v's row rr a sum of 1, 2 or 4 of the row's 2^D quarters
//    (__vadd4 on packed digits; |digit| << D <= 128 keeps each in int8).
//  - extprod_kernel<NL, SEG, D> reads dec as one [B, 3^D * I * LN]
//    contraction whose stage s belongs to leaf s / S (S stages a leaf) and
//    the key [I, k+1, NL, 3^D * 2LN] (leaf v's generator at 2LN v). A block
//    owns 128 outputs (o, c < LN) of every leaf. At the end of each leaf (or
//    of its range) a consumer folds its limb sums into uint32 and adds
//    them to the 2^D quarters the leaf feeds, held per thread in shared
//    memory (32 KB a quarter, beside the ring); after its range it adds
//    each quarter it touched to acc with one red.global.add an output, as
//    the depth-0 kernel does.
//  - Where the contraction is split (small batches), ops/blind_rotate.py:
//    extprod_plan cuts it into a multiple of 3^D ranges, so no range
//    straddles two leaves.
// On an H100 at tfhepp_128bit and B = 4096 (PERF.md) a launch takes 0.230
// ms at D = 2, 0.291 ms at D = 1 and 0.349 ms at D = 0: against the 9/16
// and 3/4 of the depth-0 time, the folds cost about two stages each, as
// both consumer warpgroups reach a leaf's end together. Measured on the
// way there: 4-byte quarter stores instead of 16-byte ones, 0.236 ms; the
// next leaf's first wgmma overwriting the sums (scale-d 0) in place of
// zeroing them in the fold, 0.245 ms.
//
// The persistent rotation, persistent_extprod_kernel<NL, SEG, D, L, ND>.
// Where the step's output tiles x batch tiles leave SMs idle (small
// batches; ops/blind_rotate.py:rotation_plan takes it exactly where
// extprod_plan splits the contraction), the loop's launches cost more
// than their work: each pays the launch, its blocks' prologue and the
// ring's first fill, and rotdec a launch of its own; an AES-128 block at
// batch 1 is 257 rotations of 2 x 636 launches. So one cooperative launch
// of at most one block an SM walks all n0 steps.
// The batch's 64-row tiles are independent: the acc and dec rows of tile y
// are read and written only by its rows' rotdec and by the product items
// of batch tile y; the key, which all share, is read-only. So the grid's G
// blocks are cut into n = min(ny, G) row-tile groups (tile_group): group g
// is blocks floor(gG/n) .. floor((g+1)G/n) - 1, sizes one apart, and owns
// tiles floor(g ny/n) .. floor((g+1) ny/n) - 1: one tile each on every
// grid rotation_plan gives, where n = ny. Each group walks the n0 steps on its own,
// each step in two phases that barriers of the group alone separate
// (group_sync: the group's counter, kArrivalStride words from the next, in
// a buffer the wrapper zeroes, arrivals released and polled with acquire
// at gpu scope). No group waits for another, so no cycle of waits can
// form; inside a group the walk is the whole grid's of a one-tile batch.
//  1. rotate-and-decompose: the two consumer warpgroups (256 threads, as
//     rotdec_kernel's block) run rotdec_rows, rotdec_kernel's device code,
//     over the blocks of the group's rows (pointers moved to its first
//     row) strided by the group's size, staging rows where the quarters
//     live in phase 2; acc arrives by cp.async.cg, through L2, never a
//     stale L1. Meanwhile the producer prefetches the block's share of the
//     step's key into L2. dec's generic stores are fenced
//     (fence.proxy.async) before the barrier: phase 2 reads dec by TMA,
//     the async proxy.
//  2. the product: the group's output tiles x batch tiles x stages, cut
//     into equal shares of stages, one a block of the group (for_share, as
//     stream-K cuts a GEMM: every block does the same work, where
//     extprod_plan's ranges leave some blocks an item more than others); a
//     share's part of a tile is one item, a range of its stages, run by
//     ext_produce and ext_consume, the one item of an extprod_kernel
//     block. The ring's slots and parities carry on from item to item and
//     step to step, and each item adds its partial sums to acc with
//     red.global.add, as there: adds mod 2^32 are exact in any order and
//     grouping.
// The result is the same uint32 words as the loop's: the same digits,
// leaves, limb sums and adds mod 2^32. L and ND unroll rotdec's digit
// loops for the two published sets it runs on (tfhepp_128bit and
// concrete), <0, 0> elsewhere.
// TMA multicast of the dec tile across a cluster is later work.
#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kLimbs = 4;                          // limbs of an exact key
constexpr int kLimbBits = 8;

// rotdec_kernel's tiling: threads per block, and quads (4 coefficients) per
// thread wherever a row has at least kRotThreads * kRotQuads * 4 of them
// (4 measured best of 1, 2, 4 and 8 on an H100: PERF.md).
constexpr int kRotThreads = 256;
constexpr int kRotQuads = 4;
constexpr int kRotMaxNbit = 15;                    // a row of 128 KB

// extprod_kernel's tiling; ops/blind_rotate.py states kOutTile, kRowTile
// and kStageK again (EXTPROD_OUT_TILE, EXTPROD_ROW_TILE,
// EXTPROD_STAGE_BYTES) for extprod_plan's choice of the split.
constexpr int kWgOut = 64;                         // outputs a warpgroup: M
constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kOutTile = kConsumers * kWgOut;      // outputs (o, c) a block
constexpr int kRowTile = 64;                       // batch rows a block: N
constexpr int kStageK = 128;                       // contraction bytes a stage
constexpr int kStages = 8;                         // mbarrier ring depth
constexpr int kGroup = 32;                         // outputs of rows g (g+8)
constexpr int kExtThreads = 128 * (kConsumers + 1);
constexpr int kBTile = kRowTile * kStageK;         // dec bytes a stage
constexpr int kAcc = kRowTile / 2;                 // int32 sums a thread, limb
constexpr int kMaxKar = 2;                         // deepest Karatsuba tree
constexpr int kMinLeaf = 128;                      // least leaf coefficients
constexpr int kMaxSmem = 232448;                   // shared memory of a block
// the persistent kernel's shares end at a leaf's end within this many
// stages of their even cut (share_cut)
constexpr int kShareSnap = 2;
// words from one row-tile group's barrier counter to the next: a 128-byte
// line each (group_sync)
constexpr int kArrivalStride = 32;

__host__ __device__ constexpr int pow3(int d) {
  return d == 0 ? 1 : 3 * pow3(d - 1);
}

// The output quarters (of 2^D) that leaf v of a depth-D Karatsuba tree adds
// to, as a bit mask (pallas_br.py:_leaf_quarters). v's base-3 digits, the
// first level's first, are 0: A (x_l + x_r), both halves; 1: T01 - A
// (x_r), the first half; 2: T10 - A (x_l), the second half.
__host__ __device__ constexpr uint32_t leaf_quarters(int v, int D) {
  uint32_t qs = 1u;                                // {0} at the root
  for (int p = D > 0 ? pow3(D - 1) : 0; p >= 1; p /= 3) {
    const int digit = v / p % 3;
    uint32_t next = 0u;
    for (int q = 0; q < 16; ++q) {
      if (!((qs >> q) & 1u)) continue;
      if (digit != 2) next |= 1u << (2 * q);
      if (digit != 1) next |= 1u << (2 * q + 1);
    }
    qs = next;
  }
  return qs;
}

// The shape of extprod_kernel<NL, SEG, D>: NL key limbs, SEG = min(LN, 128)
// contraction bytes of one key row r in a stage, and as many outputs in a
// run (outputs of one component o that share a key window), Karatsuba
// depth D (LN = N >> D coefficients a leaf). Shared memory of one ring
// slot: the dec tile (1024-byte aligned for the swizzle), then the key
// windows, each kWin bytes (SEG outputs x SEG contraction bytes:
// [LN + c0 - t0 - SEG, LN + c0 - t0 + SEG) of a leaf's ext) and 16 more
// that are read but never used, in the order (seg * kRuns + run) * NL +
// li. At D > 0 the consumers' quarter sums follow the barriers.
template <int NL, int SEG, int D>
struct Ext {
  static constexpr int kSegs = kStageK / SEG;      // key rows a stage
  static constexpr int kSegSteps = SEG / 32;       // k-steps a key row
  static constexpr int kRuns = kOutTile / SEG;     // runs of outputs a block
  static constexpr int kWin = 2 * SEG;
  static constexpr int kWinStride = kWin + 16;
  static constexpr int kWins = kSegs * kRuns * NL;
  static constexpr int kStageBytes =
      (kBTile + kWins * kWinStride + 1023) / 1024 * 1024;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kLeaves = pow3(D);
  static constexpr int kQuarters = 1 << D;
  // uint32 sums of every consumer thread's outputs in each quarter
  static constexpr int kQBytes =
      D > 0 ? kQuarters * kAcc * 128 * kConsumers * 4 : 0;
  // ring, full and empty barriers, the quarters, and room to align the
  // ring to 1024 B
  static constexpr int kSmem = kRing + 16 * kStages + kQBytes + 1024;
  static_assert(SEG == 32 || SEG == 64 || SEG == 128, "key rows a stage");
  static_assert(NL >= 1 && NL <= kLimbs, "limbs");
  static_assert(D >= 0 && D <= kMaxKar, "Karatsuba depth");
  static_assert(D == 0 || (SEG == kStageK && NL == kLimbs),
                "leaves of at least 128 coefficients, exact keys");
  static_assert(kSmem <= kMaxSmem, "shared memory of one block");
};

// 16-byte copy to shared memory; src_bytes = 0 fills the 16 bytes with zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// The rotated row less itself and offset, at quad q (coefficients 4q ..
// 4q+3) of a row of N = 4 (qmask + 1) words held in shared memory (s4):
// temp[e] = (acc * X^abar)[4q + e] - acc[4q + e] + off. The rotated window
// of quad q starts at word (4q - low) mod N: aligned quad (q - qlow) mod
// N/4 shifted by sh = (-low) mod 4 words; hi and low are abar's sign bit
// and its rest.
__device__ __forceinline__ void rot_quad(const uint4* s4, int q, int qlow,
                                         int qmask, int sh, uint32_t low,
                                         bool hi, uint32_t off,
                                         uint32_t (&temp)[4]) {
  const uint4 own = s4[q];
  const int a = (q - qlow) & qmask;
  const uint4 w0 = s4[a];
  const uint4 w1 = s4[(a + 1) & qmask];
  const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  uint32_t v[6];
#pragma unroll
  for (int e = 0; e < 6; ++e) v[e] = (sh & 1) ? w[e + 1] : w[e];
  const uint32_t mine[4] = {own.x, own.y, own.z, own.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t x = (sh & 2) ? v[e + 2] : v[e];
    const bool neg = (static_cast<uint32_t>(4 * q + e) < low) != hi;
    temp[e] = (neg ? 0u - x : x) - mine[e] + off;
  }
}

// Four int8 values in one word, the first in the low byte.
__device__ __forceinline__ uint32_t pack4(const int (&part)[4]) {
  const uint32_t lo = __byte_perm(part[0], part[1], 0x0040);
  const uint32_t up = __byte_perm(part[2], part[3], 0x0040);
  return __byte_perm(lo, up, 0x5410);
}

// The Karatsuba leaf operands of a depth-D tree from the packed digits of
// the 2^D quarters p[0 .. 2^D) of a row, in leaf order (the first level's
// A, T01 - A, T10 - A, each over the next level's): A takes the sum of the
// two halves, T01 - A the second half, T10 - A the first. Byte-wise adds
// that wrap: each sum fits int8 where |digit| << D <= 128.
template <int D>
struct Leaves {
  static constexpr int kHalf = 1 << (D - 1);
  static constexpr int kSub = pow3(D - 1);
  __device__ __forceinline__ static void run(const uint32_t* p,
                                             uint32_t* w) {
    uint32_t sum[kHalf];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) sum[i] = __vadd4(p[i], p[i + kHalf]);
    Leaves<D - 1>::run(sum, w);
    Leaves<D - 1>::run(p + kHalf, w + kSub);
    Leaves<D - 1>::run(p, w + 2 * kSub);
  }
};

template <>
struct Leaves<0> {
  __device__ __forceinline__ static void run(const uint32_t* p, uint32_t* w) {
    w[0] = p[0];
  }
};

// rotdec's arguments beside its pointers: nrows = B * kp1 rows of N =
// 2^nbit coefficients, 1 << tpr_log threads a row, the decomposition (l,
// Bgbit, nd sub-digits of dbits bits) and its offset.
struct RotArgs {
  int nrows, nbit, tpr_log, kp1, l, Bgbit, nd, dbits;
  uint32_t off;
};

// The kRotThreads threads that run rotdec_rows meet here: rotdec_kernel's
// block, or the persistent kernel's two consumer warpgroups (named barrier
// 1; barrier 0 is the whole block's).
__device__ __forceinline__ void rot_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kRotThreads) : "memory");
}

// dec for one step: the rows (b, j) of acc [B, kp1, N] rotated by
// X^abar_i[b], minus themselves, offset and decomposed: [B, I, N] int8 at
// D = 0; at Karatsuba depth D > 0 the leaf operands [B, 3^D, I, N >> D].
// Block blk of rotdec's grid owns rows blk * rows .. blk * rows + rows-1 of
// the nrows, with rows = kRotThreads >> tpr_log and 1 << tpr_log threads a
// row; its kRotThreads threads (t = 0 ..) hold them in shared memory at
// srow (rows * N * 4 bytes). L and ND are l and nd where they are known at
// compile time (the published sets), 0 where not.
template <int L, int ND, int D>
__device__ __forceinline__ void rotdec_rows(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ abar_i,
    int8_t* __restrict__ dec, const RotArgs& a, int blk, int t,
    uint32_t* srow) {
  constexpr int kLeaves = pow3(D);
  const int l = L ? L : a.l;
  const int nd = ND ? ND : a.nd;
  const int nbit = a.nbit;
  const int tpr_log = a.tpr_log;
  const int N = 1 << nbit;
  const int rows = kRotThreads >> tpr_log;
  const int row0 = blk * rows;
  const int here = min(rows, a.nrows - row0);
  const uint32_t sbase = smem_u32(srow);
  const uint32_t* src = acc + static_cast<size_t>(row0) * N;
  for (int c = t; c < (here << (nbit - 2)); c += kRotThreads)
    cp_async16(sbase + 16 * c, src + 4 * c, 16);
  cp_async_commit();
  const int rr = t >> tpr_log;
  const int row = row0 + rr;
  const int b = row / a.kp1;
  const int j = row - b * a.kp1;
  // read while the copy is in flight
  const uint32_t ab = rr < here ? static_cast<uint32_t>(abar_i[b]) : 0u;
  cp_async_wait<0>();
  rot_sync();
  if (rr >= here) return;

  const int lane = t & ((1 << tpr_log) - 1);
  const int qmask = (N >> 2) - 1;
  const uint32_t mask = (1u << a.Bgbit) - 1u;
  const int half = 1 << (a.Bgbit - 1);
  const int dhalf = 1 << (a.dbits - 1);
  const int dmask = (1 << a.dbits) - 1;
  const uint32_t low = ab & static_cast<uint32_t>(N - 1);
  const bool hi = (ab >> nbit) & 1u;
  const uint4* s4 = reinterpret_cast<const uint4*>(srow + (rr << nbit));
  const int sh = static_cast<int>((0u - low) & 3u);
  const int qlow = static_cast<int>((low + 3u) >> 2);
  // a thread takes quad qq of each of the row's 2^D quarters and writes
  // quad qq of every leaf; leaf v's rows lie I * LN bytes apart (at D = 0
  // the one leaf is the row itself)
  constexpr int kQ = 1 << D;
  const int lq = (qmask + 1) >> D;  // quads of a leaf
  const size_t vstride = static_cast<size_t>(a.kp1) * l * nd * lq;
  uint32_t* out = reinterpret_cast<uint32_t*>(
      dec + (static_cast<size_t>(b) * kLeaves * a.kp1 * l * nd +
             j * l * nd) * (N >> D));
  for (int qq = lane; qq < lq; qq += 1 << tpr_log) {
    uint32_t temp[kQ][4];
#pragma unroll
    for (int k = 0; k < kQ; ++k)
      rot_quad(s4, qq + k * lq, qlow, qmask, sh, low, hi, a.off, temp[k]);
    uint32_t* o = out + qq;
#pragma unroll
    for (int d = 0; d < l; ++d) {
      const int shift = 32 - (d + 1) * a.Bgbit;
      int dig[kQ][4];
#pragma unroll
      for (int k = 0; k < kQ; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dig[k][e] = static_cast<int>((temp[k][e] >> shift) & mask) - half;
#pragma unroll
      for (int dl = 0; dl < nd; ++dl) {
        uint32_t p[kQ];
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          int part[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            part[e] = dig[k][e];  // the last sub-digit takes the rest
            if (dl < nd - 1) {
              part[e] = ((dig[k][e] + dhalf) & dmask) - dhalf;
              dig[k][e] = (dig[k][e] - part[e]) >> a.dbits;
            }
          }
          p[k] = pack4(part);
        }
        uint32_t w[kLeaves];
        Leaves<D>::run(p, w);
#pragma unroll
        for (int v = 0; v < kLeaves; ++v) o[v * vstride] = w[v];
        o += lq;  // the next digit row
      }
    }
  }
}

// One step's rotate-and-decompose: block x runs rotdec_rows' block x.
template <int L, int ND, int D>
__global__ void __launch_bounds__(kRotThreads)
rotdec_kernel(const uint32_t* __restrict__ acc,
              const int32_t* __restrict__ abar_i, int8_t* __restrict__ dec,
              const RotArgs a) {
  extern __shared__ __align__(16) uint32_t srow[];
  rotdec_rows<L, ND, D>(acc, abar_i, dec, a, blockIdx.x, threadIdx.x, srow);
}

using RotdecFn = void (*)(const uint32_t*, const int32_t*, int8_t*,
                          RotArgs);

// rotdec_kernel's launch shape for rows of N = 2^nbit coefficients.
struct RotdecPlan {
  RotdecFn kernel;
  int tpr_log;                                     // log2 threads per row
  int rows;                                        // rows per block
  int smem;                                        // bytes per block
};

template <int D>
RotdecFn rotdec_instance(int l, int nd) {
  return l == 3 && nd == 1   ? rotdec_kernel<3, 1, D>
         : l == 2 && nd == 1 ? rotdec_kernel<2, 1, D>
         : l == 3 && nd == 2 ? rotdec_kernel<3, 2, D>
         : l == 2 && nd == 2 ? rotdec_kernel<2, 2, D>
                             : rotdec_kernel<0, 0, D>;
}

// The plan for N = 2^nbit, (l, nd) and Karatsuba depth D. A thread takes
// 2^D quads a leaf quad, at least kRotQuads in all where the row is long
// enough.
RotdecPlan rotdec_plan(int nbit, int l, int nd, int depth) {
  RotdecPlan plan;
  plan.kernel = depth == 2   ? rotdec_instance<2>(l, nd)
                : depth == 1 ? rotdec_instance<1>(l, nd)
                             : rotdec_instance<0>(l, nd);
  int tpr_log = nbit - 2 - depth;                  // one thread a leaf quad
  while ((1 << tpr_log) > kRotThreads ||
         (tpr_log > 0 && (1 << (nbit - 2 - tpr_log)) < kRotQuads))
    --tpr_log;
  plan.tpr_log = tpr_log;
  plan.rows = kRotThreads >> tpr_log;
  plan.smem = plan.rows * (4 << nbit);
  return plan;
}

// The kernel's shared memory limit raised to the plan's (once per C call,
// not per step).
cudaError_t rotdec_smem(const RotdecPlan& plan) {
  return cudaFuncSetAttribute(
      plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
}

RotArgs rot_args(const RotdecPlan& plan, int B, int nbit, int kp1, int l,
                 int Bgbit, int nd, int dbits, uint32_t off) {
  return RotArgs{B * kp1, nbit, plan.tpr_log, kp1, l, Bgbit, nd, dbits, off};
}

// rotdec's blocks (of plan.rows rows) for B rows of kp1 components.
int rotdec_blocks(const RotdecPlan& plan, int B, int kp1) {
  return (B * kp1 + plan.rows - 1) / plan.rows;
}

// One rotdec_kernel launch (one step) on `s`.
cudaError_t launch_rotdec(const RotdecPlan& plan, const uint32_t* acc,
                          const int32_t* abar_i, int8_t* dec,
                          const RotArgs& a, int blocks, cudaStream_t s) {
  plan.kernel<<<blocks, kRotThreads, plan.smem, s>>>(acc, abar_i, dec, a);
  return cudaGetLastError();
}

// The arguments both entries take: N = 2^nbit with 32 <= N <= 2^kRotMaxNbit
// (a row in shared memory), digits that rotdec_kernel's shifts can cut,
// B within the product's grid and B * I digit rows within int, acc 16-byte
// aligned for cp.async and dec 4-byte aligned for its stores.
bool args_ok(const void* acc, const void* dec, int B, int N, int nbit, int k,
             int l, int Bgbit, int nd, int dbits) {
  return B > 0 && B <= 65535 * kRowTile && nbit >= 5 &&
         nbit <= kRotMaxNbit &&
         N == (1 << nbit) && k >= 1 && l >= 1 && Bgbit >= 1 &&
         Bgbit <= 16 && l * Bgbit <= 32 && nd >= 1 && nd <= 2 &&
         dbits >= 1 && dbits <= 8 &&
         static_cast<long long>(B) * (k + 1) * l * nd <= INT_MAX &&
         reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(dec) % 4 == 0;
}

#define R8(d, i)                                                     \
  "+r"(d[(i) + 0]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]),              \
      "+r"(d[(i) + 3]), "+r"(d[(i) + 4]), "+r"(d[(i) + 5]),          \
      "+r"(d[(i) + 6]), "+r"(d[(i) + 7])

// d += A B over one 32-byte contraction slice: A, 64 outputs, from the
// warpgroup's registers a; B, 64 batch rows, from the shared-memory
// descriptor db.
__device__ __forceinline__ void wgmma_rs(int (&d)[kAcc],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef R8

// Keep a stage's A registers alive and unmoved up to this point: the wgmma
// that reads them runs asynchronously until a wait retires its group.
template <int K, int L>
__device__ __forceinline__ void frag_fence(uint32_t (&f)[K][L][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        asm volatile("" : "+r"(f[k][l][i]) :: "memory");
}

__device__ __forceinline__ void red_add(uint32_t* p, uint32_t v) {
  asm volatile("red.global.add.u32 [%0], %1;\n" :: "l"(p), "r"(v)
               : "memory");
}

// One step of the product in extprod_kernel's terms: B rows of kp1
// components of N coefficients, LN = N >> D a leaf, KB = I * LN
// contraction bytes a leaf, S = ceil(KB / 128) stages a leaf and T =
// 3^D * S a step.
struct ExtStep {
  int B, N, kp1, LN, KB, S, T;
};

template <int D>
__device__ __forceinline__ ExtStep ext_step(int B, int N, int kp1, int I) {
  ExtStep st;
  st.B = B;
  st.N = N;
  st.kp1 = kp1;
  st.LN = N >> D;                                  // coefficients a leaf
  st.KB = I * st.LN;                               // contraction bytes a leaf
  st.S = (st.KB + kStageK - 1) / kStageK;          // stages a leaf
  st.T = st.S * pow3(D);
  return st;
}

// One work item of a step: tile (x, y), i.e. leaf outputs go = o*LN + c in
// [go0, go0 + 128) and batch rows [b0, b0 + 64), over stages [s0, s1) of
// the step's T; its 32-output groups and its runs of SEG outputs that
// exist (group 2*warpgroup + hi, see the consumer).
struct ExtItem {
  int go0, b0, s0, s1, groups, runs;
};

template <int SEG>
__device__ __forceinline__ ExtItem ext_item(const ExtStep& st, int x, int y,
                                            int s0, int s1) {
  ExtItem it;
  it.go0 = x * kOutTile;
  it.b0 = y * kRowTile;
  it.s0 = s0;
  it.s1 = s1;
  it.groups = min(kOutTile / kGroup, (st.kp1 * st.LN - it.go0) / kGroup);
  it.runs = min(kOutTile / SEG, (st.kp1 * st.LN - it.go0) / SEG);
  return it;
}

// Where a row-tile group's units (tile-major stages) are cut between its
// blocks b - 1 and b of `size`: at b/size of them, moved to the nearest end
// of a leaf (S stages) within kShareSnap stages, as a range that cuts a
// leaf folds it twice (about two stages each, as timed on an H100:
// PERF.md). Non-decreasing in b.
__device__ __forceinline__ int share_cut(int units, int S, int b, int size) {
  const int u = static_cast<int>(static_cast<long long>(units) * b / size);
  const int r = u % S;
  return r <= kShareSnap ? u - r : S - r <= kShareSnap ? u + S - r : u;
}

// This block's row-tile group in the persistent kernel (the file's note):
// group g of n = min(ny, gridDim.x), its blocks first .. first + size - 1
// (rank: this block's place among them) and its row tiles [y0, y1). The
// same in every step: one thread writes it to shared memory once, and both
// roles read it there where they use it: the consumers' product sums
// fill their registers, and ptxas spilled them with the group held in
// registers besides.
struct TileGroup {
  int g, rank, size, y0, y1;
};

__device__ __forceinline__ TileGroup tile_group(int ny) {
  const int G = gridDim.x, b = blockIdx.x;
  const int n = min(ny, G);
  TileGroup tg;
  tg.g = ((b + 1) * n - 1) / G;
  const int first = tg.g * G / n;
  tg.rank = b - first;
  tg.size = (tg.g + 1) * G / n - first;
  tg.y0 = tg.g * ny / n;
  tg.y1 = (tg.g + 1) * ny / n;
  return tg;
}

// The items of a step's product that this block takes in the persistent
// kernel: its group's nx * (y1 - y0) tiles x T stages, tile-major, cut
// into one share of stages a block of the group, equal but for share_cut's
// snap; the share's part of each tile it meets is one item, a range of
// that tile's stages (it may cut a leaf: the consumer folds at every
// leaf's end and at the range's). fn(item) for each, in order. Every block
// of a group does about the same work, where extprod_plan's ranges leave
// some blocks one more item than others.
template <int SEG, typename Fn>
__device__ __forceinline__ void for_share(const ExtStep& st, int nx,
                                          const TileGroup& tg, Fn&& fn) {
  const int y0 = tg.y0;
  const int units = nx * (tg.y1 - y0) * st.T;
  const int u1 = share_cut(units, st.S, tg.rank + 1, tg.size);
  for (int u = share_cut(units, st.S, tg.rank, tg.size); u < u1;) {
    const int tile = u / st.T;
    const int t0 = tile * st.T;
    const int s1 = min(st.T, u1 - t0);
    fn(ext_item<SEG>(st, tile % nx, y0 + tile / nx, u - t0, s1));
    u = t0 + s1;
  }
}

// A position in the ring: its slot and the parity its barrier waits for.
struct Ring {
  int slot;
  uint32_t parity;
  __device__ __forceinline__ void next() {
    if (++slot == kStages) {
      slot = 0;
      parity ^= 1;
    }
  }
};

// The ring's barriers: full i (one arrival, the producer's, and the
// stage's bytes) at full0 + 8i, empty i (one arrival a consumer warp) at
// empty0 + 8i. Thread 0 inits them; the block waits.
__device__ __forceinline__ void ring_init(uint32_t full0, uint32_t empty0) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 4 * kConsumers);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp's part of one item (lane: the lane in the warp): the
// dec tile by TMA, the key windows by bulk copies, stage by stage into the
// ring, from ring position pos on.
template <int NL, int SEG, int D>
__device__ __forceinline__ void ext_produce(
    const CUtensorMap* tma_dec, const int8_t* __restrict__ bk_i,
    uint32_t base, uint32_t full0, uint32_t empty0, int lane,
    const ExtStep& st, const ExtItem& it, Ring& pos) {
  using E = Ext<NL, SEG, D>;
  const int LN = st.LN, kp1 = st.kp1;
  for (int s = it.s0; s < it.s1; ++s) {
    const uint32_t sa = base + pos.slot * E::kStageBytes;
    const uint32_t full = full0 + 8 * pos.slot;
    const int v = D > 0 ? s / st.S : 0;            // the stage's leaf
    const int sv = s - v * st.S;                   // its stage in the leaf
    // key rows of the stage inside the contraction
    const int segs =
        min(E::kSegs, (st.KB - sv * kStageK + SEG - 1) / SEG);
    mbar_wait(empty0 + 8 * pos.slot, pos.parity);
    if (lane == 0) {
      mbar_arrive_tx(full, kBTile + segs * it.runs * NL * E::kWin);
      tma_load(sa, tma_dec, full, s * kStageK, it.b0);
    }
    __syncwarp();
    for (int wi = lane; wi < E::kWins; wi += 32) {
      const int li = wi % NL;
      const int run = wi / NL % E::kRuns;
      const int seg = wi / NL / E::kRuns;
      if (seg >= segs || run >= it.runs) continue;
      const int p = sv * kStageK + seg * SEG;
      const int r = p / LN;
      const int t0 = p - r * LN;
      const int go = it.go0 + SEG * run;
      const int o = go / LN;
      const int c0 = go - o * LN;
      const int8_t* src =
          bk_i +
          ((static_cast<size_t>(r) * kp1 + o) * NL + li) * E::kLeaves *
              2 * LN +
          2 * LN * v + (LN + c0 - t0 - SEG);
      bulk_load(sa + kBTile + wi * E::kWinStride, src, E::kWin, full);
    }
    pos.next();
  }
}

// A consumer warpgroup's part of one item (tid: the thread in the block,
// warpgroup tid / 128: outputs go0 + 64 wg .. + 63, NL limbs): each stage's
// A registers from the key windows, its wgmma, and at the end acc += the
// sums with red.global.add, from ring position pos on. quarters: the block's
// quarter sums at D > 0 (each thread its own words).
template <int NL, int SEG, int D>
__device__ __forceinline__ void ext_consume(
    uint32_t* __restrict__ acc, const uint8_t* ring, uint32_t base,
    uint32_t full0, uint32_t empty0, uint4* quarters, int tid,
    const ExtStep& st, const ExtItem& it, Ring& pos) {
  using E = Ext<NL, SEG, D>;
  const int wg = tid / 128;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  const bool lo_ok = 2 * wg < it.groups;          // outputs past (k+1)N
  const bool hi_ok = 2 * wg + 1 < it.groups;      // have zero fragments
  // Register 2*h2 + hi of lane (g, q) at k-step kq of a key row holds
  // output u = 32*hi + 8*warp + g of the warpgroup's 64 and contraction
  // bytes k = 32kq + 16h2 + 4q + e (e = 0..3) of the row's SEG: bytes
  // x = u' - k + SEG of the window of u's run, u' = u's place in the run,
  // i.e. bytes xa+3 .. xa with xa = 4m + sh, sh = (g + 1) mod 4 and m =
  // at[hi] - 8kq - 4h2 (at[hi]: the word of h2 = kq = 0 in the window of
  // limb 0 and the stage's first key row); __byte_perm of words m and
  // m+1 with selector sel puts them in order.
  const int sh = (g + 1) & 3;
  const uint32_t sel = (sh + 3) | ((sh + 2) << 4) | ((sh + 1) << 8) |
                       (sh << 12);
  const int m0 = 2 * warp + SEG / 4 - q + ((g + 1) >> 2) - 1;
  constexpr int kW = E::kWinStride / 4;            // words a window
  int at[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int u0 = kWgOut * wg + kGroup * hi;      // in the block's 128
    at[hi] = u0 / SEG * NL * kW + u0 % SEG / 4 + m0;
  }
  int sums[NL][kAcc];
#pragma unroll
  for (int li = 0; li < NL; ++li) {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) sums[li][e] = 0;
    reg_fence(sums[li]);
  }
  uint32_t frag[kStageK / 32][NL][4];
  // D > 0: the uint32 sums of the thread's outputs in each quarter, four
  // a 16-byte word, at [qd][e / 4][tid] (consecutive threads,
  // consecutive words), and the quarters the range has written (the
  // same for every thread)
  constexpr int kQStride = 128 * kConsumers;
  uint32_t touched = 0;
  for (int s = it.s0; s < it.s1; ++s) {
    mbar_wait(full0 + 8 * pos.slot, pos.parity);
    const uint32_t* win = reinterpret_cast<const uint32_t*>(
        ring + pos.slot * E::kStageBytes + kBTile);
    const uint64_t db = smem_desc(base + pos.slot * E::kStageBytes);
#pragma unroll
    for (int kk = 0; kk < kStageK / 32; ++kk) {
      const int seg = kk / E::kSegSteps;
      const int kq = kk % E::kSegSteps;
#pragma unroll
      for (int li = 0; li < NL; ++li) {
        uint32_t (&f)[4] = frag[kk][li];
        const uint32_t* w =
            win + (seg * E::kRuns * NL + li) * kW - 8 * kq;
        const uint32_t* wl = w + at[0];
        f[0] = lo_ok ? __byte_perm(wl[0], wl[1], sel) : 0u;
        f[2] = lo_ok ? __byte_perm(wl[-4], wl[-3], sel) : 0u;
        if (kq > 0) {       // outputs c + 32 at kk are outputs c at kk-1
          f[1] = frag[kk > 0 ? kk - 1 : 0][li][0];
          f[3] = frag[kk > 0 ? kk - 1 : 0][li][2];
        } else {
          const uint32_t* wh = w + at[1];
          f[1] = hi_ok ? __byte_perm(wh[0], wh[1], sel) : 0u;
          f[3] = hi_ok ? __byte_perm(wh[-4], wh[-3], sel) : 0u;
        }
      }
    }
    // one group a stage: the fence, commit and wait are paid once for
    // NL * 4 wgmma
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStageK / 32; ++kk) {
#pragma unroll
      for (int li = 0; li < NL; ++li)
        wgmma_rs(sums[li], frag[kk][li], db + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    frag_fence(frag);
    if (lane == 0) mbar_arrive(empty0 + 8 * pos.slot);   // the slot is free
    pos.next();
    if constexpr (D > 0) {
      if (s + 1 == it.s1 || (s + 1) % st.S == 0) {  // the leaf's last stage
#pragma unroll
        for (int li = 0; li < NL; ++li) reg_fence(sums[li]);
        const uint32_t feeds = leaf_quarters(s / st.S, D);
        uint4 u[kAcc / 4];
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          uint32_t w[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            w[x] = 0;
#pragma unroll
            for (int li = 0; li < NL; ++li) {
              w[x] += static_cast<uint32_t>(sums[li][4 * j + x])
                      << (kLimbBits * (li + kLimbs - NL));
              sums[li][4 * j + x] = 0;
            }
          }
          u[j] = make_uint4(w[0], w[1], w[2], w[3]);
        }
#pragma unroll
        for (int qd = 0; qd < E::kQuarters; ++qd) {
          if (!((feeds >> qd) & 1u)) continue;
          uint4* qs = quarters + qd * (kAcc / 4) * kQStride + tid;
          if ((touched >> qd) & 1u) {
#pragma unroll
            for (int j = 0; j < kAcc / 4; ++j) {
              const uint4 o = qs[j * kQStride];
              qs[j * kQStride] = make_uint4(o.x + u[j].x, o.y + u[j].y,
                                            o.z + u[j].z, o.w + u[j].w);
            }
          } else {
#pragma unroll
            for (int j = 0; j < kAcc / 4; ++j) qs[j * kQStride] = u[j];
          }
        }
        touched |= feeds;
#pragma unroll
        for (int li = 0; li < NL; ++li) reg_fence(sums[li]);
      }
    }
  }
#pragma unroll
  for (int li = 0; li < NL; ++li) reg_fence(sums[li]);

  const int N = st.N, LN = st.LN;
  const size_t row_stride = static_cast<size_t>(st.kp1) * N;
  if constexpr (D > 0) {
    // every quarter the range touched, added to acc once an output:
    // element 2hi + x of quarters[qd][j] of this thread is output
    // (o, qd*LN + c) with o*LN + c = go below, batch row b0 + 8j + 2q + x
#pragma unroll
    for (int qd = 0; qd < E::kQuarters; ++qd) {
      if (!((touched >> qd) & 1u)) continue;
      const uint4* qs = quarters + qd * (kAcc / 4) * kQStride + tid;
      uint32_t* out[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int go = it.go0 + kWgOut * wg + kGroup * hi + 8 * warp + g;
        const int o = go / LN;
        out[hi] = acc + static_cast<size_t>(o) * N + qd * LN + (go - o * LN);
      }
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
        const uint4 w = qs[j * kQStride];
        const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int hx = 0; hx < 4; ++hx) {
          const int b = it.b0 + 8 * j + 2 * q + (hx & 1);
          if (b >= st.B) continue;
          red_add(out[hx >> 1] + b * row_stride, v[hx]);
        }
      }
    }
  } else {
    // sums[li][4j + 2hi + x]: output 32*hi + 8*warp + g of the
    // warpgroup's 64, batch row b0 + 8j + 2q + x
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      if (!(hi ? hi_ok : lo_ok)) continue;
      const int go = it.go0 + kWgOut * wg + kGroup * hi + 8 * warp + g;
      const int o = go / N;
      uint32_t* out = acc + static_cast<size_t>(o) * N + (go - o * N);
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int b = it.b0 + 8 * j + 2 * q + x;
          if (b >= st.B) continue;
          uint32_t v = 0;
#pragma unroll
          for (int li = 0; li < NL; ++li)
            v += static_cast<uint32_t>(sums[li][4 * j + 2 * hi + x])
                 << (kLimbBits * (li + kLimbs - NL));
          red_add(out + b * row_stride, v);
        }
      }
    }
  }
}

// acc [B, kp1, N] += the external product of dec (the tensor map tma_dec)
// with the key of one step, bk_i, whose limb li is worth 2^(8(li + 4 -
// NL)). At D = 0, dec is [B, I*N] and bk_i [I, kp1, NL, 2N]; at Karatsuba
// depth D, LN = N >> D, dec is [B, 3^D * I*LN] (leaf-major) and bk_i
// [I, kp1, NL, 3^D * 2LN]. Block (x, y, z) is the item of tile (x, y) over
// range z of the gridDim.z ranges of the step's T stages, [zT/Z,
// (z+1)T/Z). Threads 0-255 are the consumer warpgroups, 256-383 the
// producer warpgroup, of which one warp issues the copies.
template <int NL, int SEG, int D>
__global__ void __launch_bounds__(kExtThreads, 1)
extprod_kernel(const __grid_constant__ CUtensorMap tma_dec,
               uint32_t* __restrict__ acc, const int8_t* __restrict__ bk_i,
               int B, int N, int kp1, int I) {
  using E = Ext<NL, SEG, D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* ring = smem_raw + (base - raw);
  const uint32_t full0 = base + E::kRing;          // full barrier i: +8i
  const uint32_t empty0 = full0 + 8 * kStages;
  const int tid = threadIdx.x;
  const ExtStep st = ext_step<D>(B, N, kp1, I);
  const ExtItem it = ext_item<SEG>(
      st, blockIdx.x, blockIdx.y,
      static_cast<int>(static_cast<long long>(blockIdx.z) * st.T / gridDim.z),
      static_cast<int>(static_cast<long long>(blockIdx.z + 1) * st.T /
                       gridDim.z));
  ring_init(full0, empty0);

  if (tid / 128 == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid - 128 * kConsumers < 32) {
      Ring r{0, 1};                                // the ring starts empty
      ext_produce<NL, SEG, D>(&tma_dec, bk_i, base, full0, empty0, tid & 31,
                              st, it, r);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    Ring r{0, 0};
    ext_consume<NL, SEG, D>(
        acc, ring, base, full0, empty0,
        reinterpret_cast<uint4*>(smem_raw + (base - raw) + E::kRing +
                                 16 * kStages),
        tid, st, it, r);
  }
}

// The blocks of a row-tile group wait here until all `size` have arrived
// `target` times in all (size a barrier) on the group's counter: the
// block's threads meet, thread 0 adds its arrival with release and polls
// the count with acquire, both at gpu scope, and the block meets again.
// What any thread of the group wrote before the barrier is visible to every
// thread of it after. A group whose blocks cannot all meet (a fault: the
// launch is cooperative) traps after 2^26 polls, tens of seconds, rather
// than hang the card.
__device__ __forceinline__ void group_sync(unsigned int* count,
                                           unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                 :: "l"(count) : "memory");
    unsigned int seen, polls = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(count) : "memory");
      if (++polls == (1u << 26)) __trap();
    } while (seen < target);
  }
  __syncthreads();
}

// Order this thread's generic-proxy accesses to global memory before its
// later async-proxy ones (and those that other threads order after it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The persistent kernel's arguments beside its pointers: rotdec's, the
// product's shape, the steps, and the key's bytes a step.
struct PersistArgs {
  RotArgs rot;
  int B, N, kp1, I, n0, key_step;
};

// The whole rotation in one cooperative launch: each row-tile group
// (tile_group) walks the n0 steps, each its rotdec blocks strided by the
// group's size, then the block's share of the group's product (for_share),
// separated by group_sync (the file's note).
// arrivals: zeroed counters, kArrivalStride words apart, one a group, 2 n0
// arrivals of each of its blocks in all. acc, dec, tma_dec and the key's
// layout are cufhe_blind_rotate's; abar is [n0, B].
template <int NL, int SEG, int D, int L, int ND>
__global__ void __launch_bounds__(kExtThreads, 1)
persistent_extprod_kernel(const __grid_constant__ CUtensorMap tma_dec,
                          uint32_t* __restrict__ acc,
                          const int32_t* __restrict__ abar,
                          const int8_t* __restrict__ key,
                          int8_t* __restrict__ dec,
                          unsigned int* __restrict__ arrivals,
                          const PersistArgs a) {
  using E = Ext<NL, SEG, D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* ring = smem_raw + (base - raw);
  const uint32_t full0 = base + E::kRing;
  const uint32_t empty0 = full0 + 8 * kStages;
  // the quarters in phase 2, rotdec's rows in phase 1
  uint8_t* spare = smem_raw + (base - raw) + E::kRing + 16 * kStages;
  const int tid = threadIdx.x;
  const ExtStep st = ext_step<D>(a.B, a.N, a.kp1, a.I);
  const int nx = (st.kp1 * st.LN + kOutTile - 1) / kOutTile;
  const int ny = (st.B + kRowTile - 1) / kRowTile;
  __shared__ TileGroup tg;
  if (tid == 0) tg = tile_group(ny);
  ring_init(full0, empty0);                        // the block meets

  if (tid / 128 == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const bool issues = tid - 128 * kConsumers < 32;
    Ring r{0, 1};                                  // the ring starts empty
    for (int i = 0; i < a.n0; ++i) {
      const int8_t* bk_i = key + static_cast<size_t>(i) * a.key_step;
      if (tid == 128 * kConsumers) {
        // the block's share of the step's key, into L2 while rotdec runs
        const int share = (a.key_step / gridDim.x + 16) / 16 * 16;
        const int from = share * blockIdx.x;
        if (from < a.key_step)
          asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                       :: "l"(bk_i + from),
                          "r"(static_cast<uint32_t>(
                              min(share, a.key_step - from)))
                       : "memory");
      }
      group_sync(arrivals + tg.g * kArrivalStride, tg.size * (2 * i + 1));
      if (issues) {
        fence_proxy_async();                       // dec, now by TMA
        for_share<SEG>(st, nx, tg, [&](const ExtItem& it) {
          ext_produce<NL, SEG, D>(&tma_dec, bk_i, base, full0, empty0,
                                  tid & 31, st, it, r);
        });
      }
      group_sync(arrivals + tg.g * kArrivalStride, tg.size * (2 * i + 2));
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    Ring r{0, 0};
    for (int i = 0; i < a.n0; ++i) {
      // rotdec on the group's batch rows alone, from b0 on: the pointers
      // moved to b0, in blocks of kRotThreads >> tpr_log rows (b, j)
      const int b0 = tg.y0 * kRowTile;
      RotArgs ra = a.rot;
      ra.nrows = (min(st.B, tg.y1 * kRowTile) - b0) * st.kp1;
      const int rows = kRotThreads >> ra.tpr_log;
      for (int blk = tg.rank; blk < (ra.nrows + rows - 1) / rows;
           blk += tg.size) {
        rotdec_rows<L, ND, D>(
            acc + static_cast<size_t>(b0) * st.kp1 * st.N,
            abar + static_cast<size_t>(i) * a.B + b0,
            dec + static_cast<size_t>(b0) * E::kLeaves * st.KB, ra, blk, tid,
            reinterpret_cast<uint32_t*>(spare));
        rot_sync();                  // the rows are read: the next may land
      }
      fence_proxy_async();           // dec's stores before the TMA reads
      group_sync(arrivals + tg.g * kArrivalStride, tg.size * (2 * i + 1));
      for_share<SEG>(st, nx, tg, [&](const ExtItem& it) {
        ext_consume<NL, SEG, D>(acc, ring, base, full0, empty0,
                                reinterpret_cast<uint4*>(spare), tid, st, it,
                                r);
      });
      group_sync(arrivals + tg.g * kArrivalStride, tg.size * (2 * i + 2));
    }
  }
}

using PersistFn = cudaError_t (*)(const CUtensorMap&, uint32_t*,
                                  const int32_t*, const int8_t*, int8_t*,
                                  unsigned int*, const PersistArgs&, int,
                                  int, cudaStream_t);

// One cooperative launch of the persistent kernel: `grid` blocks, `smem`
// bytes of shared memory each.
template <int NL, int SEG, int D, int L, int ND>
cudaError_t launch_persistent(const CUtensorMap& map, uint32_t* acc,
                              const int32_t* abar, const int8_t* key,
                              int8_t* dec, unsigned int* arrivals,
                              const PersistArgs& a, int grid, int smem,
                              cudaStream_t s) {
  const auto kernel = persistent_extprod_kernel<NL, SEG, D, L, ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap m = map;
  PersistArgs pa = a;
  void* args[] = {&m, &acc, &abar, &key, &dec, &arrivals, &pa};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(grid), dim3(kExtThreads), args,
                                     smem, s);
}

// The persistent instance for (l, nd): rotdec's digit loops unrolled at
// the two published sets that take this path in their cells (tfhepp_128bit:
// l 3, nd 1, depth 2; concrete: l 2, nd 1, depth 0), generic elsewhere.
template <int NL, int SEG, int D>
PersistFn persistent_instance(int l, int nd) {
  if constexpr (NL == kLimbs && SEG == kStageK && D == 2) {
    if (l == 3 && nd == 1) return launch_persistent<NL, SEG, D, 3, 1>;
  }
  if constexpr (NL == kLimbs && SEG == kStageK && D == 0) {
    if (l == 2 && nd == 1) return launch_persistent<NL, SEG, D, 2, 1>;
  }
  return launch_persistent<NL, SEG, D, 0, 0>;
}

// The n0 steps of one rotation through extprod_kernel<NL, SEG, D>, its
// contraction cut into `split` ranges: 2 n0 launches of rotdec_kernel and
// extprod_kernel where grid is 0, else one cooperative launch of grid
// blocks of persistent_extprod_kernel, whose row-tile groups count their
// barriers in arrivals (zeroed).
template <int NL, int SEG, int D>
cudaError_t rotate(uint32_t* acc, const int32_t* abar, const int8_t* key,
                   int8_t* dec, int B, int n0, int N, int nbit, int kp1,
                   int l, int Bgbit, int nd, int dbits, uint32_t off,
                   int split, int grid, unsigned int* arrivals,
                   cudaStream_t s) {
  using E = Ext<NL, SEG, D>;
  const RotdecPlan plan = rotdec_plan(nbit, l, nd, D);
  const RotArgs ra = rot_args(plan, B, nbit, kp1, l, Bgbit, nd, dbits, off);
  const int rot_blocks = rotdec_blocks(plan, B, kp1);
  const int I = kp1 * l * nd;
  const int LN = N >> D;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;                     // dec is the same buffer every step
  if (!encode_rows(fn, &map, dec, B, E::kLeaves * I * LN, kRowTile))
    return cudaErrorInvalidValue;
  const size_t key_step =
      static_cast<size_t>(I) * kp1 * NL * E::kLeaves * 2 * LN;
  if (grid > 0) {
    if (key_step > INT_MAX) return cudaErrorInvalidValue;
    // the ring, its barriers, then the quarters or rotdec's rows; the
    // row-tile group in static shared memory beside them
    const int smem = E::kRing + 16 * kStages +
                     std::max(E::kQBytes, plan.smem) + 1024;
    if (smem + static_cast<int>(sizeof(TileGroup)) > kMaxSmem)
      return cudaErrorInvalidValue;
    const PersistArgs pa{ra, B, N, kp1, I, n0, static_cast<int>(key_step)};
    return persistent_instance<NL, SEG, D>(l, nd)(
        map, acc, abar, key, dec, arrivals, pa, grid, smem, s);
  }
  cudaError_t err = cudaFuncSetAttribute(
      extprod_kernel<NL, SEG, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, E::kSmem);
  if (err == cudaSuccess) err = rotdec_smem(plan);
  if (err != cudaSuccess) return err;
  const dim3 ext_grid((kp1 * LN + kOutTile - 1) / kOutTile,
                      (B + kRowTile - 1) / kRowTile, split);
  for (int i = 0; i < n0; ++i) {
    err = launch_rotdec(plan, acc, abar + static_cast<size_t>(i) * B, dec,
                        ra, rot_blocks, s);
    if (err != cudaSuccess) return err;
    extprod_kernel<NL, SEG, D><<<ext_grid, kExtThreads, E::kSmem, s>>>(
        map, acc, key + i * key_step, B, N, kp1, I);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

using RotateFn = cudaError_t (*)(uint32_t*, const int32_t*, const int8_t*,
                                 int8_t*, int, int, int, int, int, int, int,
                                 int, int, uint32_t, int, int, unsigned int*,
                                 cudaStream_t);

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether Karatsuba depth `depth` is exact for the set: 0 always; 1 or 2
// with the exact key, leaves of at least kMinLeaf coefficients and leaf
// operands, sums of 2^depth sub-digits of at most 2^(dbits-1), that fit
// int8 (pallas_br.py:kar_depth's rule and its kernel's assertion).
bool depth_ok(int depth, int nbit, int Bgbit, int dbits, int nlimbs) {
  if (depth == 0) return true;
  return depth >= 1 && depth <= kMaxKar && nlimbs == kLimbs &&
         (1 << (nbit - depth)) >= kMinLeaf &&
         ((1 << ((Bgbit < dbits ? Bgbit : dbits) - 1)) << depth) <= 128;
}

}  // namespace

// One blind rotation of B accumulators, in place. acc [B, k+1, N] and
// abar [n0, B] are int32 (torus values as uint32 bits); at Karatsuba
// depth D (`depth`, 0, 1 or 2) with LN = N >> D, bk_ext is
// [n0, I, k+1, nlimbs, 3^D * 2LN] int8 with I = (k+1)*l*nd and dec is
// scratch of B * 3^D * I * LN bytes (bk_ext and dec 16-byte aligned).
// nlimbs is 4 (the exact key) or 3 (pallas3, N >= 128, D = 0); the
// product's instance follows from nlimbs, N and D. split, 1 <= split <=
// 3^D * ceil(I*LN / 128), is the number of contraction ranges,
// ops/blind_rotate.py:extprod_plan's choice. grid 0 enqueues the 2*n0
// kernels of the loop on `stream`; grid > 0 one cooperative launch of grid
// blocks (at most one an SM) of the persistent kernel, whose row-tile
// groups count their barriers in `arrivals`: min(ceil(B / 64), grid)
// zeroed 4-byte counters, kArrivalStride words apart
// (ops/blind_rotate.py:rotation_plan chooses). Returns the first launch
// error as a cudaError_t value (0 on success); it does not wait.
// Another nlimbs, a three-limb key at N < 128, a depth depth_ok refuses,
// sets whose limb sums could leave int32 (I*N*2^(dbits-1)*128 >= 2^31),
// N < 32, N > 2^kRotMaxNbit, another split, a negative grid, a grid
// without its counter and the other arguments args_ok refuses are
// refused with cudaErrorInvalidValue.
extern "C" int cufhe_blind_rotate(void* acc, const void* abar,
                                  const void* bk_ext, void* dec, int B,
                                  int n0, int N, int nbit, int k, int l,
                                  int Bgbit, int nd, int dbits, int nlimbs,
                                  int depth, unsigned int off_const,
                                  int split, int grid, void* arrivals,
                                  void* stream) {
  if (n0 < 0 || !args_ok(acc, dec, B, N, nbit, k, l, Bgbit, nd, dbits) ||
      !depth_ok(depth, nbit, Bgbit, dbits, nlimbs))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp1 = k + 1;
  const long long I = static_cast<long long>(kp1) * l * nd;
  // a leaf's operand is 2^depth times larger and LN = N >> depth long
  if (I * N * (1LL << (dbits - 1)) * 128 >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long stages =
      pow3(depth) * ((I * (N >> depth) + kStageK - 1) / kStageK);
  if (split < 1 || split > stages || split > 65535 || !aligned16(dec) ||
      !aligned16(bk_ext) || grid < 0 ||
      (grid > 0 && (arrivals == nullptr ||
                    reinterpret_cast<uintptr_t>(arrivals) % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* acc_u = static_cast<uint32_t*>(acc);
  const auto* abar_i = static_cast<const int32_t*>(abar);
  const auto* key = static_cast<const int8_t*>(bk_ext);
  auto* dec_i8 = static_cast<int8_t*>(dec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RotateFn run = nullptr;
  if (nlimbs == 4 && depth > 0)
    run = depth == 2 ? rotate<4, 128, 2> : rotate<4, 128, 1>;
  else if (nlimbs == 4)
    run = N >= 128  ? rotate<4, 128, 0>
          : N == 64 ? rotate<4, 64, 0>
                    : rotate<4, 32, 0>;
  else if (nlimbs == 3 && N >= 128)
    run = rotate<3, 128, 0>;
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(acc_u, abar_i, key, dec_i8, B, n0, N, nbit,
                              kp1, l, Bgbit, nd, dbits, off_const, split,
                              grid, static_cast<unsigned int*>(arrivals),
                              s));
}

// One step's rotate-and-decompose alone: dec [B, I, N] int8 at depth 0,
// the leaf operands [B, 3^D, I, N >> D] at Karatsuba depth D, from acc
// [B, k+1, N] and abar_i [B] int32, through the kernel cufhe_blind_rotate
// launches once per step. Enqueues one kernel on `stream`; returns the
// launch error (0 on success), cudaErrorInvalidValue for what args_ok or
// depth_ok refuses.
extern "C" int cufhe_rotdec(const void* acc, const void* abar_i, void* dec,
                            int B, int N, int nbit, int k, int l, int Bgbit,
                            int nd, int dbits, int depth,
                            unsigned int off_const, void* stream) {
  if (!args_ok(acc, dec, B, N, nbit, k, l, Bgbit, nd, dbits) ||
      !depth_ok(depth, nbit, Bgbit, dbits, kLimbs))
    return static_cast<int>(cudaErrorInvalidValue);
  const RotdecPlan plan = rotdec_plan(nbit, l, nd, depth);
  cudaError_t err = rotdec_smem(plan);
  if (err == cudaSuccess)
    err = launch_rotdec(
        plan, static_cast<const uint32_t*>(acc),
        static_cast<const int32_t*>(abar_i), static_cast<int8_t*>(dec),
        rot_args(plan, B, nbit, k + 1, l, Bgbit, nd, dbits, off_const),
        rotdec_blocks(plan, B, k + 1), static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

extern "C" const char* cufhe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
