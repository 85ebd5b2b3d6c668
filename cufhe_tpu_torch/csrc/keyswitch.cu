// Identity key switch of TFHE gate bootstrapping for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the key switch to XLA
// (cufhe_tpu/ops/keyswitch.py, a one-hot x KSK matmul), and the port ran
// the same one-hot product through four torch._int_mm calls until its H100
// measurements put the key switch on AES's critical path (PERF.md). It
// computes ops/keyswitch.py:key_switch_ref bit for bit:
//
//   out[b, c] = [c == n0] * bin[b] + sum_K coef[b, K] * KSK[K, c]  mod 2^32
//
// over B rows, c <= n0. For each input coefficient j < d1 and digit dig < t
// of tmp = a[b, j] + off, the field f = (tmp >> (32 - (dig+1) * basebit))
// & (2^basebit - 1) gives the digit val = f - nb (nb = 2^(basebit-1), the
// KSK rows a digit has); coef is +1 at row m = -val-1 and -1 at m = val-1,
// else 0, so each digit selects one KSK row with its sign. The KSK is held
// as four balanced int8 limbs (KSK = sum_l limb_l << 8l mod 2^32), so the
// product is four exact int8 x int8 -> int32 products (|sums| <= 128 d1 t).
//
// What bounds it on an H100: at AES's row counts (48-480 rows a step), the
// KSK's bytes. At tfhepp_128bit the four limbs are 4 x 16,384 x 637 B =
// 41.7 MB, 12.5 us at 3.35 TB/s, against 6.8 us of int8 work at 160 rows.
// At 4096 rows the int8 work: 0.17 ms at 1,979 TOPS. The library path
// (a one-hot operand of about 120 small launches, four padded KSK copies,
// four CUTLASS sm80 GEMMs of batch-as-M tiles on a few of the 132 SMs)
// ran 2.2 ms a call at 160 rows.
//
// What this kernel does about it, in one launch a key switch:
//  - The transposed product on wgmma m64nNTk32 s8, both operands in shared
//    memory: M is 64 output columns, N the batch rows (NT = 64 or 128 a
//    block), K the contraction. A batch of 160 rows fills N, where a
//    batch-as-M tile of a library GEMM leaves most of it empty.
//  - A, the KSK, is read once from device memory in the kernel's layout
//    (ops/keyswitch.py:ksk_tiles, built once with the key): [Mt, S, 4, 64,
//    128] int8, column tile x stage x limb x column x contraction byte. A
//    stage is 128 contraction bytes holding J = 128 / P whole input
//    coefficients, P = t * nb rounded up to 4 bytes, in the order (j, dig,
//    m); the bytes past J * P, past t * nb in a coefficient's P, past d1
//    and past n0 are zero. One TMA box, 32 KB contiguous in device memory,
//    brings a stage's four limbs.
//  - B, the coefficients, is built by the producer warpgroup in shared
//    memory, in the 128-byte swizzle TMA would write, from the int32 input:
//    a 4-byte word of it holds the digits of one coefficient a[b, j] that
//    one shift and mask of tmp give (4 / nb digits), looked up in a 16-word
//    table. Every stage has the same word -> (j, shift) map, so a thread
//    computes its words' map once. It serves all four limbs. The input
//    words reach shared memory by 4-byte cp.async three stages ahead, so
//    no barrier or release waits on a global load (at 160 rows, 47.6 us
//    against 59.6 us with register loads a stage ahead; with loads a row
//    at a time, 133 us).
//  - Consumer warpgroup w issues the wgmma of limbs 2w and 2w+1 and keeps
//    one group in flight across stages. At the end the two warpgroups fold
//    their limb sums into one uint32 word, sum_l s_l << 8l (exact mod 2^32:
//    each |s_l| < 2^31), exchanging half of them through shared memory.
//  - Where column tiles x row tiles leave SMs idle (AES: 10 x 1-4), the S
//    stages are cut into gridDim.z ranges (ops/keyswitch.py:ks_plan, from
//    the row count and the set's shape). Every block adds its words to the
//    zeroed output with red.global.add.u32, exact in any order; the block
//    of range 0 that holds column n0 adds bin.
// On an H100 (PERF.md; cold L2, with the output's zeroing) at tfhepp_128bit
// it runs 31 us at 48 rows, 48 us at 160, 77 us at 480 and 0.48 ms at 4096,
// against 3.1-6.0 ms for the library path. What holds it there, from
// builds with one part removed at a time: at 160 rows the int8 work of
// 128-row tiles for 160 rows and the red.global.add epilogue (8 us), with
// the KSK's TMA stream (1.9 TB/s alone) under them; at 4096 rows the
// coefficient build (without it 0.25 ms). A cluster sharing one KSK tile
// between row tiles, row tiles cut to the row count and a build shared by
// both column tiles of a pair are later work.
#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kLimbs = 4;                          // KSK limbs
constexpr int kCols = 64;                          // output columns: M
constexpr int kStageK = 128;                       // contraction bytes a stage
constexpr int kConsumers = 2;                      // two limbs each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kATile = kLimbs * kCols * kStageK;   // KSK bytes a stage
constexpr int kLimbTile = kCols * kStageK;         // one limb's 64 rows
constexpr int kARow = 16;                          // input words a ring row
constexpr int kABufs = 4;                          // input ring buffers

// The shape of keyswitch_kernel<NT>: NT batch rows a block. Shared memory:
// the ring (each slot the KSK tile, then the coefficient tile, both
// 1024-byte aligned for the swizzle), full and empty barriers, the digit
// table, and the input ring (kABufs stages of the rows' input words), which
// the epilogue reuses for the second warpgroup's limb sums.
template <int NT>
struct Ks {
  static constexpr int kBTile = NT * kStageK;
  static constexpr int kStageBytes = kATile + kBTile;
  static constexpr int kStages = NT == 64 ? 5 : 4;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kAcc = NT / 2;              // int32 sums a limb
  static constexpr int kXBytes = kAcc * 128 * 4;
  static constexpr int kSmem = kRing + 16 * kStages + 64 + kXBytes + 1024;
  static_assert(NT == 64 || NT == 128, "row tile");
  static_assert(kStageBytes % 1024 == 0, "slots stay 1024-byte aligned");
  static_assert(kSmem <= 232448, "shared memory of one block");
  static_assert(kABufs * NT * kARow * 4 <= kXBytes, "the input ring");
};

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// 4-byte copy to shared memory; src_bytes = 0 writes a zero and reads
// nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void red_add(uint32_t* p, uint32_t v) {
  asm volatile("red.global.add.u32 [%0], %1;\n" :: "l"(p), "r"(v)
               : "memory");
}

#define R8(d, i)                                                     \
  "+r"(d[(i) + 0]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]),              \
      "+r"(d[(i) + 3]), "+r"(d[(i) + 4]), "+r"(d[(i) + 5]),          \
      "+r"(d[(i) + 6]), "+r"(d[(i) + 7])

// d += A B over one 32-byte contraction slice: A, 64 columns, from the
// shared-memory descriptor da; B, 64 or 128 batch rows, from db.
__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t da,
                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da,
                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : R8(d, 0), R8(d, 8), R8(d, 16), R8(d, 24),
        R8(d, 32), R8(d, 40), R8(d, 48), R8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}

#undef R8

// The coefficient bytes of one 4-byte word whose 4 / nb digits (nb =
// 2^(basebit-1) bytes each) are the bit fields of `idx`, the word's first
// digit in the highest basebit bits: digit val = field - nb puts +1 at byte
// m = -val-1 of its nb, -1 at m = val-1.
__device__ uint32_t digit_word(int idx, int basebit) {
  const int nb = 1 << (basebit - 1);
  const int spw = 4 / nb;                          // digits a word
  uint32_t w = 0;
  for (int e = 0; e < spw; ++e) {
    const int val = ((idx >> ((spw - 1 - e) * basebit)) &
                     ((1 << basebit) - 1)) - nb;
    if (val < 0) w |= 1u << (8 * (nb * e - val - 1));
    if (val > 0) w |= 0xFFu << (8 * (nb * e + val - 1));
  }
  return w;
}

// out [B, n0+1] += the key switch of rows b0 .. b0+NT-1 (a: [B, lda] with
// the d1 mask coefficients first, bin: the b terms, ldb apart) over output
// columns [64x, 64x + 64) and range z of the gridDim.z ranges of the S =
// ceil(d1 / J) stages, [zS/Z, (z+1)S/Z). J coefficients of P bytes a stage.
// Threads 0-255 are the consumer warpgroups, 256-383 the producer.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
keyswitch_kernel(const __grid_constant__ CUtensorMap tma_ksk,
                 const uint32_t* __restrict__ a, int lda,
                 const uint32_t* __restrict__ bin, int ldb,
                 uint32_t* __restrict__ out, int B, int d1, int n0, int t,
                 int basebit, int J, int P, uint32_t off) {
  using K = Ks<NT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full0 = base + K::kRing;          // full barrier i: +8i
  const uint32_t empty0 = full0 + 8 * K::kStages;
  uint32_t* lut = reinterpret_cast<uint32_t*>(
      smem_raw + (base - raw) + K::kRing + 16 * K::kStages);
  uint32_t* xbuf = lut + 16;                       // input ring / exchange
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int S = (d1 + J - 1) / J;
  const int s0 = static_cast<int>(static_cast<long long>(blockIdx.z) * S /
                                  gridDim.z);
  const int s1 = static_cast<int>(
      static_cast<long long>(blockIdx.z + 1) * S / gridDim.z);
  const int c0 = blockIdx.x * kCols;
  const int b0 = blockIdx.y * NT;

  if (tid == 0) {
    for (int i = 0; i < K::kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 4 * kConsumers);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: the KSK tile by TMA, the coefficient tile by hand ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n" ::: "memory");
    const int p = tid - 128 * kConsumers;
    const int nb = 1 << (basebit - 1);
    const int spw = 4 / nb;
    const int tnb = t * nb;
    if (p < (1 << (spw * basebit))) lut[p] = digit_word(p, basebit);
    // this thread's 16-byte chunk c of a stage row: for each of its words,
    // the coefficient of the stage it reads (jlo or jlo + 1: a chunk meets
    // at most two of P >= 8 bytes), the shift that brings its digits to
    // the low bits, and the mask of its bytes inside t * nb (zero past
    // J * P)
    const int c = p & 7;
    int jlo = -1;
    bool hi[4];
    uint32_t shw[4], keep[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int byte = 16 * c + 4 * w;
      const int jl = byte / P;
      const int ob = byte - jl * P;                // its offset in the P
      keep[w] = jl >= J || ob >= tnb ? 0u
                : ob + 4 > tnb       ? (1u << (8 * (tnb - ob))) - 1u
                                     : 0xFFFFFFFFu;
      if (keep[w] && jlo < 0) jlo = jl;
      hi[w] = keep[w] && jl > jlo;
      shw[w] = keep[w] ? static_cast<uint32_t>(32 - (ob / nb + spw) * basebit)
                       : 0u;
    }
    jlo = jlo < 0 ? 0 : jlo;
    const bool has_hi = hi[0] || hi[1] || hi[2] || hi[3];
    const uint32_t fmask = (1u << (spw * basebit)) - 1u;
    // a[b0 + r, sJ + jl] of each stage, 0 past B or d1, into buffer
    // (s - s0) % kABufs of the input ring by 4-byte cp.async, kABufs - 1
    // stages ahead: no thread waits on a global load at a barrier
    const uint32_t aring = smem_u32(xbuf);
    auto fetch = [&](int s) {
      const int jl = p & (kARow - 1);
      const int j = s * J + jl;
      if (s < s1 && jl < J) {
        const uint32_t dst =
            aring + 4 * (((s - s0) % kABufs) * NT * kARow + jl);
#pragma unroll
        for (int k = 0; k < NT / 8; ++k) {
          const int r = (p >> 4) + 8 * k;
          const bool ok = b0 + r < B && j < d1;
          cp_async4(dst + 4 * kARow * r,
                    ok ? a + static_cast<size_t>(b0 + r) * lda + j : a,
                    ok ? 4 : 0);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int k = 0; k < kABufs - 1; ++k) fetch(s0 + k);
    asm volatile("bar.sync 1, 128;\n" ::: "memory");   // the table is set
    int slot = 0;
    uint32_t parity = 1;                           // the ring starts empty
    for (int s = s0; s < s1; ++s) {
      const uint32_t sa = base + slot * K::kStageBytes;
      const uint32_t full = full0 + 8 * slot;
      mbar_wait(empty0 + 8 * slot, parity);
      if (p == 0) {
        mbar_expect_tx(full, kATile);
        tma_load(sa, &tma_ksk, full, 0,
                 (blockIdx.x * S + s) * kLimbs * kCols);
      }
      fetch(s + kABufs - 1);
      cp_async_wait<kABufs - 1>();               // this thread's stage s
      asm volatile("bar.sync 1, 128;\n" ::: "memory");   // every thread's
      const uint32_t* in = xbuf + ((s - s0) % kABufs) * NT * kARow + jlo;
      // the words' masks at this stage: none past d1
      const int j = s * J + jlo;
      uint32_t km[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) km[w] = j + hi[w] < d1 ? keep[w] : 0u;
      // rows r = p/8 + 16i, chunk c each; rows past B are left as they are
      // (their sums are not stored)
#pragma unroll
      for (int i = 0; i < NT / 16; ++i) {
        const int r = (p >> 3) + 16 * i;
        if (b0 + r < B) {
          const uint32_t x0 = in[kARow * r] + off;
          const uint32_t x1 = has_hi ? in[kARow * r + 1] + off : 0u;
          uint32_t v[4];
#pragma unroll
          for (int w = 0; w < 4; ++w)
            v[w] = lut[((hi[w] ? x1 : x0) >> shw[w]) & fmask] & km[w];
          st_shared16(sa + kATile + r * kStageK + ((c ^ (r & 7)) << 4),
                      make_uint4(v[0], v[1], v[2], v[3]));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (p == 0) mbar_arrive(full);
      if (++slot == K::kStages) {
        slot = 0;
        parity ^= 1;
      }
    }
  } else {
    // ---- consumer warpgroup wg: limbs 2wg and 2wg+1 of 64 columns ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
    const int lane = tid & 31;
    int sums[2][K::kAcc];
#pragma unroll
    for (int li = 0; li < 2; ++li) {
#pragma unroll
      for (int e = 0; e < K::kAcc; ++e) sums[li][e] = 0;
    }
    int slot = 0, prev = -1;
    uint32_t parity = 0;
    for (int s = s0; s < s1; ++s) {
      const uint32_t sa = base + slot * K::kStageBytes;
      mbar_wait(full0 + 8 * slot, parity);
      const uint64_t da0 = smem_desc(sa + (2 * wg) * kLimbTile);
      const uint64_t da1 = smem_desc(sa + (2 * wg + 1) * kLimbTile);
      const uint64_t db = smem_desc(sa + kATile);
      reg_fence(sums[0]);
      reg_fence(sums[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStageK / 32; ++kk) {
        wgmma(sums[0], da0 + 2 * kk, db + 2 * kk);
        wgmma(sums[1], da1 + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();                 // the previous stage's group is done
      reg_fence(sums[0]);
      reg_fence(sums[1]);
      if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = slot;
      if (++slot == K::kStages) {
        slot = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    reg_fence(sums[0]);
    reg_fence(sums[1]);
    // the warpgroup's two limbs as one word, sum_l s_l << 8l of its limbs.
    // v[4j + 2hi + x] is column c0 + 16 warp + g + 8hi, batch row b0 + 8j +
    // 2q + x (the wgmma accumulator fragment); warpgroup wg adds the words
    // of its half of the j to the other's, received through shared memory,
    // and stores them, so both issue the red.global.add
    uint32_t v[K::kAcc];
#pragma unroll
    for (int e = 0; e < K::kAcc; ++e)
      v[e] = (static_cast<uint32_t>(sums[0][e]) << (16 * wg)) +
             (static_cast<uint32_t>(sums[1][e]) << (16 * wg + 8));
    const int t128 = tid & 127;
    constexpr int kHalf = K::kAcc / 8;             // j of each warpgroup
#pragma unroll
    for (int e = 0; e < K::kAcc; ++e)
      if ((e / 4 < kHalf) != (wg == 0)) xbuf[e * 128 + t128] = v[e];
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
    const int warp = t128 >> 5;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int col = c0 + 16 * warp + g + 8 * hi;
      if (col > n0) continue;
      const bool add_b = col == n0 && blockIdx.z == 0;
#pragma unroll
      for (int j = 0; j < K::kAcc / 4; ++j) {
        if ((j < kHalf) != (wg == 0)) continue;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 4 * j + 2 * hi + x;
          const int b = b0 + 8 * j + 2 * q + x;
          if (b >= B) continue;
          uint32_t w = v[e] + xbuf[e * 128 + t128];
          if (add_b) w += bin[static_cast<size_t>(b) * ldb];
          red_add(out + static_cast<size_t>(b) * (n0 + 1) + col, w);
        }
      }
    }
  }
}

template <int NT>
cudaError_t launch(const CUtensorMap& map, const uint32_t* a, int lda,
                   const uint32_t* bin, int ldb, uint32_t* out, int B,
                   int d1, int n0, int t, int basebit, int J, int P,
                   uint32_t off, int col_tiles, int split, cudaStream_t s) {
  using K = Ks<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      keyswitch_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(col_tiles, (B + NT - 1) / NT, split);
  keyswitch_kernel<NT><<<grid, kThreads, K::kSmem, s>>>(
      map, a, lda, bin, ldb, out, B, d1, n0, t, basebit, J, P, off);
  return cudaGetLastError();
}

}  // namespace

// One key switch of B rows: out [B, n0+1] int32, zeroed by the caller,
// += the key switch of a (int32 rows lda apart, the d1 mask coefficients
// first) with b terms bin (ldb apart), through the KSK in the kernel's
// layout ksk [ceil((n0+1)/64), S, 4, 64, 128] int8 (16-byte aligned),
// S = ceil(d1 / J), J = 128 / P, P = t * 2^(basebit-1) rounded up to 4.
// off is the digits' offset (decomp_offset + roundoffset mod 2^32).
// row_tile (64 or 128) and split (1 .. S) are ops/keyswitch.py:ks_plan's
// choice. Enqueues one kernel on `stream` and returns its launch error as
// a cudaError_t value (0 on success); it does not wait. basebit outside
// 1..3, t * basebit > 32, t * 2^(basebit-1) outside 5..128 (P of 8 to 128
// bytes: a 16-byte chunk of a stage then meets at most two input
// coefficients), sums that could leave int32 (128 d1 t >= 2^31) and the
// other shapes below are refused with cudaErrorInvalidValue.
extern "C" int cufhe_key_switch(const void* ksk, const void* a, int lda,
                                const void* bin, int ldb, void* out, int B,
                                int d1, int n0, int t, int basebit,
                                unsigned int off, int row_tile, int split,
                                void* stream) {
  if (B < 1 || d1 < 1 || n0 < 1 || t < 1 || basebit < 1 || basebit > 3 ||
      t * basebit > 32 || lda < d1 || ldb < 1 ||
      (row_tile != 64 && row_tile != 128) ||
      128LL * d1 * t >= (1LL << 31) ||
      (static_cast<long long>(B) - 1) * lda + d1 > INT_MAX ||
      (static_cast<long long>(B) - 1) * ldb >= INT_MAX ||
      (B + row_tile - 1) / row_tile > 65535 ||
      reinterpret_cast<uintptr_t>(ksk) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tnb = t << (basebit - 1);
  const int P = (tnb + 3) / 4 * 4;
  if (P < 8 || P > kStageK) return static_cast<int>(cudaErrorInvalidValue);
  const int J = kStageK / P;
  const int S = (d1 + J - 1) / J;
  const int col_tiles = (n0 + 1 + kCols - 1) / kCols;
  if (split < 1 || split > S || split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  if (!encode_rows(fn, &map, ksk,
                   static_cast<long long>(col_tiles) * S * kLimbs * kCols,
                   kStageK, kLimbs * kCols))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* au = static_cast<const uint32_t*>(a);
  const auto* bu = static_cast<const uint32_t*>(bin);
  auto* ou = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      row_tile == 64
          ? launch<64>(map, au, lda, bu, ldb, ou, B, d1, n0, t, basebit, J,
                       P, off, col_tiles, split, s)
          : launch<128>(map, au, lda, bu, ldb, ou, B, d1, n0, t, basebit, J,
                        P, off, col_tiles, split, s);
  return static_cast<int>(err);
}
