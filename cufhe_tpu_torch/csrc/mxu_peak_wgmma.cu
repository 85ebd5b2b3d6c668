// Tensor-core rate probe for NVIDIA Hopper (sm_90a), Hopper's own
// instruction: wgmma.mma_async on operands that TMA brings into shared
// memory under mbarriers.
//
// Replaces benchmarks/mxu_peak.py:pallas_case, the Pallas TPU probe, and
// computes what mxu_peak.py:mxu_peak_ref computes, as csrc/mxu_peak.cu (the
// warp-level MMA version, kept as the second instruction) does: per step, S
// products P_s = A_s @ X_s (A [S, M, K], X [S, K, W], given as
// Xt [S, W, K]), repeated `steps` times inside one launch.
//
//   pure   out = sum_s P_s                              (int8, int32 sums)
//   place  out = steps * ((sum_{s<S-1} P_s) << 8 + P_{S-1}) mod 2^32: a
//          uint32 accumulator beside the product's, folded at every end of
//          an s (the TPU kernel's scratch starts at 0 here).
//   write  pure's result, but every A tile after a block's first
//          kStages-1 is copied into the ring by the producer warpgroup's
//          own threads (16-byte loads from `stage`, swizzled shared-memory
//          stores, fence.proxy.async.shared::cta) instead of by TMA, as the
//          TPU kernel rewrites the next dot's operand from a staging copy:
//          the cost of building an operand tile on chip by hand.
//   bf16   pure with bf16 operands and float32 sums, exact (every partial
//          sum is an integer below 2^24).
//
// What bounds it on an H100: operations. pure-w512 (M = 2048, K = 1536,
// W = 512, S = 18, 32 steps) is 0.93 int8 TMAC, 0.94 ms at 989.5 TMAC/s,
// and k1step (4096 x 6144 x 8192, 4 steps) 0.83 ms; their operands would
// take 0.02 and 0.03 ms from device memory. What holds a kernel back
// before that is the traffic from L2 into shared memory: A at S = 18
// (56.6 MB) does not fit the 50 MB L2, and every block re-reads its
// operands every step. The warp-level kernel's 128 x 64 tile moves 42.7 MACs
// per byte (21.7 GB per pure-w512 launch), which at the bound would need
// 23 TB/s.
//
// The design does three things about it:
//  - tile: a block owns 128 x BN outputs (BN = 256; 128 where W is not a
//    multiple of 256, and for place, whose second accumulator does not fit
//    in registers beside a 64 x 256 one): 85.3 (64) MACs per byte. Two
//    consumer warpgroups each own 64 rows and issue m64nBNk32 (k16 for
//    bf16) wgmma with both operands from shared memory; one producer warp
//    keeps cp.async.bulk.tensor loads of A [128 rows x 128 B] and
//    Xt [BN rows x 128 B] boxes in flight, 128-byte swizzled, in a ring of
//    kStages slots with a full and an empty mbarrier each;
//  - split: at w512 there are only 32 such tiles for 132 SMs, so the
//    contraction of a step, its S * Kb/128 (s, k-slice) pairs, is cut into
//    gridDim.z contiguous ranges, one per block (w512: 4, so 128 blocks);
//    mxu_peak.py:wgmma_plan chooses the split and split_ranges spells out
//    the ranges the kernel computes. Each block adds its partial to `out`
//    with red.global.add, which the wrapper zeroes: int32 adds are exact
//    in any order and wrap like uint32, and bf16 partials are integers;
//  - no multicast yet: the two column tiles that share an A tile read it
//    from L2 twice. A 2-block cluster would halve that.
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

enum Variant { kPure = 0, kPlace = 1, kWrite = 2, kBf16 = 3 };

constexpr int kBM = 128;                   // output rows per block (2 x 64)
constexpr int kBKBytes = 128;              // contraction bytes per stage
constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kATile = kBM * kBKBytes;     // 16 KB

template <int BN>
struct Cfg {
  static constexpr int kBTile = BN * kBKBytes;
  static constexpr int kStageBytes = kATile + kBTile;
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kRingBytes = kStages * kStageBytes;     // 192 KB
  // ring, full and empty barriers, and room to align the ring to 1024 B
  static constexpr int kSmemBytes = kRingBytes + 16 * kStages + 1024;
  static constexpr int kAcc = BN / 2;      // accumulators per thread
  static_assert(kStageBytes % 1024 == 0, "slots stay 1024-byte aligned");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

#define R8(d, i)                                                     \
  "+r"(d[(i) + 0]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]),              \
      "+r"(d[(i) + 3]), "+r"(d[(i) + 4]), "+r"(d[(i) + 5]),          \
      "+r"(d[(i) + 6]), "+r"(d[(i) + 7])
#define F8(d, i)                                                     \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]),              \
      "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]),          \
      "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (+)= A B over one 32-byte contraction slice: A 64 rows from descriptor
// da, B BN rows from db; scale_d = 0 overwrites d. One overload per
// accumulator type and width.
__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t da,
                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : R8(d, 0), R8(d, 8),
        R8(d, 16), R8(d, 24),
        R8(d, 32), R8(d, 40),
        R8(d, 48), R8(d, 56),
        R8(d, 64), R8(d, 72),
        R8(d, 80), R8(d, 88),
        R8(d, 96), R8(d, 104),
        R8(d, 112), R8(d, 120)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da,
                                     uint64_t db, int scale_d) {
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
      : R8(d, 0), R8(d, 8),
        R8(d, 16), R8(d, 24),
        R8(d, 32), R8(d, 40),
        R8(d, 48), R8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da,
                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8),
        F8(d, 16), F8(d, 24),
        F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56),
        F8(d, 64), F8(d, 72),
        F8(d, 80), F8(d, 88),
        F8(d, 96), F8(d, 104),
        F8(d, 112), F8(d, 120)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8),
        F8(d, 16), F8(d, 24),
        F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef R8
#undef F8

__device__ __forceinline__ int32_t to_i32(int v) { return v; }
__device__ __forceinline__ int32_t to_i32(float v) { return __float2int_rn(v); }
__device__ __forceinline__ int32_t to_i32(uint32_t v) {
  return static_cast<int32_t>(v);
}

// Write (add = false) or add a warp's 16 rows of a wgmma accumulator to
// out [M, W]: d[4j + 0, 1] at row lane/4, columns 8j + 2(lane%4) + 0, 1;
// d[4j + 2, 3] eight rows below.
template <typename T, int N>
__device__ __forceinline__ void store_rows(const T (&d)[N],
                                           int32_t* __restrict__ out, int W,
                                           int row0, int col0, int lane,
                                           bool add) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int c = col0 + j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + (lane >> 2) + 8 * h;
      int32_t* p = out + static_cast<size_t>(r) * W + c;
      const int32_t x = to_i32(d[4 * j + 2 * h]);
      const int32_t y = to_i32(d[4 * j + 2 * h + 1]);
      if (add) {
        atomicAdd(p, x);
        atomicAdd(p + 1, y);
      } else {
        *reinterpret_cast<int2*>(p) = make_int2(x, y);
      }
    }
  }
}

// Block (x, y, z): output rows [x 128, (x+1) 128), columns [y BN, (y+1) BN),
// and range z of the gridDim.z ranges of (s, k-slice) pairs, flattened as
// j = s * KT + kt (KT = Kb / 128), that it sums every step. Threads 0-255
// are the consumer warpgroups, 256-383 the producer warpgroup.
template <int V, int BN>
__global__ void __launch_bounds__(kThreads, 1)
mxu_peak_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      const uint8_t* __restrict__ stage,
                      int32_t* __restrict__ out, int M, int Kb, int W, int S,
                      int steps) {
  using C = Cfg<BN>;
  using Acc = typename std::conditional<V == kBf16, float, int>::type;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + C::kRingBytes;   // full barrier i: full0 + 8i
  const uint32_t empty0 = full0 + 8 * C::kStages;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.x * kBM;          // row tiles first: a wave of
  const int n0 = blockIdx.y * BN;           // blocks shares its Xt tiles
  const int KT = Kb / kBKBytes;
  const long long T = static_cast<long long>(S) * KT;
  const int lo = static_cast<int>(blockIdx.z * T / gridDim.z);
  const int hi = static_cast<int>((blockIdx.z + 1) * T / gridDim.z);
  const int n_it = steps * (hi - lo);

  if (tid == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 4 * kConsumers);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warpgroup: TMA by one thread (write: A by all 128) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int ptid = tid - 128 * kConsumers;
    if (V == kWrite || ptid == 0) {
      int j = lo, slot = 0;
      uint32_t parity = 1;                 // the ring starts empty
      for (int i = 0; i < n_it; ++i) {
        const int s = j / KT;
        const int kx = (j - s * KT) * kBKBytes;
        const uint32_t sa = base + slot * C::kStageBytes;
        const uint32_t full = full0 + 8 * slot;
        const bool by_hand = V == kWrite && i >= C::kStages - 1;
        mbar_wait(empty0 + 8 * slot, parity);
        if (ptid == 0) {
          if (by_hand) {
            mbar_expect_tx(full, C::kBTile);
          } else {
            mbar_arrive_tx(full, C::kStageBytes);
            tma_load(sa, &tma_a, full, kx, s * M + m0);
          }
          tma_load(sa + kATile, &tma_b, full, kx, s * W + n0);
        }
        if (by_hand) {
          // the A tile's 1024 16-byte chunks, 8 per thread, stored in the
          // swizzle TMA would have written
          const uint8_t* src =
              stage + (static_cast<size_t>(s) * M + m0) * Kb + kx;
#pragma unroll 2
          for (int q = 0; q < kBM * 8 / 128; ++q) {
            const int idx = ptid + q * 128;
            const int r = idx >> 3, c = idx & 7;
            const uint4 v = *reinterpret_cast<const uint4*>(
                src + static_cast<size_t>(r) * Kb + c * 16);
            st_shared16(sa + r * kBKBytes + ((c ^ (r & 7)) << 4), v);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync 1, 128;\n" ::: "memory");
          if (ptid == 0) mbar_arrive(full);
        }
        if (++j == hi) j = lo;
        if (++slot == C::kStages) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows x BN each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = tid & 31;
    const int row0 = m0 + wg * 64 + ((tid & 127) >> 5) * 16;
    const bool add = gridDim.z > 1;
    Acc acc[C::kAcc];
    uint32_t upd[V == kPlace ? C::kAcc : 1];
#pragma unroll
    for (int e = 0; e < C::kAcc; ++e) acc[e] = Acc(0);
#pragma unroll
    for (int e = 0; e < (V == kPlace ? C::kAcc : 1); ++e) upd[e] = 0u;
    int j = lo, slot = 0;
    uint32_t parity = 0;
    bool fresh = true;                     // the next product overwrites acc
    for (int i = 0; i < n_it; ++i) {
      const uint32_t sa = base + slot * C::kStageBytes;
      mbar_wait(full0 + 8 * slot, parity);
      const uint64_t da = smem_desc(sa + wg * 64 * kBKBytes);
      const uint64_t db = smem_desc(sa + kATile);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBKBytes / 32; ++kk)
        wgmma(acc, da + 2 * kk, db + 2 * kk, (kk > 0 || !fresh) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
      fresh = false;
      const int s = j / KT;
      const bool range_end = j == hi - 1;
      if (V == kPlace) {
        if (range_end || j - s * KT == KT - 1) {   // fold this s's part
          const int sh = s == S - 1 ? 0 : 8;
#pragma unroll
          for (int e = 0; e < C::kAcc; ++e)
            upd[e] += static_cast<uint32_t>(acc[e]) << sh;
          fresh = true;
        }
      } else if (range_end) {              // this step's partial is done
        if (i == n_it - 1) store_rows(acc, out, W, row0, n0, lane, add);
        fresh = true;
      }
      if (++j == hi) j = lo;
      if (++slot == C::kStages) {
        slot = 0;
        parity ^= 1;
      }
    }
    if (V == kPlace) store_rows(upd, out, W, row0, n0, lane, add);
  }
}

template <int V, int BN>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const void* stage, void* out, int M, int Kb, int W, int S,
                   int steps, int split, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mxu_peak_wgmma_kernel<V, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(M / kBM, W / BN, split);
  mxu_peak_wgmma_kernel<V, BN><<<grid, kThreads, Cfg<BN>::kSmemBytes,
                                 stream>>>(
      ta, tb, static_cast<const uint8_t*>(stage), static_cast<int32_t*>(out),
      M, Kb, W, S, steps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// One launch of the wgmma probe: `variant` 0 pure, 1 place, 2 write,
// 3 bf16; block tile 128 x bn (bn = 256 or 128; place takes 128), the
// contraction of a step cut into `split` ranges (mxu_peak.py:wgmma_plan).
// A [S, M, K] and Xt [S, W, K] int8 (bf16 for variant 3), stage like A
// (read by `write` only), out [M, W] int32, zeroed by the caller when
// split > 1; all contiguous, 16-byte aligned, on one device. M must be a
// multiple of 128, W of bn, and K of 128 int8 or 64 bf16 values. Returns a
// cudaError_t code; 0 on success.
extern "C" int cufhe_mxu_peak_wgmma(int variant, int bn, const void* A,
                                    const void* Xt, const void* stage,
                                    void* out, int M, int K, int W, int S,
                                    int steps, int split, void* stream) {
  const long long esize = variant == kBf16 ? 2 : 1;
  const long long Kb = static_cast<long long>(K) * esize;
  const long long T = Kb / kBKBytes * S;
  if (variant < kPure || variant > kBf16 || (bn != 128 && bn != 256) ||
      (variant == kPlace && bn != 128) || M <= 0 || K <= 0 || W <= 0 ||
      S <= 0 || steps <= 0 || split <= 0 || M % kBM != 0 || W % bn != 0 ||
      Kb % kBKBytes != 0 || Kb > (1LL << 30) ||
      static_cast<long long>(S) * M >= (1LL << 31) ||
      static_cast<long long>(S) * W >= (1LL << 31) || split > T ||
      split > 65535 || W / bn > 65535 ||
      static_cast<long long>(steps) * ((T + split - 1) / split) >=
          (1LL << 31) ||
      !aligned16(A) || !aligned16(Xt) || !aligned16(stage) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int kb = static_cast<int>(Kb);
  CUtensorMap ta, tb;
  if (!encode_rows(fn, &ta, A, static_cast<long long>(S) * M, kb, kBM) ||
      !encode_rows(fn, &tb, Xt, static_cast<long long>(S) * W, kb, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bn == 256) {
    switch (variant) {
      case kPure:
        err = launch<kPure, 256>(ta, tb, stage, out, M, kb, W, S, steps,
                                 split, st);
        break;
      case kWrite:
        err = launch<kWrite, 256>(ta, tb, stage, out, M, kb, W, S, steps,
                                  split, st);
        break;
      default:
        err = launch<kBf16, 256>(ta, tb, stage, out, M, kb, W, S, steps,
                                 split, st);
    }
  } else {
    switch (variant) {
      case kPure:
        err = launch<kPure, 128>(ta, tb, stage, out, M, kb, W, S, steps,
                                 split, st);
        break;
      case kPlace:
        err = launch<kPlace, 128>(ta, tb, stage, out, M, kb, W, S, steps,
                                  split, st);
        break;
      case kWrite:
        err = launch<kWrite, 128>(ta, tb, stage, out, M, kb, W, S, steps,
                                  split, st);
        break;
      default:
        err = launch<kBf16, 128>(ta, tb, stage, out, M, kb, W, S, steps,
                                 split, st);
    }
  }
  return static_cast<int>(err);
}
