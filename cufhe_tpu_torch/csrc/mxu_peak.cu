// Tensor-core rate probe for NVIDIA Hopper (sm_90a): the int8 (and bf16)
// dot rate at the blind rotation's product shapes.
//
// Replaces benchmarks/mxu_peak.py:pallas_case, the Pallas TPU probe, and
// computes the same function: per step, S independent products
// P_s = A_s @ X_s (A [S, M, K], X [S, K, W]), repeated `steps` times inside
// one launch, as the fori_loop sits inside the Pallas kernel.
//
//   pure   out = sum_s P_s                                (int8, int32 sums)
//   place  upd += (sum_{s<S-1} P_s) << 8 + P_{S-1} every step, in uint32
//          registers that live across all steps; out = upd. The buffer
//          starts at 0 here (the TPU kernel never zeroes its scratch).
//   write  pure's result, but every A tile is loaded and stored into the
//          shared-memory ring by the block's own threads, between the
//          products (no cp.async): the first kStages-1 tiles from A, every
//          later one from `stage`, as the TPU kernel rewrites the next
//          dot's operand buffer from a staging copy (NBUF = 3 = kStages).
//   bf16   pure with bf16 operands and float32 sums, converted to int32 at
//          the end. Exact: every partial sum is an integer below 2^24.
//
// Instructions: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 for int8,
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 for bf16. Both take a
// 16 x 32-byte A fragment and an 8 x 32-byte B fragment with the contraction
// contiguous, so one shared-memory layout and one ldmatrix schedule serve
// both. B wants K-contiguous columns and X is W-contiguous; ldmatrix.trans
// transposes 16-bit elements only, so the caller stores X once as
// Xt [S, W, K] (mxu_peak.prepare_x), as prepare_bk_ext lays keys out once.
//
// What bounds it on an H100: tensor-core issue rate, if the operands keep
// up. They cannot stay on chip as they do in the TPU's VMEM: A at S = 18 is
// 56.6 MB, more than the 50 MB L2, so every step re-reads the operands from
// L2 and device memory. This version does the plain thing about it: a block
// owns a 128 x 64 output tile (128 blocks at M = 2048, W = 512, one wave on
// 132 SMs), 4 warps each own 64 x 32 of it, and a 3-stage cp.async ring of
// 128-byte contraction slices (XOR-swizzled, so ldmatrix is free of bank
// conflicts) hides the load latency. That is 42.7 MACs per byte moved into
// shared memory per block. wgmma, TMA, larger tiles and a persistent
// schedule are later work.
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

enum Variant { kPure = 0, kPlace = 1, kWrite = 2, kBf16 = 3 };

constexpr int kBM = 128;                       // output rows per block
constexpr int kBN = 64;                        // output columns per block
constexpr int kBKBytes = 128;                  // contraction bytes per stage
constexpr int kStages = 3;                     // ring depth (NBUF)
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM;             // 64 rows per warp
constexpr int kWN = kBN / kWarpsN;             // 32 columns per warp
constexpr int kMT = kWM / 16;                  // m16 tiles per warp
constexpr int kNT = kWN / 8;                   // n8 tiles per warp
constexpr int kATile = kBM * kBKBytes;         // 16 KB
constexpr int kBTile = kBN * kBKBytes;         // 8 KB
constexpr int kStageBytes = kATile + kBTile;
constexpr int kSmemBytes = kStages * kStageBytes;   // 72 KB
constexpr int kChunks = kBKBytes / 16;         // 16-byte chunks per row

static_assert(kChunks == 8, "the swizzle assumes 8 chunks per row");
static_assert((kBM * kChunks) % kThreads == 0, "A tile copy");
static_assert((kBN * kChunks) % kThreads == 0, "B tile copy");

// Byte offset of 16-byte chunk c of row r in a tile: rows are 128 bytes and
// the chunk index is XORed with the row, so the 8 rows one ldmatrix phase
// reads fall on 8 different bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kBKBytes + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int32_t to_i32(int v) { return v; }
__device__ __forceinline__ int32_t to_i32(float v) { return __float2int_rn(v); }
__device__ __forceinline__ int32_t to_i32(uint32_t v) {
  return static_cast<int32_t>(v);
}

// Store a warp's fragments (c0, c1 at row g, c2, c3 at row g + 8; columns
// 2t, 2t+1 of each n8 tile) to out [M, W].
template <typename T>
__device__ __forceinline__ void store_tile(const T (&v)[kMT][kNT][4],
                                           int32_t* __restrict__ out, int W,
                                           int row0, int col0, int lane) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int r = row0 + mt * 16 + (lane >> 2);
      const int c = col0 + nt * 8 + (lane & 3) * 2;
      int2* lo = reinterpret_cast<int2*>(out + static_cast<size_t>(r) * W + c);
      int2* hi = reinterpret_cast<int2*>(out + static_cast<size_t>(r + 8) * W +
                                         c);
      *lo = make_int2(to_i32(v[mt][nt][0]), to_i32(v[mt][nt][1]));
      *hi = make_int2(to_i32(v[mt][nt][2]), to_i32(v[mt][nt][3]));
    }
  }
}

// A: [S, M, Kb] bytes, Xt: [S, W, Kb] bytes, Kb = K * element size.
template <int V>
__global__ void __launch_bounds__(kThreads)
mxu_peak_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ Xt,
                const uint8_t* __restrict__ stage, int32_t* __restrict__ out,
                int M, int Kb, int W, int S, int steps) {
  using Acc = typename std::conditional<V == kBf16, float, int>::type;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp / kWarpsN) * kWM;
  const int wn = (warp % kWarpsN) * kWN;
  const int bm = blockIdx.y * kBM;
  const int bn = blockIdx.x * kBN;
  const int KT = Kb / kBKBytes;
  const int T = steps * S * KT;                // stages of the whole launch
  const uint32_t sbase = smem_addr(smem);

  // Copy stage i of the flattened (step, s, kt) loop into ring slot `slot`.
  auto load = [&](int i, int slot) {
    const int kt = i % KT;
    const int s = (i / KT) % S;
    const size_t koff = static_cast<size_t>(kt) * kBKBytes;
    const uint32_t sa = slot * kStageBytes;
#pragma unroll
    for (int q = 0; q < kBM * kChunks / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      const int r = idx >> 3, c = idx & 7;
      const size_t g = (static_cast<size_t>(s) * M + bm + r) * Kb + koff + c * 16;
      if (V == kWrite) {
        const uint8_t* src = i < kStages - 1 ? A : stage;
        const uint4 v = *reinterpret_cast<const uint4*>(src + g);
        *reinterpret_cast<uint4*>(smem + sa + swz(r, c)) = v;
      } else {
        cp_async16(sbase + sa + swz(r, c), A + g);
      }
    }
#pragma unroll
    for (int q = 0; q < kBN * kChunks / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      const int r = idx >> 3, c = idx & 7;
      const size_t g = (static_cast<size_t>(s) * W + bn + r) * Kb + koff + c * 16;
      cp_async16(sbase + sa + kATile + swz(r, c), Xt + g);
    }
  };

  Acc acc[kMT][kNT][4];
  uint32_t upd[kMT][kNT][4];                   // place only; dead otherwise
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] = Acc(0);
        upd[mt][nt][e] = 0u;
      }

  // Prologue: kStages-1 groups are always committed (some may be empty), so
  // wait_group<kStages-2> at iteration t always means "stage t has landed".
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < T) load(i, i);
    cp_async_commit();
  }

  int kt = 0, s = 0;
  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                           // stage t visible; slot of t-1 free
    const int nxt = t + kStages - 1;
    if (nxt < T) load(nxt, nxt % kStages);
    cp_async_commit();

    const uint32_t a_base = sbase + (t % kStages) * kStageBytes;
    const uint32_t b_base = a_base + kATile;
#pragma unroll
    for (int kk = 0; kk < kChunks / 2; ++kk) {   // 32-byte contraction slices
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = wm + mt * 16 + (lane & 15);
        ldmatrix_x4(af[mt], a_base + swz(r, 2 * kk + (lane >> 4)));
      }
      uint32_t bf[kNT][2];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int r = wn + np * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t q[4];
        ldmatrix_x4(q, b_base + swz(r, 2 * kk + ((lane >> 3) & 1)));
        bf[2 * np][0] = q[0];
        bf[2 * np][1] = q[1];
        bf[2 * np + 1][0] = q[2];
        bf[2 * np + 1][1] = q[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }

    if (++kt == KT) {                          // product s of this step done
      kt = 0;
      const bool last = s == S - 1;
      if (V == kPlace) {
        const int sh = last ? 0 : 8;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              upd[mt][nt][e] += static_cast<uint32_t>(acc[mt][nt][e]) << sh;
              acc[mt][nt][e] = Acc(0);
            }
        if (last) store_tile(upd, out, W, bm + wm, bn + wn, lane);
      } else if (last) {
        store_tile(acc, out, W, bm + wm, bn + wn, lane);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = Acc(0);
      }
      s = last ? 0 : s + 1;
    }
  }
  cp_async_wait<0>();
}

template <int V>
cudaError_t launch(const void* A, const void* Xt, const void* stage, void* out,
                   int M, int Kb, int W, int S, int steps,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mxu_peak_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(W / kBN, M / kBM);
  mxu_peak_kernel<V><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const uint8_t*>(A), static_cast<const uint8_t*>(Xt),
      static_cast<const uint8_t*>(stage), static_cast<int32_t*>(out), M, Kb,
      W, S, steps);
  return cudaGetLastError();
}

}  // namespace

// One launch of the probe: `variant` 0 pure, 1 place, 2 write, 3 bf16.
// A [S, M, K] and Xt [S, W, K] int8 (bf16 for variant 3), stage like A
// (read by `write` only), out [M, W] int32; all contiguous on one device.
// M must be a multiple of 128, W of 64, and K of 128 int8 or 64 bf16
// values. Returns a cudaError_t code; 0 on success.
extern "C" int cufhe_mxu_peak(int variant, const void* A, const void* Xt,
                              const void* stage, void* out, int M, int K,
                              int W, int S, int steps, void* stream) {
  const long long esize = variant == kBf16 ? 2 : 1;
  const long long Kb = static_cast<long long>(K) * esize;
  if (variant < kPure || variant > kBf16 || M <= 0 || K <= 0 || W <= 0 ||
      S <= 0 || steps <= 0 || M % kBM != 0 || W % kBN != 0 ||
      Kb % kBKBytes != 0 || Kb > (1LL << 30) ||
      static_cast<long long>(steps) * S * (Kb / kBKBytes) > (1LL << 30) ||
      M / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kb = static_cast<int>(Kb);
  switch (variant) {
    case kPure:
      return static_cast<int>(launch<kPure>(A, Xt, stage, out, M, kb, W, S,
                                            steps, st));
    case kPlace:
      return static_cast<int>(launch<kPlace>(A, Xt, stage, out, M, kb, W, S,
                                             steps, st));
    case kWrite:
      return static_cast<int>(launch<kWrite>(A, Xt, stage, out, M, kb, W, S,
                                             steps, st));
    default:
      return static_cast<int>(launch<kBf16>(A, Xt, stage, out, M, kb, W, S,
                                            steps, st));
  }
}
