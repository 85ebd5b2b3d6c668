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
// caller are reinterpreted as uint32_t.
//
// Two kernels per step, launched in order on the caller's stream:
//   rotdec_kernel  writes the gadget digits dec [B, I, N] int8, row
//                  r = (j*l + d)*nd + dl (the Pallas kernel's rr);
//   extprod_kernel acc[b,o,c] += sum_li (sum_{r,t} dec[b,r,t] *
//                  L_li[r,o][N + c - t]) << 8*li, where L_li is limb li of
//                  the extended generator ext = [-bk, bk] (prepare_bk_ext),
//                  on the tensor cores (mma.sync m16n8k32 s8.s8.s32).
//
// The product as a GEMM, per step: M = B rows, K = I*N (r, t) contraction
// bytes, W = (k+1)*4*N columns (o, limb, c). dec, as rotdec writes it, is
// the row-major A operand [B, I*N]. The B operand is the negacyclic
// Toeplitz operator of the key, T_li[(r, t), (o, c)] = ext_li[r,o][N+c-t]
// (48 MB per step, 30 GB per key at tfhepp_128bit), and it is never built:
// a block's slice of it for one stage, contraction (r, t0 .. t0+BK-1) and
// outputs c0 .. c0+31 of component o, is, for each limb, the 16-byte
// aligned window ext_li[r,o][N+c0-t0-BK .. N+c0-t0+32). With 32 | N and
// BK | N every window lies inside [0, 2N), so nothing is masked.
// cp.async brings the four windows into shared memory beside the A tile;
// each thread then builds its mma B fragments in registers. A fragment
// register holds four consecutive contraction bytes of one column, which
// are four consecutive window bytes in reverse order, and within a warp the
// byte offset of that run inside a 4-byte word depends only on the lane:
// so every B register is one __byte_perm of two aligned window words (two
// broadcast shared loads), and no B tile is written to shared memory.
//
// What bounds it on an H100: int8 multiply-adds. At tfhepp_128bit one step
// at B = 4096 is a 4096 x 6144 x 8192 product, 2.06e11 MACs, 0.208 ms at
// the 1,979 TOPS dense int8 datasheet rate, against about 0.04 ms of
// device-memory traffic (acc, 34 MB, read by rotdec, read and written
// here; dec, 25 MB, written by rotdec and read here; 98 KB of key). Inside
// the chip the A operand is re-read from L2 once per column block: with 128
// mma columns per block (32 outputs x 4 limbs) that is 64 column blocks,
// 1.6 GB of L2 reads per step, where the 128 x 64 tile of the probe
// (csrc/mxu_peak.cu) would read 3.2 GB. 32 outputs is a good trade because
// it keeps the probe's 64 x 32 warp tile, 64 int32 sums a thread, and
// spreads the wider block over 8 warps instead of growing a warp's
// registers; the B operand costs no L2 traffic at all (four windows of
// BK+32 bytes per stage).
//
// What this version does about it: the probe's schedule, which the probe
// measured at exactly this GEMM shape (its k1step case): a block owns 128
// batch rows x 32 outputs x 4 limbs of one component; 8 warps of 64 rows x
// (8 outputs x 4 limbs) each; a 3-stage cp.async ring of 128-byte
// contraction slices of dec (XOR-swizzled for ldmatrix, rows at or above B
// zero-filled) and key windows. A warp's four n8 tiles are the four limbs
// of the same 8 outputs, so every thread holds all four limb sums of its
// outputs and the epilogue, acc += sum_li sums_li << 8*li in uint32, runs
// in registers.
// Each (b, o, c) belongs to one block, so the in-place update has no race.
// For N < 128 the stage is 32 bytes wide (one mma k-step). The int32 sums
// of the tensor cores are exact while I*N*2^(dbits-1)*128 < 2^31 (2^24.6
// at tfhepp_128bit); cufhe_blind_rotate refuses any set where it is not.
// wgmma, TMA, Karatsuba leaves and a persistent kernel that keeps acc on
// chip across the n0 steps are later work.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 4;
constexpr int kLimbBits = 8;
constexpr int kRotdecThreads = 256;

// extprod_kernel's tiling
constexpr int kBM = 128;                           // batch rows per block
constexpr int kBNc = 32;                           // outputs c per block
constexpr int kWarpsM = 2;
constexpr int kWarpsN = kBNc / 8;                  // 8 outputs x 4 limbs each
constexpr int kThreads = 32 * kWarpsM * kWarpsN;   // 256
constexpr int kWM = kBM / kWarpsM;                 // 64 rows per warp
constexpr int kMT = kWM / 16;                      // m16 tiles per warp
constexpr int kStages = 3;                         // cp.async ring depth

// Shared memory of one ring stage for a contraction width of BK bytes: the
// A tile (kBM rows of BK bytes), then one window of BK + kBNc key bytes per
// limb, each followed by 16 bytes that are read (by lanes whose run starts
// on a word boundary) but never used.
template <int BK>
struct Stage {
  static constexpr int kChunks = BK / 16;          // 16-byte chunks per row
  static constexpr int kA = kBM * BK;
  static constexpr int kWin = BK + kBNc;           // window bytes per limb
  static constexpr int kWinChunks = kWin / 16;
  static constexpr int kWinStride = kWin + 16;
  static constexpr int kBytes = kA + kLimbs * kWinStride;
  static constexpr int kSmem = kStages * kBytes;
  static_assert((kBM * kChunks) % kThreads == 0, "A tile copy");
  static_assert(kLimbs * kWinChunks <= kThreads, "window copy");
  static_assert(BK % 32 == 0 && kBytes % 16 == 0, "stage layout");
};

__global__ void rotdec_kernel(const uint32_t* __restrict__ acc,
                              const int32_t* __restrict__ abar_i,
                              int8_t* __restrict__ dec, int B, int N,
                              int nbit, int kp1, int l, int Bgbit, int nd,
                              int dbits, uint32_t off) {
  const long long total = static_cast<long long>(B) * kp1 * N;
  const int I = kp1 * l * nd;
  const uint32_t mask = (1u << Bgbit) - 1u;
  const int half = 1 << (Bgbit - 1);
  const int dhalf = 1 << (dbits - 1);
  const int dmask = (1 << dbits) - 1;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(idx & (N - 1));
    const long long bj = idx >> nbit;              // b * kp1 + j
    const int j = static_cast<int>(bj % kp1);
    const long long b = bj / kp1;
    const uint32_t ab = static_cast<uint32_t>(abar_i[b]);
    const uint32_t low = ab & static_cast<uint32_t>(N - 1);
    const bool hi = (ab >> nbit) & 1u;
    const uint32_t* row = acc + bj * N;
    // acc * X^abar at coefficient t: a gather with a sign flip on wrap
    const uint32_t x = row[(static_cast<uint32_t>(t) - low) & (N - 1)];
    const bool neg = (static_cast<uint32_t>(t) < low) != hi;
    const uint32_t temp = (neg ? 0u - x : x) - row[t] + off;
    int8_t* out = dec + static_cast<size_t>(b) * I * N + t;
    for (int d = 0; d < l; ++d) {
      int dig = static_cast<int>((temp >> (32 - (d + 1) * Bgbit)) & mask) -
                half;
      for (int dl = 0; dl < nd; ++dl) {
        int part = dig;                // the last sub-digit takes the rest
        if (dl < nd - 1) {
          part = ((dig + dhalf) & dmask) - dhalf;
          dig = (dig - part) >> dbits;
        }
        out[static_cast<size_t>((j * l + d) * nd + dl) * N] =
            static_cast<int8_t>(part);
      }
    }
  }
}

// Byte offset of 16-byte chunk c of row r in an A tile of BK-byte rows: the
// chunk index is XORed with the row, so for BK = 128 the 8 rows one
// ldmatrix phase reads fall on 8 different bank groups.
template <int BK>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(
      r * BK + ((c ^ (r & (Stage<BK>::kChunks - 1))) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; src_bytes = 0 fills the 16 bytes with zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// acc [B, kp1, N] += the external product of dec [B, I*N] with the key of
// one step, bk_i [I, kp1, 4, 2N]. Grid: (kp1 * N/kBNc column blocks,
// ceil(B/kBM) row blocks); kThreads threads; Stage<BK>::kSmem bytes.
template <int BK>
__global__ void __launch_bounds__(kThreads)
extprod_kernel(uint32_t* __restrict__ acc, const int8_t* __restrict__ dec,
               const int8_t* __restrict__ bk_i, int B, int N, int kp1,
               int I) {
  using St = Stage<BK>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp / kWarpsN) * kWM;
  const int wn = warp % kWarpsN;                 // outputs c0 + 8*wn + 0..7
  const int cblocks = N / kBNc;
  const int o = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x - o * cblocks) * kBNc;
  const int b0 = blockIdx.y * kBM;
  const size_t KB = static_cast<size_t>(I) * N;  // contraction bytes per row
  const int per_r = N / BK;                      // stages per key row r
  const int T = I * per_r;                       // stages of the launch
  const uint32_t sbase = smem_addr(smem);

  // Stage s covers contraction bytes s*BK .. s*BK+BK-1, that is key row
  // r = s / per_r and t0 = (s % per_r) * BK.
  auto load = [&](int s, int slot) {
    const uint32_t sa = sbase + slot * St::kBytes;
#pragma unroll
    for (int q = 0; q < kBM * St::kChunks / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      const int r = idx / St::kChunks, c = idx % St::kChunks;
      const int b = b0 + r;
      const int8_t* src = dec + static_cast<size_t>(b < B ? b : 0) * KB +
                          static_cast<size_t>(s) * BK + c * 16;
      cp_async16(sa + swz<BK>(r, c), src, b < B ? 16 : 0);
    }
    if (tid < kLimbs * St::kWinChunks) {
      const int li = tid / St::kWinChunks;
      const int ch = tid - li * St::kWinChunks;
      const int r = s / per_r;
      const int t0 = (s - r * per_r) * BK;
      const int8_t* gen =
          bk_i + ((static_cast<size_t>(r) * kp1 + o) * kLimbs + li) * 2 * N;
      cp_async16(sa + St::kA + li * St::kWinStride + ch * 16,
                 gen + (N + c0 - t0 - BK) + ch * 16, 16);
    }
  };

  // B fragment of n8 tile li at k-step kk: register h (contraction bytes
  // 32*kk + 16*h + 4*q + e, e = 0..3) of column c = c0 + 8*wn + g holds
  // window bytes x = 8*wn + g + BK - 32*kk - 16*h - 4*q - e, i.e. bytes
  // xa+3, xa+2, xa+1, xa of the window with xa = 4*m + sh: word m and the
  // next, byte-permuted. sh and the word m at kk = h = 0 depend on the
  // lane only.
  const int g = lane >> 2, q = lane & 3;
  const int sh = (g + 1) & 3;
  const uint32_t sel = (sh + 3) | ((sh + 2) << 4) | ((sh + 1) << 8) |
                       (sh << 12);
  const int m0 = 2 * wn + BK / 4 - q - 1 + ((g + 1) >> 2);

  int sums[kMT][kLimbs][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int li = 0; li < kLimbs; ++li)
#pragma unroll
      for (int e = 0; e < 4; ++e) sums[mt][li][e] = 0;

  // Prologue: kStages-1 groups are always committed (some may be empty), so
  // wait_group<kStages-2> at iteration t always means "stage t has landed".
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < T) load(i, i);
    cp_async_commit();
  }

  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // stage t visible; slot of t-1 free
    const int nxt = t + kStages - 1;
    if (nxt < T) load(nxt, nxt % kStages);
    cp_async_commit();

    const int slot = t % kStages;
    const uint32_t a_base = sbase + slot * St::kBytes;
    const uint32_t* win = reinterpret_cast<const uint32_t*>(
        smem + slot * St::kBytes + St::kA);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {       // 32-byte contraction steps
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = wm + mt * 16 + (lane & 15);
        ldmatrix_x4(af[mt], a_base + swz<BK>(r, 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int li = 0; li < kLimbs; ++li) {
        const uint32_t* w = win + li * (St::kWinStride / 4) + m0 - 8 * kk;
        const uint32_t b0f = __byte_perm(w[0], w[1], sel);
        const uint32_t b1f = __byte_perm(w[-4], w[-3], sel);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma(sums[mt][li], af[mt], b0f, b1f);
      }
    }
  }
  cp_async_wait<0>();

  // C fragment e of tile (mt, li): row g + 8*(e >> 1), column 2*q + (e & 1).
  const int c = c0 + 8 * wn + 2 * q;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int b = b0 + wm + mt * 16 + g + 8 * hf;
      if (b >= B) continue;
      uint32_t v0 = 0, v1 = 0;
#pragma unroll
      for (int li = 0; li < kLimbs; ++li) {
        v0 += static_cast<uint32_t>(sums[mt][li][2 * hf]) << (kLimbBits * li);
        v1 += static_cast<uint32_t>(sums[mt][li][2 * hf + 1])
              << (kLimbBits * li);
      }
      uint2* p = reinterpret_cast<uint2*>(
          acc + (static_cast<size_t>(b) * kp1 + o) * N + c);
      uint2 cur = *p;
      cur.x += v0;
      cur.y += v1;
      *p = cur;
    }
  }
}

// The n0 steps of one rotation, with contraction stages of BK bytes.
template <int BK>
cudaError_t rotate(uint32_t* acc, const int32_t* abar, const int8_t* key,
                   int8_t* dec, int B, int n0, int N, int nbit, int kp1,
                   int l, int Bgbit, int nd, int dbits, uint32_t off,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      extprod_kernel<BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Stage<BK>::kSmem);
  if (err != cudaSuccess) return err;
  const int I = kp1 * l * nd;
  const size_t key_step = static_cast<size_t>(I) * kp1 * kLimbs * 2 * N;
  const long long total = static_cast<long long>(B) * kp1 * N;
  const long long want_blocks = (total + kRotdecThreads - 1) / kRotdecThreads;
  const unsigned rot_blocks =
      static_cast<unsigned>(want_blocks < (1 << 20) ? want_blocks : (1 << 20));
  const dim3 grid(kp1 * (N / kBNc), (B + kBM - 1) / kBM);
  for (int i = 0; i < n0; ++i) {
    rotdec_kernel<<<rot_blocks, kRotdecThreads, 0, s>>>(
        acc, abar + static_cast<size_t>(i) * B, dec, B, N, nbit, kp1, l,
        Bgbit, nd, dbits, off);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    extprod_kernel<BK><<<grid, kThreads, Stage<BK>::kSmem, s>>>(
        acc, dec, key + i * key_step, B, N, kp1, I);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// One blind rotation of B accumulators, in place. acc [B, k+1, N] and
// abar [n0, B] are int32 (torus values as uint32 bits), bk_ext is
// [n0, I, k+1, 4, 2N] int8 with I = (k+1)*l*nd, dec is scratch of
// B*I*N bytes. Enqueues 2*n0 kernels on `stream` and returns the first
// launch error as a cudaError_t value (0 on success); it does not wait.
// Sets whose limb sums could leave int32 (I*N*2^(dbits-1)*128 >= 2^31) and
// N < 32 are refused with cudaErrorInvalidValue.
extern "C" int cufhe_blind_rotate(void* acc, const void* abar,
                                  const void* bk_ext, void* dec, int B,
                                  int n0, int N, int nbit, int k, int l,
                                  int Bgbit, int nd, int dbits,
                                  unsigned int off_const, void* stream) {
  if (B <= 0 || n0 < 0 || nbit < 5 || nbit > 16 || N != (1 << nbit) ||
      k < 1 || l < 1 || Bgbit < 1 || l * Bgbit > 32 || nd < 1 || nd > 2 ||
      dbits < 1 || dbits > 8 || B > 65535 * kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp1 = k + 1;
  const long long I = static_cast<long long>(kp1) * l * nd;
  if (I * N * (1LL << (dbits - 1)) * 128 >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* acc_u = static_cast<uint32_t*>(acc);
  const auto* abar_i = static_cast<const int32_t*>(abar);
  const auto* key = static_cast<const int8_t*>(bk_ext);
  auto* dec_i8 = static_cast<int8_t*>(dec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      N >= 128 ? rotate<128>(acc_u, abar_i, key, dec_i8, B, n0, N, nbit, kp1,
                             l, Bgbit, nd, dbits, off_const, s)
               : rotate<32>(acc_u, abar_i, key, dec_i8, B, n0, N, nbit, kp1,
                            l, Bgbit, nd, dbits, off_const, s);
  return static_cast<int>(err);
}

extern "C" const char* cufhe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
