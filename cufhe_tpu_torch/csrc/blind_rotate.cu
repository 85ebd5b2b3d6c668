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
// order on the caller's stream: rotdec_kernel, then extprod_kernel.
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
// L_li[r,o][N + c - t]) << 8*li, where L_li is limb li of the extended
// generator ext = [-bk, bk] (prepare_bk_ext), on the tensor cores
// (mma.sync m16n8k32 s8.s8.s32). The reduced-precision pallas3 key keeps
// limbs 1-3 of the four (pallas_br.py:57-62, 907-920): its instance
// extprod_kernel<BK, 3, WO> contracts against three windows, shifts limb li
// by 8*(li+1), and issues 3/4 of the four-limb instance's MMAs. Nothing
// else changes; the arithmetic is the JAX kernel's bit for bit.
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
// (8 outputs x 4 limbs) each (WO = 1 octet of outputs a warp); a 3-stage
// cp.async ring of 128-byte contraction slices of dec (XOR-swizzled for
// ldmatrix, rows at or above B zero-filled) and key windows. A warp's four
// n8 tiles are the four limbs of the same 8 outputs, so every thread holds
// all four limb sums of its outputs and the epilogue, acc += sum_li
// sums_li << 8*li in uint32, runs in registers. At three limbs the same
// block (extprod_kernel<128, 3, 1>) is 96 columns: the A tile is re-read
// from L2 once per 96 columns instead of 128, and the ldmatrix, barrier
// and copy work of a stage is spread over 3/4 of the MMAs, so it runs at a
// lower MMA rate than the exact instance.
// The pallas3 path therefore runs extprod_kernel<256, 3, 2> where N >= 256:
// a warp holds two octets of outputs (64 outputs, 192 columns a block, 96
// int32 sums a thread), which halves the A traffic and doubles the MMAs
// per ldmatrix; at 196 registers one block fits an SM, with no second
// block to run while its warps wait at a stage's barrier, so the stage is
// 256 contraction bytes, half as many barriers. On an H100 it ran at
// 312.6 ms a rotation against <128, 3, 1>'s 369.1 at tfhepp_128bit, batch
// 4096 (PERF.md), so cufhe_blind_rotate takes it wherever N >= 256 and
// <128, 3, 1> only at N = 128.
// Each (b, o, c) belongs to one block, so the in-place update has no race.
// For N < 128 the stage is 32 bytes wide (one mma k-step); BK | N always.
// The int32 sums of the tensor cores are exact while I*N*2^(dbits-1)*128
// < 2^31 (2^24.6 at tfhepp_128bit); cufhe_blind_rotate refuses any set
// where it is not.
// wgmma, TMA, Karatsuba leaves and a persistent kernel that keeps acc on
// chip across the n0 steps are later work.
#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 4;                          // limbs of an exact key
constexpr int kLimbBits = 8;

// rotdec_kernel's tiling: threads per block, and quads (4 coefficients) per
// thread wherever a row has at least kRotThreads * kRotQuads * 4 of them
// (4 measured best of 1, 2, 4 and 8 on an H100: PERF.md).
constexpr int kRotThreads = 256;
constexpr int kRotQuads = 4;
constexpr int kRotMaxNbit = 15;                    // a row of 128 KB

// extprod_kernel's tiling
constexpr int kBM = 128;                           // batch rows per block
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;                         // warps across outputs
constexpr int kThreads = 32 * kWarpsM * kWarpsN;   // 256
constexpr int kWM = kBM / kWarpsM;                 // 64 rows per warp
constexpr int kMT = kWM / 16;                      // m16 tiles per warp
constexpr int kStages = 3;                         // cp.async ring depth

// The shape of extprod_kernel<BK, NL, WO>: contraction stages of BK bytes,
// NL key limbs, WO octets of outputs per warp, so a block computes kBNc =
// 32 * WO outputs c of one component, NL * kBNc mma columns. Shared memory
// of one ring stage: the A tile (kBM rows of BK bytes), then one window of
// BK + kBNc key bytes per limb, each followed by 16 bytes that are read (by
// lanes whose run starts on a word boundary) but never used.
template <int BK, int NL, int WO>
struct Stage {
  static constexpr int kBNc = 8 * WO * kWarpsN;    // outputs c per block
  static constexpr int kChunks = BK / 16;          // 16-byte chunks per row
  static constexpr int kA = kBM * BK;
  static constexpr int kWin = BK + kBNc;           // window bytes per limb
  static constexpr int kWinChunks = kWin / 16;
  static constexpr int kWinStride = kWin + 16;
  static constexpr int kBytes = kA + NL * kWinStride;
  static constexpr int kSmem = kStages * kBytes;
  static_assert((kBM * kChunks) % kThreads == 0, "A tile copy");
  static_assert(NL * kWinChunks <= kThreads, "window copy");
  static_assert(BK % 32 == 0 && kBytes % 16 == 0, "stage layout");
  static_assert(NL >= 1 && NL <= kLimbs, "limbs");
};

// Byte offset of 16-byte chunk c of row r in an A tile of BK-byte rows: the
// chunk index is XORed with the row, so for BK = 128 the 8 rows one
// ldmatrix phase reads fall on 8 different bank groups.
template <int BK>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(
      r * BK + ((c ^ (r & (BK / 16 - 1))) << 4));
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

// dec [B, I, N] int8 for one step: the rows (b, j) of acc [B, kp1, N]
// rotated by X^abar_i[b], minus themselves, offset and decomposed. Block x
// owns rows x * rows .. x * rows + rows-1 of the nrows = B * kp1, with
// rows = kRotThreads >> tpr_log and 1 << tpr_log threads a row, and holds
// them in shared memory (rows * N * 4 bytes). L and ND are l and nd where
// they are known at compile time (the published sets), 0 where not.
template <int L, int ND>
__global__ void __launch_bounds__(kRotThreads)
rotdec_kernel(const uint32_t* __restrict__ acc,
              const int32_t* __restrict__ abar_i, int8_t* __restrict__ dec,
              int nrows, int nbit, int tpr_log, int kp1, int l_rt, int Bgbit,
              int nd_rt, int dbits, uint32_t off) {
  extern __shared__ __align__(16) uint32_t srow[];
  const int l = L ? L : l_rt;
  const int nd = ND ? ND : nd_rt;
  const int N = 1 << nbit;
  const int rows = kRotThreads >> tpr_log;
  const int row0 = blockIdx.x * rows;
  const int here = min(rows, nrows - row0);
  const uint32_t sbase = smem_addr(srow);
  const uint32_t* src = acc + static_cast<size_t>(row0) * N;
  for (int c = threadIdx.x; c < (here << (nbit - 2)); c += kRotThreads)
    cp_async16(sbase + 16 * c, src + 4 * c, 16);
  cp_async_commit();
  const int rr = threadIdx.x >> tpr_log;
  const int row = row0 + rr;
  const int b = row / kp1;
  const int j = row - b * kp1;
  // read while the copy is in flight
  const uint32_t ab = rr < here ? static_cast<uint32_t>(abar_i[b]) : 0u;
  cp_async_wait<0>();
  __syncthreads();
  if (rr >= here) return;

  const int lane = threadIdx.x & ((1 << tpr_log) - 1);
  const int qmask = (N >> 2) - 1;
  const uint32_t mask = (1u << Bgbit) - 1u;
  const int half = 1 << (Bgbit - 1);
  const int dhalf = 1 << (dbits - 1);
  const int dmask = (1 << dbits) - 1;
  const uint32_t low = ab & static_cast<uint32_t>(N - 1);
  const bool hi = (ab >> nbit) & 1u;
  const uint4* s4 = reinterpret_cast<const uint4*>(srow + (rr << nbit));
  // the rotated window of quad q starts at word (4q - low) mod N: aligned
  // quad (q - ceil(low/4)) mod N/4 shifted by sh = (-low) mod 4 words
  const int sh = static_cast<int>((0u - low) & 3u);
  const int qlow = static_cast<int>((low + 3u) >> 2);
  uint32_t* out = reinterpret_cast<uint32_t*>(
      dec + (static_cast<size_t>(b) * kp1 * l * nd + j * l * nd) * N);
  for (int q = lane; q <= qmask; q += 1 << tpr_log) {
    const uint4 own = s4[q];
    const int a = (q - qlow) & qmask;
    const uint4 w0 = s4[a];
    const uint4 w1 = s4[(a + 1) & qmask];
    const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    uint32_t v[6];
#pragma unroll
    for (int e = 0; e < 6; ++e) v[e] = (sh & 1) ? w[e + 1] : w[e];
    const uint32_t mine[4] = {own.x, own.y, own.z, own.w};
    uint32_t temp[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t x = (sh & 2) ? v[e + 2] : v[e];
      const bool neg = (static_cast<uint32_t>(4 * q + e) < low) != hi;
      temp[e] = (neg ? 0u - x : x) - mine[e] + off;
    }
    uint32_t* o = out + q;
#pragma unroll
    for (int d = 0; d < l; ++d) {
      const int shift = 32 - (d + 1) * Bgbit;
      int dig[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dig[e] = static_cast<int>((temp[e] >> shift) & mask) - half;
#pragma unroll
      for (int dl = 0; dl < nd; ++dl) {
        int part[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part[e] = dig[e];              // the last sub-digit takes the rest
          if (dl < nd - 1) {
            part[e] = ((dig[e] + dhalf) & dmask) - dhalf;
            dig[e] = (dig[e] - part[e]) >> dbits;
          }
        }
        const uint32_t lo = __byte_perm(part[0], part[1], 0x0040);
        const uint32_t up = __byte_perm(part[2], part[3], 0x0040);
        *o = __byte_perm(lo, up, 0x5410);
        o += N >> 2;                     // the next digit row
      }
    }
  }
}

// rotdec_kernel's launch shape for rows of N = 2^nbit coefficients.
struct RotdecPlan {
  void (*kernel)(const uint32_t*, const int32_t*, int8_t*, int, int, int,
                 int, int, int, int, int, uint32_t);
  int tpr_log;                                     // log2 threads per row
  int rows;                                        // rows per block
  int smem;                                        // bytes per block
};

// The plan for N = 2^nbit and (l, nd), with the kernel's shared memory
// limit raised to it (once per C call, not per step).
cudaError_t rotdec_plan(int nbit, int l, int nd, RotdecPlan* plan) {
  plan->kernel = l == 3 && nd == 1   ? rotdec_kernel<3, 1>
                 : l == 2 && nd == 1 ? rotdec_kernel<2, 1>
                 : l == 3 && nd == 2 ? rotdec_kernel<3, 2>
                 : l == 2 && nd == 2 ? rotdec_kernel<2, 2>
                                     : rotdec_kernel<0, 0>;
  int tpr_log = nbit - 2;                          // one thread per quad
  while ((1 << tpr_log) > kRotThreads ||
         (tpr_log > 0 && (1 << (nbit - 2 - tpr_log)) < kRotQuads))
    --tpr_log;
  plan->tpr_log = tpr_log;
  plan->rows = kRotThreads >> tpr_log;
  plan->smem = plan->rows * (4 << nbit);
  return cudaFuncSetAttribute(
      plan->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem);
}

// One rotdec_kernel launch (one step) on `s`.
cudaError_t launch_rotdec(const RotdecPlan& plan, const uint32_t* acc,
                          const int32_t* abar_i, int8_t* dec, int B,
                          int nbit, int kp1, int l, int Bgbit, int nd,
                          int dbits, uint32_t off, cudaStream_t s) {
  const int nrows = B * kp1;
  plan.kernel<<<(nrows + plan.rows - 1) / plan.rows, kRotThreads, plan.smem,
                s>>>(acc, abar_i, dec, nrows, nbit, plan.tpr_log, kp1, l,
                     Bgbit, nd, dbits, off);
  return cudaGetLastError();
}

// The arguments both entries take: N = 2^nbit with 32 <= N <= 2^kRotMaxNbit
// (a row in shared memory), digits that rotdec_kernel's shifts can cut,
// B within the product's grid and B * I digit rows within int, acc 16-byte
// aligned for cp.async and dec 4-byte aligned for its stores.
bool args_ok(const void* acc, const void* dec, int B, int N, int nbit, int k,
             int l, int Bgbit, int nd, int dbits) {
  return B > 0 && B <= 65535 * kBM && nbit >= 5 && nbit <= kRotMaxNbit &&
         N == (1 << nbit) && k >= 1 && l >= 1 && Bgbit >= 1 &&
         Bgbit <= 16 && l * Bgbit <= 32 && nd >= 1 && nd <= 2 &&
         dbits >= 1 && dbits <= 8 &&
         static_cast<long long>(B) * (k + 1) * l * nd <= INT_MAX &&
         reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(dec) % 4 == 0;
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
// one step, bk_i [I, kp1, NL, 2N], whose limb li is worth 2^(8(li + 4 -
// NL)): 4 limbs are the exact key, 3 the reduced-precision pallas3 key
// (the lowest limb dropped, pallas_br.py:57-62), whose instance issues 3/4
// of the exact instance's MMAs. Grid: (kp1 * N/kBNc column blocks,
// ceil(B/kBM) row blocks); kThreads threads; Stage<BK, NL, WO>::kSmem
// bytes.
template <int BK, int NL, int WO>
__global__ void __launch_bounds__(kThreads)
extprod_kernel(uint32_t* __restrict__ acc, const int8_t* __restrict__ dec,
               const int8_t* __restrict__ bk_i, int B, int N, int kp1,
               int I) {
  using St = Stage<BK, NL, WO>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp / kWarpsN) * kWM;
  const int wn = warp % kWarpsN;        // outputs c0 + 8*(WO*wn + oo) + 0..7
  const int cblocks = N / St::kBNc;
  const int o = blockIdx.x / cblocks;
  const int c0 = (blockIdx.x - o * cblocks) * St::kBNc;
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
    if (tid < NL * St::kWinChunks) {
      const int li = tid / St::kWinChunks;
      const int ch = tid - li * St::kWinChunks;
      const int r = s / per_r;
      const int t0 = (s - r * per_r) * BK;
      const int8_t* gen =
          bk_i + ((static_cast<size_t>(r) * kp1 + o) * NL + li) * 2 * N;
      cp_async16(sa + St::kA + li * St::kWinStride + ch * 16,
                 gen + (N + c0 - t0 - BK) + ch * 16, 16);
    }
  };

  // B fragment of n8 tile (oo, li) at k-step kk: register h (contraction
  // bytes 32*kk + 16*h + 4*q + e, e = 0..3) of column c = c0 + 8*ow + g,
  // ow = WO*wn + oo, holds window bytes x = 8*ow + g + BK - 32*kk - 16*h -
  // 4*q - e, i.e. bytes xa+3, xa+2, xa+1, xa of the window with xa = 4*m +
  // sh: word m and the next, byte-permuted. sh and the word m at kk = h =
  // oo = 0 depend on the lane only; the next octet is 2 words on.
  const int g = lane >> 2, q = lane & 3;
  const int sh = (g + 1) & 3;
  const uint32_t sel = (sh + 3) | ((sh + 2) << 4) | ((sh + 1) << 8) |
                       (sh << 12);
  const int m0 = 2 * WO * wn + BK / 4 - q - 1 + ((g + 1) >> 2);

  int sums[kMT][WO][NL][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int oo = 0; oo < WO; ++oo)
#pragma unroll
      for (int li = 0; li < NL; ++li)
#pragma unroll
        for (int e = 0; e < 4; ++e) sums[mt][oo][li][e] = 0;

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
      for (int oo = 0; oo < WO; ++oo) {
#pragma unroll
        for (int li = 0; li < NL; ++li) {
          const uint32_t* w =
              win + li * (St::kWinStride / 4) + m0 + 2 * oo - 8 * kk;
          const uint32_t b0f = __byte_perm(w[0], w[1], sel);
          const uint32_t b1f = __byte_perm(w[-4], w[-3], sel);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            mma(sums[mt][oo][li], af[mt], b0f, b1f);
        }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment e of tile (mt, oo, li): row g + 8*(e >> 1), column
  // 2*q + (e & 1) of octet oo.
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int b = b0 + wm + mt * 16 + g + 8 * hf;
      if (b >= B) continue;
#pragma unroll
      for (int oo = 0; oo < WO; ++oo) {
        uint32_t v0 = 0, v1 = 0;
#pragma unroll
        for (int li = 0; li < NL; ++li) {
          const int shift = kLimbBits * (li + kLimbs - NL);
          v0 += static_cast<uint32_t>(sums[mt][oo][li][2 * hf]) << shift;
          v1 += static_cast<uint32_t>(sums[mt][oo][li][2 * hf + 1]) << shift;
        }
        const int c = c0 + 8 * (WO * wn + oo) + 2 * q;
        uint2* p = reinterpret_cast<uint2*>(
            acc + (static_cast<size_t>(b) * kp1 + o) * N + c);
        uint2 cur = *p;
        cur.x += v0;
        cur.y += v1;
        *p = cur;
      }
    }
  }
}

// The n0 steps of one rotation through extprod_kernel<BK, NL, WO>.
template <int BK, int NL, int WO>
cudaError_t rotate(uint32_t* acc, const int32_t* abar, const int8_t* key,
                   int8_t* dec, int B, int n0, int N, int nbit, int kp1,
                   int l, int Bgbit, int nd, int dbits, uint32_t off,
                   cudaStream_t s) {
  using St = Stage<BK, NL, WO>;
  cudaError_t err = cudaFuncSetAttribute(
      extprod_kernel<BK, NL, WO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      St::kSmem);
  if (err != cudaSuccess) return err;
  RotdecPlan plan;
  err = rotdec_plan(nbit, l, nd, &plan);
  if (err != cudaSuccess) return err;
  const int I = kp1 * l * nd;
  const size_t key_step = static_cast<size_t>(I) * kp1 * NL * 2 * N;
  const dim3 grid(kp1 * (N / St::kBNc), (B + kBM - 1) / kBM);
  for (int i = 0; i < n0; ++i) {
    err = launch_rotdec(plan, acc, abar + static_cast<size_t>(i) * B, dec, B,
                        nbit, kp1, l, Bgbit, nd, dbits, off, s);
    if (err != cudaSuccess) return err;
    extprod_kernel<BK, NL, WO><<<grid, kThreads, St::kSmem, s>>>(
        acc, dec, key + i * key_step, B, N, kp1, I);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

using RotateFn = cudaError_t (*)(uint32_t*, const int32_t*, const int8_t*,
                                 int8_t*, int, int, int, int, int, int, int,
                                 int, int, uint32_t, cudaStream_t);

}  // namespace

// One blind rotation of B accumulators, in place. acc [B, k+1, N] and
// abar [n0, B] are int32 (torus values as uint32 bits), bk_ext is
// [n0, I, k+1, nlimbs, 2N] int8 with I = (k+1)*l*nd, dec is scratch of
// B*I*N bytes. nlimbs is 4 (the exact key) or 3 (pallas3, N >= 128); the
// product's instance follows from nlimbs and N. Enqueues 2*n0 kernels on
// `stream` and returns the first launch error as a cudaError_t value (0 on
// success); it does not wait.
// Another nlimbs, a three-limb key at N < 128, sets whose limb sums could
// leave int32 (I*N*2^(dbits-1)*128 >= 2^31), N < 32, N > 2^kRotMaxNbit and
// the other arguments args_ok refuses are refused with
// cudaErrorInvalidValue.
extern "C" int cufhe_blind_rotate(void* acc, const void* abar,
                                  const void* bk_ext, void* dec, int B,
                                  int n0, int N, int nbit, int k, int l,
                                  int Bgbit, int nd, int dbits, int nlimbs,
                                  unsigned int off_const, void* stream) {
  if (n0 < 0 || !args_ok(acc, dec, B, N, nbit, k, l, Bgbit, nd, dbits))
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
  RotateFn run = nullptr;
  if (nlimbs == 4)
    run = N >= 128 ? rotate<128, 4, 1> : rotate<32, 4, 1>;
  else if (nlimbs == 3 && N >= 256)
    run = rotate<256, 3, 2>;
  else if (nlimbs == 3 && N >= 128)
    run = rotate<128, 3, 1>;
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(acc_u, abar_i, key, dec_i8, B, n0, N, nbit,
                              kp1, l, Bgbit, nd, dbits, off_const, s));
}

// One step's rotate-and-decompose alone: dec [B, I, N] int8 from acc
// [B, k+1, N] and abar_i [B] int32, through the kernel cufhe_blind_rotate
// launches once per step. Enqueues one kernel on `stream`; returns the
// launch error (0 on success), cudaErrorInvalidValue for what args_ok
// refuses.
extern "C" int cufhe_rotdec(const void* acc, const void* abar_i, void* dec,
                            int B, int N, int nbit, int k, int l, int Bgbit,
                            int nd, int dbits, unsigned int off_const,
                            void* stream) {
  if (!args_ok(acc, dec, B, N, nbit, k, l, Bgbit, nd, dbits))
    return static_cast<int>(cudaErrorInvalidValue);
  RotdecPlan plan;
  cudaError_t err = rotdec_plan(nbit, l, nd, &plan);
  if (err == cudaSuccess)
    err = launch_rotdec(plan, static_cast<const uint32_t*>(acc),
                        static_cast<const int32_t*>(abar_i),
                        static_cast<int8_t*>(dec), B, nbit, k + 1, l, Bgbit,
                        nd, dbits, off_const,
                        static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

extern "C" const char* cufhe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
