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
//                  the extended generator ext = [-bk, bk] (prepare_bk_ext):
//                  a tile of the negacyclic Toeplitz operator is one
//                  contiguous window of ext, so shared memory holds windows
//                  and no N x N operator is ever built.
//
// What bounds it on an H100: integer multiply-adds. At tfhepp_128bit one
// step at B = 4096 is a 4096 x 6144 x 8192 int8 product, 2.1e11 MACs,
// against ~120 MB of device memory traffic (acc, 32 MB, read by rotdec and
// read and written by extprod; dec, 25 MB, written once and re-read from
// L2 by every output tile; 98 KB of key). So the kernel is compute bound
// by a wide margin, even at the tensor cores' rate.
//
// What this first version does about it: nothing clever. The inner product
// is __dp4a on the CUDA cores (4 int8 MACs per instruction) with a 4 x 4
// register tile per thread and four int32 accumulators (one per key limb)
// per output; the key window is stored reversed so that four consecutive
// contraction indices are four consecutive bytes, and the three unaligned
// words a thread needs are funnel shifts of two aligned ones. The int8 limb
// layout is the one tensor cores take, so later versions (mma / wgmma s8,
// TMA, a persistent kernel that keeps acc on chip across the n0 steps)
// change only the inner product and the schedule. Per-limb sums are bounded
// by I*N*2^(dbits-1)*128 (2^24.6 at tfhepp_128bit), exact in int32.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 4;
constexpr int kLimbBits = 8;
constexpr int kThreadsX = 32;                      // one warp across outputs
constexpr int kColsPerThread = 4;
constexpr int kBN = kThreadsX * kColsPerThread;    // 128 outputs per block
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = 4;
constexpr int kBM = kThreadsY * kRowsPerThread;    // 32 batch rows per block
constexpr int kBKMax = 256;                        // contraction tile (t)
constexpr int kRotdecThreads = 256;

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

__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    extprod_kernel(uint32_t* __restrict__ acc, const int8_t* __restrict__ dec,
                   const int8_t* __restrict__ bk_i, int B, int N, int kp1,
                   int I, int BK) {
  __shared__ __align__(16) int8_t sdec[kBM * kBKMax];   // [kBM][BK]
  // swin[li] byte s = ext_li[N + c0 - t0 + kBN - 1 - s], s < BK + kBN
  __shared__ __align__(16) uint32_t swin[kLimbs][(kBKMax + kBN) / 4];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  constexpr int kThreads = kThreadsX * kThreadsY;
  const int c0 = blockIdx.x * kBN;
  const int b0 = blockIdx.y * kBM;
  const int o = blockIdx.z;
  const int win = BK + kBN;
  const int vec_per_row = BK / 16;

  int sums[kRowsPerThread][kColsPerThread][kLimbs];
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr)
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q)
#pragma unroll
      for (int li = 0; li < kLimbs; ++li) sums[rr][q][li] = 0;

  for (int r = 0; r < I; ++r) {
    // limbs of the extended generator of key polynomial (r, o): [4][2N]
    const int8_t* gen =
        bk_i + (static_cast<size_t>(r) * kp1 + o) * kLimbs * 2 * N;
    for (int t0 = 0; t0 < N; t0 += BK) {
      __syncthreads();
      for (int v = tid; v < kBM * vec_per_row; v += kThreads) {
        const int rowi = v / vec_per_row;
        const int col = (v % vec_per_row) * 16;
        const int b = b0 + rowi;
        int4 val = make_int4(0, 0, 0, 0);
        if (b < B)
          val = *reinterpret_cast<const int4*>(
              dec + (static_cast<size_t>(b) * I + r) * N + t0 + col);
        *reinterpret_cast<int4*>(sdec + rowi * BK + col) = val;
      }
      const int ubase = N + c0 - t0 + kBN - 1;
      for (int e = tid; e < kLimbs * win; e += kThreads) {
        const int li = e / win;
        const int s = e - li * win;
        const int u = ubase - s;       // outside [0, 2N) only for c >= N
        reinterpret_cast<int8_t*>(swin[li])[s] =
            (u >= 0 && u < 2 * N) ? gen[li * 2 * N + u] : int8_t{0};
      }
      __syncthreads();

      // Thread (tx, ty) owns outputs c = c0 + 4*tx + q and batch rows
      // b0 + 4*ty + rr. For contraction t = t0 + 4*g + p the key byte of
      // output q sits at window byte 4*(m0 + g) + (3 - q) + p.
      const int m0 = kBN / 4 - 1 - tx;
      uint32_t lo[kLimbs];
#pragma unroll
      for (int li = 0; li < kLimbs; ++li) lo[li] = swin[li][m0];
#pragma unroll 4
      for (int g = 0; g < BK / 4; ++g) {
        int a[kRowsPerThread];
#pragma unroll
        for (int rr = 0; rr < kRowsPerThread; ++rr)
          a[rr] = reinterpret_cast<const int*>(
              sdec + (ty * kRowsPerThread + rr) * BK)[g];
#pragma unroll
        for (int li = 0; li < kLimbs; ++li) {
          const uint32_t hi = swin[li][m0 + g + 1];
          const int kq[kColsPerThread] = {
              static_cast<int>(__funnelshift_r(lo[li], hi, 24)),
              static_cast<int>(__funnelshift_r(lo[li], hi, 16)),
              static_cast<int>(__funnelshift_r(lo[li], hi, 8)),
              static_cast<int>(lo[li])};
#pragma unroll
          for (int rr = 0; rr < kRowsPerThread; ++rr)
#pragma unroll
            for (int q = 0; q < kColsPerThread; ++q)
              sums[rr][q][li] = __dp4a(a[rr], kq[q], sums[rr][q][li]);
          lo[li] = hi;
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int b = b0 + ty * kRowsPerThread + rr;
    if (b >= B) continue;
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int c = c0 + kColsPerThread * tx + q;
      if (c >= N) continue;
      uint32_t v = 0;
#pragma unroll
      for (int li = 0; li < kLimbs; ++li)
        v += static_cast<uint32_t>(sums[rr][q][li]) << (kLimbBits * li);
      acc[(static_cast<size_t>(b) * kp1 + o) * N + c] += v;
    }
  }
}

}  // namespace

// One blind rotation of B accumulators, in place. acc [B, k+1, N] and
// abar [n0, B] are int32 (torus values as uint32 bits), bk_ext is
// [n0, I, k+1, 4, 2N] int8 with I = (k+1)*l*nd, dec is scratch of
// B*I*N bytes. Enqueues 2*n0 kernels on `stream` and returns the first
// launch error as a cudaError_t value (0 on success); it does not wait.
extern "C" int cufhe_blind_rotate(void* acc, const void* abar,
                                  const void* bk_ext, void* dec, int B,
                                  int n0, int N, int nbit, int k, int l,
                                  int Bgbit, int nd, int dbits,
                                  unsigned int off_const, void* stream) {
  if (B <= 0 || n0 < 0 || nbit < 4 || nbit > 16 || N != (1 << nbit) ||
      k < 1 || l < 1 || Bgbit < 1 || l * Bgbit > 32 || nd < 1 || nd > 2 ||
      dbits < 1 || dbits > 8 || B > 65535 * kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp1 = k + 1;
  const int I = kp1 * l * nd;
  const int BK = N < kBKMax ? N : kBKMax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* acc_u = static_cast<uint32_t*>(acc);
  const auto* abar_i = static_cast<const int32_t*>(abar);
  const auto* key = static_cast<const int8_t*>(bk_ext);
  auto* dec_i8 = static_cast<int8_t*>(dec);
  const size_t key_step = static_cast<size_t>(I) * kp1 * kLimbs * 2 * N;
  const long long total = static_cast<long long>(B) * kp1 * N;
  const long long want_blocks = (total + kRotdecThreads - 1) / kRotdecThreads;
  const unsigned rot_blocks =
      static_cast<unsigned>(want_blocks < (1 << 20) ? want_blocks : (1 << 20));
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM, kp1);
  const dim3 block(kThreadsX, kThreadsY);
  for (int i = 0; i < n0; ++i) {
    rotdec_kernel<<<rot_blocks, kRotdecThreads, 0, s>>>(
        acc_u, abar_i + static_cast<size_t>(i) * B, dec_i8, B, N, nbit, kp1,
        l, Bgbit, nd, dbits, off_const);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    extprod_kernel<<<grid, block, 0, s>>>(acc_u, dec_i8, key + i * key_step,
                                          B, N, kp1, I, BK);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* cufhe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
