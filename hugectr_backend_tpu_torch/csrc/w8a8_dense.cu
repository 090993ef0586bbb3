// K5: one w8a8 dense layer.
//
// Replaces the Pallas kernels `_kernel` and `_no_bias_kernel`
// (hugectr_backend_tpu/ops/quant_matmul.py:49 and :108) with the semantics
// they share with the XLA formulation `xla_w8a8` (the same file, :112):
//
//     xs[m]    = max(max_k |x[m, k]|, 1e-12) / 127           (IEEE divide)
//     xq[m, k] = clip(round_half_even(x[m, k] / xs[m]), -127, 127)
//     y[m, n]  = act((f32(sum_k xq[m, k] * wq[n, k]) * xs[m]) * wscale[n] + bias[n])
//
// with x [M, K] f32, wq [N, K] int8 (the nn.Linear layout: K contiguous),
// wscale [N] f32, bias [N] f32 or null, and act one of none, relu, sigmoid,
// tanh, gelu (tanh form). The int32 sum is exact, and the divides, the
// rounding and the rescale are done with the round-to-nearest intrinsics in
// this order (no FMA contraction), so for act none and relu the result
// equals the plain PyTorch version bit for bit. Inputs are taken to be
// finite.
//
// What bounds it on an H100: device-memory bytes. At the DLRM's widths
// (M = 4096, K and N up to 1024) a layer reads 4MK bytes of x and KN of
// weights and writes 4MN; at 3.35 TB/s that takes longer than the 2MKN int8
// operations take on the tensor cores. The TPU kernel keeps the whole
// [K, N] weight in VMEM and sweeps M. Here the caller's launch plan
// (ops/quant_matmul.py k5_plan) picks one of four paths by layer shape:
//
// - GEMV (N <= 8, the logit layer, K up to 29,056), one kernel: a warp per
//   row; the weight sits in shared memory, the row is quantized in
//   registers (every load issued before any arithmetic) and dotted with
//   __dp4a. Past that K the plan sends N <= 8 to the mma.sync product.
// - narrow (K <= 512 where wgmma does not take it), one kernel: a CTA keeps
//   a 64- or 128-column slice of the weight in shared memory, as the TPU
//   body keeps its weight in VMEM, and walks items of 16 rows; it quantizes
//   an item's rows itself (a warp over 2 rows), multiplies them with
//   mma.sync m16n8k32 against the slice and stores them, the next item's
//   rows already in flight.
// - tile, K <= 64, one kernel: a CTA per 64 x 128 output tile quantizes its
//   rows of x into the one chunk of K and multiplies with mma.sync.
// - wgmma (16-byte weight rows, K > 256, N >= 256) and tile (the rest), two
//   kernels. A quantize kernel reads x once (a warp per row, every load in
//   flight before the reduce) and writes xq [M, Kq] int8 (K padded with
//   zeros to Kq, a multiple of 64) and xs [M] into a scratch that stays in
//   L2. Then the product gives each CTA an output tile and streams the
//   tile's rows of xq and of the weight through a cp.async ring:
//   * wgmma: 128 x 128 or 64 x 128 tiles; two warpgroups issue wgmma
//     m64n64k32 on operands in the 128-byte swizzle, 128 bytes of K a chunk;
//   * tile: 64 x 128 or 32 x 64 tiles, mma.sync, 64 bytes of K a chunk, 8
//     stages (the weight a byte at a time through registers when its rows
//     are not a multiple of 16 bytes).
//   The product is launched as a programmatic dependent of the quantize
//   kernel: it loads its first weight chunks, scales and bias while the
//   quantize kernel runs (which waited for every kernel before it), and
//   waits (griddepcontrol.wait) only before it reads xq. The one-kernel
//   paths, whose predecessor may be any kernel (a weight update), wait
//   before they read anything.
// Every epilogue rescales into shared memory and stores whole rows with the
// activation. A persistent variant of the narrow kernel (two CTAs per SM
// walking several items each) and of the wgmma product (one CTA per SM
// walking tiles, the next tile's loads in flight under this tile's stores)
// were slower at the DLRM's shapes (PERF.md).
//
// Quantization: each value is scaled by RN(1 / xs) and rounded; only a value
// that lands within 4e-5 of a half-integer takes the IEEE divide, which gives
// the same integer as the divide for every value (see quant1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // every kernel: 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BK = 64;        // product: K bytes per chunk (two mma k-steps)
constexpr int SKEW = 16;      // product: row padding (bytes), conflict-free fragment loads
constexpr int BS_LD = BK + SKEW;
constexpr int KREG = 1024;    // up to this K, a row is quantized from registers
constexpr int MAX_SMEM = 232448;  // 227 KB of dynamic shared memory per block
// The int32 sum is exact while 127 * 127 * K < 2^31, as the reference's
// int32 dot; past that a sum could wrap.
constexpr int MAX_K = 133144;
constexpr int GEMV_MAX_K = 29056;  // the GEMV's weight in shared memory: 8 x 29056 <= MAX_SMEM
constexpr int GEMV_MAX_N = 8;

enum Variant { V_GEMV = 0, V_NARROW = 1, V_TILE = 2, V_WGMMA = 3 };

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2, ACT_TANH = 3, ACT_GELU = 4 };

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(y, 0.0f);
    case ACT_SIGMOID:
      return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
    case ACT_TANH:
      return tanhf(y);
    case ACT_GELU: {
      // 0.5 y (1 + tanh(sqrt(2/pi) (y + 0.044715 y^3)))
      const float inner = 0.7978845608028654f * (y + 0.044715f * (y * y * y));
      return 0.5f * y * (1.0f + tanhf(inner));
    }
    default:
      return y;
  }
}

// (f32(acc) * xs) * wscale + bias, then the activation.
__device__ __forceinline__ float rescale(int acc, float xs, float ws, float b, bool has_bias,
                                         int act) {
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  if (has_bias) y = __fadd_rn(y, b);
  return activate(y, act);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Programmatic dependent launch: wait until the grids this one depends on
// have completed and their writes are visible; let the next grid in the
// stream start launching.
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_launch_next() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __noinline__ float rint_div(float v, float xs) { return rintf(__fdiv_rn(v, xs)); }

// clip(rint(fl(v / xs)), -127, 127) without a divide in the common case.
// With inv = RN(1 / xs), t = RN(v * inv) is within 2^-23 |v / xs| <= 1.6e-5
// of the exact quotient (|v / xs| <= 127.00001, as |v| <= absmax), and
// fl(v / xs) within 2^-24 |v / xs| <= 7.6e-6 of it; so unless t lies within
// 4e-5 of a half-integer, both round to the same integer. The rare element
// that does takes the IEEE divide.
__device__ __forceinline__ int8_t quant1(float v, float xs, float inv) {
  const float t = __fmul_rn(v, inv);
  float q = rintf(t);
  if (fabsf(fabsf(t - q) - 0.5f) < 4e-5f) q = rint_div(v, xs);
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(q));
}

__device__ __forceinline__ uint32_t quant4(float4 v, float xs, float inv) {
  return static_cast<uint32_t>(static_cast<uint8_t>(quant1(v.x, xs, inv))) |
         static_cast<uint32_t>(static_cast<uint8_t>(quant1(v.y, xs, inv))) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(quant1(v.z, xs, inv))) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(quant1(v.w, xs, inv))) << 24;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Columns k..k+3 of a row (zeros past K or for a dead row). XVEC: K % 4 == 0
// and x 16-byte aligned, so the float4 is either wholly inside or outside.
template <bool XVEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ xr, bool live, int k, int K) {
  // Every load is issued (from column 0 when masked) and masked after, so
  // that the compiler puts all of a row's loads in flight together.
  if constexpr (XVEC) {
    const bool in = live && k < K;
    const float4 v = __ldg(reinterpret_cast<const float4*>(xr + (in ? k : 0)));
    return in ? v : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = live && k + j < K;
      const float e = __ldg(xr + (in ? k + j : 0));
      v[j] = in ? e : 0.0f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float amax4(float m, float4 v) {
  return fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
}

// Rows row0 .. row0 + RB - 1 (live while below M), K <= NV * 128: every
// load of every row issued at once; v[i][j] holds columns (lane + 32 j) * 4
// .. + 3 of row i (zeros past K or for a dead row).
template <bool XVEC, int NV, int RB>
__device__ __forceinline__ void load_rows(const float* __restrict__ x, int M, int K, int row0,
                                          int lane, float4 (&v)[RB][NV]) {
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const bool live = row0 + i < M;
    const float* xr = x + static_cast<int64_t>(live ? row0 + i : 0) * K;
#pragma unroll
    for (int j = 0; j < NV; ++j) v[i][j] = load4<XVEC>(xr, live, (lane + 32 * j) * 4, K);
  }
}

// Each loaded row reduced and quantized: q[i][j] the four int8 of v[i][j],
// xs[i] the row's scale.
template <int NV, int RB>
__device__ __forceinline__ void quant_loaded(const float4 (&v)[RB][NV], uint32_t (&q)[RB][NV],
                                             float (&xs)[RB]) {
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) amax = amax4(amax, v[i][j]);
    xs[i] = __fdiv_rn(fmaxf(warp_max(amax), 1e-12f), 127.0f);
    const float inv = __frcp_rn(xs[i]);
#pragma unroll
    for (int j = 0; j < NV; ++j) q[i][j] = quant4(v[i][j], xs[i], inv);
  }
}

template <bool XVEC, int NV, int RB>
__device__ __forceinline__ void quant_rows(const float* __restrict__ x, int M, int K, int row0,
                                           int lane, uint32_t (&q)[RB][NV], float (&xs)[RB]) {
  float4 v[RB][NV];
  load_rows<XVEC, NV, RB>(x, M, K, row0, lane, v);
  quant_loaded<NV, RB>(v, q, xs);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}

// 4 bytes, zero-filled when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raise the shared-memory limit of a kernel once per device.
template <typename K>
cudaError_t allow_smem(K kernel, uint64_t& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && (done >> device & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess && device < 64) done |= uint64_t{1} << device;
  return err;
}

// ------------------------------------------------------------------- GEMV

// Columns of a weight row in shared memory: what one row's quantize covers
// (NV float4 per lane, NV in {1, 2, 4, 8}) up to KREG, then K rounded up to
// whole 128-column steps.
__host__ __device__ constexpr int gemv_kq(int K) {
  return K <= 128 ? 128 : K <= 256 ? 256 : K <= 512 ? 512 : K <= KREG ? KREG
                                                                     : (K + 127) / 128 * 128;
}

template <bool XVEC, int NV>
__device__ __forceinline__ void gemv_rows(const float* __restrict__ x, const int8_t* Ws,
                                          const float* __restrict__ wscale,
                                          const float* __restrict__ bias, float* __restrict__ out,
                                          int M, int N, int K, int Kq, int act, int warp,
                                          int lane) {
  for (int row = blockIdx.x * WARPS + warp; row < M; row += gridDim.x * WARPS) {
    int acc[GEMV_MAX_N];
#pragma unroll
    for (int n = 0; n < GEMV_MAX_N; ++n) acc[n] = 0;
    float xs;
    if constexpr (NV > 0) {
      uint32_t q[1][NV];
      float s[1];
      quant_rows<XVEC, NV, 1>(x, M, K, row, lane, q, s);
      xs = s[0];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int k = (lane + 32 * j) * 4;
#pragma unroll
        for (int n = 0; n < GEMV_MAX_N; ++n)
          if (n < N)
            acc[n] = __dp4a(static_cast<int>(q[0][j]),
                            *reinterpret_cast<const int*>(Ws + n * Kq + k), acc[n]);
      }
    } else {  // K > KREG: two passes over the row (the second from L1 / L2)
      const float* xr = x + static_cast<int64_t>(row) * K;
      float amax = 0.0f;
      for (int k = lane * 4; k < K; k += 128) amax = amax4(amax, load4<XVEC>(xr, true, k, K));
      xs = __fdiv_rn(fmaxf(warp_max(amax), 1e-12f), 127.0f);
      const float inv = __frcp_rn(xs);
      for (int k = lane * 4; k < K; k += 128) {
        const int qk = static_cast<int>(quant4(load4<XVEC>(xr, true, k, K), xs, inv));
#pragma unroll
        for (int n = 0; n < GEMV_MAX_N; ++n)
          if (n < N) acc[n] = __dp4a(qk, *reinterpret_cast<const int*>(Ws + n * Kq + k), acc[n]);
      }
    }
    int mine = 0;
#pragma unroll
    for (int n = 0; n < GEMV_MAX_N; ++n) {
      if (n < N) {
        const int s = warp_sum(acc[n]);
        if (lane == n) mine = s;
      }
    }
    if (lane < N) {
      const float b = bias != nullptr ? __ldg(bias + lane) : 0.0f;
      out[static_cast<int64_t>(row) * N + lane] =
          rescale(mine, xs, __ldg(wscale + lane), b, bias != nullptr, act);
    }
  }
}

template <bool XVEC, int NV>
__global__ void __launch_bounds__(THREADS)
w8a8_gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ wscale, const float* __restrict__ bias,
                 float* __restrict__ out, int M, int N, int K, int ldw, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* Ws = reinterpret_cast<int8_t*>(smem);  // [N][Kq], zero past K
  const int Kq = gemv_kq(K);
  // Any input may come from the kernel before: wait for it first.
  grid_wait();
  grid_launch_next();
  for (int n = 0; n < N; ++n)
    for (int k = threadIdx.x; k < Kq; k += THREADS)
      Ws[n * Kq + k] = k < K ? wq[static_cast<int64_t>(n) * ldw + k] : int8_t{0};
  __syncthreads();
  gemv_rows<XVEC, NV>(x, Ws, wscale, bias, out, M, N, K, Kq, act, threadIdx.x >> 5,
                      threadIdx.x & 31);
}

// --------------------------------------------------------------- quantize

// K padded to whole product chunks: the row stride of xq.
__host__ __device__ constexpr int quant_kq(int K) { return (K + BK - 1) / BK * BK; }

// Warp w of CTA c quantizes row 8 c + w into xq [M][Kq] (zeros past K) and
// xs [M]: a CTA per 8 rows, so that M = 4096 fills the card four times.
template <bool XVEC, int NV>
__global__ void __launch_bounds__(THREADS)
w8a8_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                  float* __restrict__ xs_out, int M, int K, int Kq) {
  grid_wait();
  grid_launch_next();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  int8_t* qr = xq + static_cast<int64_t>(row) * Kq;
  if constexpr (NV > 0) {
    uint32_t q[1][NV];
    float xs[1];
    quant_rows<XVEC, NV, 1>(x, M, K, row, lane, q, xs);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = (lane + 32 * j) * 4;
      if (k < Kq) *reinterpret_cast<uint32_t*>(qr + k) = q[0][j];
    }
    if (lane == 0) xs_out[row] = xs[0];
  } else {  // K > KREG: two passes over the row (the second from L1 / L2)
    const float* xr = x + static_cast<int64_t>(row) * K;
    float amax = 0.0f;
    for (int k = lane * 4; k < K; k += 128) amax = amax4(amax, load4<XVEC>(xr, true, k, K));
    const float xs = __fdiv_rn(fmaxf(warp_max(amax), 1e-12f), 127.0f);
    const float inv = __frcp_rn(xs);
    for (int k = lane * 4; k < Kq; k += 128)
      *reinterpret_cast<uint32_t*>(qr + k) = quant4(load4<XVEC>(xr, true, k, K), xs, inv);
    if (lane == 0) xs_out[row] = xs;
  }
}

// ---------------------------------------------------------- product, mma.sync

template <int BM, int BN>
struct Tile {
  static constexpr int WR = BM >= 32 ? 2 : 1;  // warps along M
  static constexpr int WC = WARPS / WR;        // warps along N
  static constexpr int MT = BM / (16 * WR);    // mma m-tiles per warp
  static constexpr int WN = BN / WC;           // columns per warp
  static constexpr int NT = WN / 8;            // mma n-tiles per warp
  static constexpr int B8_ROWS = BN * BK / THREADS;  // byte path: weight bytes per thread
  static_assert(MT >= 1 && NT >= 1 && B8_ROWS % 4 == 0, "tile shape");
};

// Shared memory: the ring of nst stages of (BM + BN) x BS_LD bytes,
// overlaid by the f32 output tile [BM][BN + 4], then xs [BM], wscale [BN]
// and bias [BN] of the tile.
__host__ __device__ constexpr int tile_smem(int bm, int bn, int nst) {
  return (nst * (bm + bn) * BS_LD > bm * (bn + 4) * 4 ? nst * (bm + bn) * BS_LD
                                                      : bm * (bn + 4) * 4) +
         (bm + 2 * bn) * 4;
}

// The epilogue's operands: the tile's columns of wscale and bias, and its
// rows of xs. No commit.
template <int BN>
__device__ __forceinline__ void issue_epilogue_cols(float* ws_s, float* b_s,
                                                    const float* __restrict__ wscale,
                                                    const float* __restrict__ bias, int N, int n0,
                                                    int tid) {
  for (int i = tid; i < BN; i += THREADS) {
    const bool in = n0 + i < N;
    cp_async4(ws_s + i, in ? wscale + n0 + i : wscale, in);
    cp_async4(b_s + i, in && bias != nullptr ? bias + n0 + i : wscale, in && bias != nullptr);
  }
}

template <int BM>
__device__ __forceinline__ void issue_epilogue_rows(float* xs_s, const float* __restrict__ xs,
                                                    int M, int m0, int tid) {
  for (int i = tid; i < BM; i += THREADS) {
    const bool in = m0 + i < M;
    cp_async4(xs_s + i, in ? xs + m0 + i : xs, in);
  }
}

// Chunk [k0, k0 + BK) of the tile's BM rows of xq into `as` (rows past M
// zero-filled). No commit.
template <int BM>
__device__ __forceinline__ void issue_a(int8_t* as, const int8_t* __restrict__ xq, int M, int Kq,
                                        int m0, int k0, int tid) {
#pragma unroll
  for (int seg = tid; seg < BM * BK / 16; seg += THREADS) {
    const int m = m0 + (seg >> 2);
    const bool pred = m < M;
    cp_async16(as + (seg >> 2) * BS_LD + (seg & 3) * 16,
               pred ? xq + static_cast<int64_t>(m) * Kq + k0 + (seg & 3) * 16 : xq, pred);
  }
}

// 16-byte path (ldw % 16 == 0): weight chunk [n0, n0 + BN) x [k0, k0 + BK)
// into `bs` with cp.async; pieces starting past N or K are zero-filled (the
// bytes of a piece past K are row padding, met by zeros of xq). No commit.
template <int BN>
__device__ __forceinline__ void issue_b16(int8_t* bs, const int8_t* __restrict__ wq, int N,
                                          int K, int ldw, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < BN * BK / 16 / THREADS; ++i) {
    const int seg = tid + i * THREADS;
    const int n = n0 + (seg >> 2);
    const int k = k0 + (seg & 3) * 16;
    const bool pred = n < N && k < K;
    cp_async16(bs + (seg >> 2) * BS_LD + (seg & 3) * 16,
               pred ? wq + static_cast<int64_t>(n) * ldw + k : wq, pred);
  }
}

// Byte path: the chunk into registers, consecutive threads on consecutive
// bytes of a row; bytes past N or K are zero.
template <int BN>
__device__ __forceinline__ void load_b8(uint32_t (&r)[Tile<32, BN>::B8_ROWS / 4],
                                        const int8_t* __restrict__ wq, int N, int K, int ldw,
                                        int n0, int k0, int tid) {
  constexpr int ROWS = Tile<32, BN>::B8_ROWS;
#pragma unroll
  for (int i = 0; i < ROWS / 4; ++i) r[i] = 0u;
  const int k = k0 + (tid & (BK - 1));
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    // Issued unconditionally (from wq[0] when masked), masked after.
    const int n = n0 + (tid / BK) + (THREADS / BK) * i;
    const bool in = n < N && k < K;
    const uint32_t b = static_cast<uint8_t>(__ldg(wq + (in ? static_cast<int64_t>(n) * ldw + k : 0)));
    r[i >> 2] |= (in ? b : 0u) << (8 * (i & 3));
  }
}

template <int BN>
__device__ __forceinline__ void store_b8(int8_t* bs,
                                         const uint32_t (&r)[Tile<32, BN>::B8_ROWS / 4], int tid) {
  constexpr int ROWS = Tile<32, BN>::B8_ROWS;
  const int k = tid & (BK - 1);
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    bs[((tid / BK) + (THREADS / BK) * i) * BS_LD + k] =
        static_cast<int8_t>((r[i >> 2] >> (8 * (i & 3))) & 0xFFu);
}

// 32 bytes of K (one mma k-step) of the product, A rows and B rows `ld`
// bytes apart in shared memory.
template <int MT, int NT>
__device__ __forceinline__ void mma_kstep(int (&acc)[MT][NT][4], const int8_t* as,
                                          const int8_t* bs, int ld, int wm, int wn, int g, int t) {
  uint32_t a[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int8_t* p0 = as + (wm + mt * 16 + g) * ld + t * 4;
    const int8_t* p1 = p0 + 8 * ld;
    a[mt][0] = ld32(p0);
    a[mt][1] = ld32(p1);
    a[mt][2] = ld32(p0 + 16);
    a[mt][3] = ld32(p1 + 16);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int8_t* q = bs + (wn + nt * 8 + g) * ld + t * 4;
    const uint32_t b0 = ld32(q);
    const uint32_t b1 = ld32(q + 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
  }
}

// (f32(acc) * xs) * wscale (+ bias) into the f32 tile Cs [BM][BN + 4]; the
// scales and the bias of the tile's rows and columns in shared memory.
template <int MT, int NT>
__device__ __forceinline__ void tile_rescale(const int (&acc)[MT][NT][4], const float* xs_s,
                                             const float* ws_s, const float* b_s, bool has_bias,
                                             float* Cs, int cs_ld, int wm, int wn, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = wn + nt * 8 + t * 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mt * 16 + g + h * 8;
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          y[j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + j]), xs_s[r]), ws_s[c + j]);
          if (has_bias) y[j] = __fadd_rn(y[j], b_s[c + j]);
        }
        *reinterpret_cast<float2*>(Cs + r * cs_ld + c) = make_float2(y[0], y[1]);
      }
  }
}

// The activation (chosen at compile time: a switch per element slowed the
// wide layers, measured), and whole rows of the tile out: float4 stores where
// N allows (N % 4 == 0; out 16-byte aligned), else single floats.
template <int BM, int BN, int ACT>
__device__ __forceinline__ void store_rows(const float* Cs, float* __restrict__ out, int M, int N,
                                           int m0, int n0, int warp, int lane) {
  const bool vec_out = (N & 3) == 0;
  for (int r = warp; r < BM; r += WARPS) {
    const int row = m0 + r;
    if (row >= M) break;
    float* orow = out + static_cast<int64_t>(row) * N + n0;
    const float* crow = Cs + r * (BN + 4);
    for (int c = lane * 4; c < BN; c += 128) {
      const float4 y = *reinterpret_cast<const float4*>(crow + c);
      const float e[4] = {activate(y.x, ACT), activate(y.y, ACT), activate(y.z, ACT),
                          activate(y.w, ACT)};
      if (vec_out && n0 + c + 3 < N) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(e[0], e[1], e[2], e[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + c + j < N) orow[c + j] = e[j];
      }
    }
  }
}

template <int BM, int BN>
__device__ __forceinline__ void store_rows_act(const float* Cs, float* __restrict__ out, int M,
                                               int N, int m0, int n0, int act, int warp,
                                               int lane) {
  switch (act) {
    case ACT_RELU: store_rows<BM, BN, ACT_RELU>(Cs, out, M, N, m0, n0, warp, lane); break;
    case ACT_SIGMOID: store_rows<BM, BN, ACT_SIGMOID>(Cs, out, M, N, m0, n0, warp, lane); break;
    case ACT_TANH: store_rows<BM, BN, ACT_TANH>(Cs, out, M, N, m0, n0, warp, lane); break;
    case ACT_GELU: store_rows<BM, BN, ACT_GELU>(Cs, out, M, N, m0, n0, warp, lane); break;
    default: store_rows<BM, BN, ACT_NONE>(Cs, out, M, N, m0, n0, warp, lane); break;
  }
}

// CTA (i, j) computes output rows [BM i, BM i + BM) x columns [BN j, BN j + BN)
// from xq [M][Kq] and xs [M] (the quantize kernel's) and the weight, with
// mma.sync from a ring of STAGES chunks. QIN (K <= 64, one chunk): no
// quantize kernel; the CTA quantizes its rows of x itself (XVEC as there).
template <bool WVEC, bool QIN, bool XVEC, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 2)
w8a8_tile_kernel(const float* __restrict__ x, const int8_t* __restrict__ xq,
                 const float* __restrict__ xs, const int8_t* __restrict__ wq,
                 const float* __restrict__ wscale, const float* __restrict__ bias,
                 float* __restrict__ out, int M, int N, int K, int ldw, int Kq, int act) {
  using C = Tile<BM, BN>;
  constexpr int STAGE = (BM + BN) * BS_LD;  // [BM rows of xq | BN rows of the weight]
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][BN + 4], over the ring once it is dead
  float* xs_s = reinterpret_cast<float*>(smem + tile_smem(BM, BN, STAGES) - (BM + 2 * BN) * 4);
  float* ws_s = xs_s + BM;  // [BN]
  float* b_s = ws_s + BN;   // [BN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nchunks = Kq / BK;
  const int wm = (warp / C::WC) * (C::MT * 16);  // the warp's rows in the tile
  const int wn = (warp % C::WC) * C::WN;         // the warp's columns in the tile
  const int g = lane >> 2;                       // mma groupID
  const int t = lane & 3;                        // mma threadID_in_group

  // After a quantize kernel (the one kernel before this one, which waited
  // for every kernel before it and writes only xq and xs), the first weight
  // chunks load while it runs; then wait for xq. With QIN the kernel before
  // may be any kernel (a weight update): wait first. Group s holds chunk s
  // of xq (and group 0 every early weight chunk), so the ring's waits count
  // as usual.
  if constexpr (QIN) {
    grid_wait();
    grid_launch_next();
  }
  [[maybe_unused]] uint32_t breg[C::B8_ROWS / 4];
  issue_epilogue_cols<BN>(ws_s, b_s, wscale, bias, N, n0, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st >= nchunks) break;
    int8_t* bs = ring + st * STAGE + BM * BS_LD;
    if constexpr (WVEC) {
      issue_b16<BN>(bs, wq, N, K, ldw, n0, st * BK, tid);
    } else {
      load_b8<BN>(breg, wq, N, K, ldw, n0, st * BK, tid);
      store_b8<BN>(bs, breg, tid);
    }
  }
  if constexpr (QIN) {
    // Warp w quantizes rows BM / 8 w .. + BM / 8 - 1 of the tile into chunk 0.
    constexpr int RB = BM / WARPS;
    uint32_t q[RB][1];
    float s[RB];
    quant_rows<XVEC, 1, RB>(x, M, K, m0 + warp * RB, lane, q, s);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int r = warp * RB + i;
      if (lane < BK / 4) *reinterpret_cast<uint32_t*>(ring + r * BS_LD + lane * 4) = q[i][0];
      if (lane == 0) xs_s[r] = s[i];
    }
  } else {
    grid_wait();
    grid_launch_next();
    issue_epilogue_rows<BM>(xs_s, xs, M, m0, tid);
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (!QIN && st < nchunks) issue_a<BM>(ring + st * STAGE, xq, M, Kq, m0, st * BK, tid);
    cp_async_commit();
  }

  int acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();              // and everyone's; chunk c - 1 is consumed
    const int nx = c + STAGES - 1;
    int8_t* nxs = ring + (nx % STAGES) * STAGE;
    const bool more = nx < nchunks;
    if (more) {
      if constexpr (!QIN) issue_a<BM>(nxs, xq, M, Kq, m0, nx * BK, tid);
      if constexpr (WVEC) issue_b16<BN>(nxs + BM * BS_LD, wq, N, K, ldw, n0, nx * BK, tid);
      else load_b8<BN>(breg, wq, N, K, ldw, n0, nx * BK, tid);
    }
    cp_async_commit();
    const int8_t* cs = ring + (c % STAGES) * STAGE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32)
      mma_kstep<C::MT, C::NT>(acc, cs + ks, cs + BM * BS_LD + ks, BS_LD, wm, wn, g, t);
    if constexpr (!WVEC) {
      if (more) store_b8<BN>(nxs + BM * BS_LD, breg, tid);  // its stage was consumed at c - 1
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead: the output tile goes over it

  // Epilogue: rescale and bias into Cs, then the activation on the way out,
  // whole rows at a time.
  tile_rescale<C::MT, C::NT>(acc, xs_s, ws_s, b_s, bias != nullptr, Cs, BN + 4, wm, wn, g, t);
  __syncthreads();
  store_rows_act<BM, BN>(Cs, out, M, N, m0, n0, act, warp, lane);
}

// ------------------------------------------------- narrow product, fused

constexpr int NBM = 16;         // rows of a work item
constexpr int NARROW_MAX_K = 512;

// Row stride (bytes) of the resident weight slice and of the quantized rows:
// K padded to 64, plus 16 (conflict-free fragment loads).
__host__ __device__ constexpr int narrow_ld(int K) { return quant_kq(K) + 16; }

// Shared memory: the weight slice [BN][ld], the quantized rows [NBM][ld],
// the f32 output rows [NBM][BN + 4], then xs [NBM], wscale [BN], bias [BN].
__host__ __device__ constexpr int narrow_smem(int bn, int K) {
  return (bn + NBM) * narrow_ld(K) + NBM * (bn + 4) * 4 + (NBM + 2 * bn) * 4;
}

// K <= 512, N > 8: one kernel. CTA c keeps the weight's columns
// [BN s, BN s + BN) (s = c % S, S = ceil(N / BN) slices; the grid is a
// multiple of S) resident in shared memory and walks the row items
// c / S, c / S + grid / S, ...: each item's NBM rows of x are loaded into
// registers while the item before is multiplied and stored, then quantized
// (a warp over 2 rows) into shared memory, multiplied with mma.sync against
// the resident slice, rescaled and stored.
template <bool WVEC, bool XVEC, int NV, int BN>
__global__ void __launch_bounds__(THREADS, 2)
w8a8_narrow_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                   const float* __restrict__ wscale, const float* __restrict__ bias,
                   float* __restrict__ out, int M, int N, int K, int ldw, int act) {
  using C = Tile<NBM, BN>;
  constexpr int RB = NBM / WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Kq = quant_kq(K);
  const int ld = narrow_ld(K);
  int8_t* Ws = reinterpret_cast<int8_t*>(smem);
  int8_t* As = Ws + BN * ld;
  float* Cs = reinterpret_cast<float*>(As + NBM * ld);
  float* xs_s = Cs + NBM * (BN + 4);
  float* ws_s = xs_s + NBM;
  float* b_s = ws_s + BN;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wn = warp * C::WN;
  const int slices = (N + BN - 1) / BN;
  const int n0 = (blockIdx.x % slices) * BN;
  const int ntm = (M + NBM - 1) / NBM;
  const int tstep = gridDim.x / slices;
  int tm = blockIdx.x / slices;

  // The weights may come from the kernel before (a reload): wait first.
  grid_wait();
  grid_launch_next();
  if (tm >= ntm) return;

  float4 v[RB][NV];
  load_rows<XVEC, NV, RB>(x, M, K, tm * NBM + warp * RB, lane, v);
  // The slice, zero past N and past K (to Kq), and its scales and bias.
  issue_epilogue_cols<BN>(ws_s, b_s, wscale, bias, N, n0, tid);
  if constexpr (WVEC) {
    const int segs = Kq / 16;
    for (int s = tid; s < BN * segs; s += THREADS) {
      const int n = s / segs;
      const int k = (s - n * segs) * 16;
      const bool pred = n0 + n < N && k < K;
      cp_async16(Ws + n * ld + k, pred ? wq + static_cast<int64_t>(n0 + n) * ldw + k : wq, pred);
    }
  } else {
    constexpr int BATCH = 32;  // byte loads in flight per thread
    const int total = BN * Kq;
    for (int base = 0; base < total; base += THREADS * BATCH) {
      int8_t b[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int idx = base + j * THREADS + tid;
        const int n = idx / Kq;
        const int k = idx - n * Kq;
        const bool in = idx < total && n0 + n < N && k < K;
        const int8_t e = __ldg(wq + (in ? static_cast<int64_t>(n0 + n) * ldw + k : 0));
        b[j] = in ? e : int8_t{0};
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int idx = base + j * THREADS + tid;
        if (idx < total) Ws[(idx / Kq) * ld + idx % Kq] = b[j];
      }
    }
  }
  cp_async_commit();

  for (; tm < ntm; tm += tstep) {
    {
      uint32_t q[RB][NV];
      float s[RB];
      quant_loaded<NV, RB>(v, q, s);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = warp * RB + i;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int k = (lane + 32 * j) * 4;
          if (k < Kq) *reinterpret_cast<uint32_t*>(As + r * ld + k) = q[i][j];
        }
        if (lane == 0) xs_s[r] = s[i];
      }
    }
    if (tm + tstep < ntm)  // the next item's rows, in flight under this one
      load_rows<XVEC, NV, RB>(x, M, K, (tm + tstep) * NBM + warp * RB, lane, v);
    cp_async_wait<0>();
    __syncthreads();  // As, xs and (the first time) the slice are in place

    int acc[1][C::NT][4];
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] = 0;
    for (int ks = 0; ks < Kq; ks += 32)
      mma_kstep<1, C::NT>(acc, As + ks, Ws + ks, ld, 0, wn, g, t);
    tile_rescale<1, C::NT>(acc, xs_s, ws_s, b_s, bias != nullptr, Cs, BN + 4, 0, wn, g, t);
    __syncthreads();  // Cs is whole; As and xs are free for the next item
    store_rows_act<NBM, BN>(Cs, out, M, N, tm * NBM, n0, act, warp, lane);
  }
}

// ---------------------------------------------------------- product, wgmma

constexpr int WBK = 128;  // K bytes per chunk: one row of the 128-byte swizzle
constexpr int WBN = 128;  // output columns per tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte (row r, column k < 128) of a [rows][128] K-major tile in the 128-byte
// swizzle that wgmma reads: 8-row atoms of 1024 bytes, the 16-byte piece
// index XOR row % 8.
__device__ __forceinline__ int swz(int r, int k) {
  return r * 128 + ((((k >> 4) & 7) ^ (r & 7)) << 4) + (k & 15);
}

// wgmma shared-memory descriptor: 128-byte swizzle, 8-row groups `sbo`
// bytes apart (stride byte offset); the leading byte offset is unused for a
// K-major swizzled operand whose k-step fits in one 128-byte row.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across a wgmma
// fence or wait.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 64] += A[64 x 32] B[64 x 32]^T, s8 x s8 -> s32, both from shared
// memory.
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1;\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db));
}

// The generic proxy's writes (cp.async, st.shared) become visible to the
// async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// Shared memory: 1024 bytes of slack to align the swizzle atoms, the ring of
// nst stages of (BM + WBN) x WBK bytes (overlaid by the f32 output tile),
// then xs, wscale and bias of the tile.
__host__ __device__ constexpr int wg_smem(int bm, int nst) {
  return 1024 + (nst * (bm + WBN) * WBK > bm * (WBN + 4) * 4 ? nst * (bm + WBN) * WBK
                                                             : bm * (WBN + 4) * 4) +
         (bm + 2 * WBN) * 4;
}

// Chunk [k0, k0 + WBK) of `rows` rows of `src` (row stride ld, valid below
// `rows_valid` and `kvalid`) into a swizzled [rows][WBK] tile; the rest is
// zero-filled. No commit.
template <int ROWS>
__device__ __forceinline__ void issue_swz(int8_t* dst, const int8_t* __restrict__ src, int r0,
                                          int rows_valid, int ld, int k0, int kvalid, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * (WBK / 16) / THREADS; ++i) {
    const int seg = tid + i * THREADS;
    const int r = seg >> 3;
    const int k = k0 + (seg & 7) * 16;
    const bool pred = r0 + r < rows_valid && k < kvalid;
    cp_async16(dst + swz(r, (seg & 7) * 16),
               pred ? src + static_cast<int64_t>(r0 + r) * ld + k : src, pred);
  }
}

// The product on the tensor cores' asynchronous path, 16-byte weight rows
// only. CTA (i, j) computes output rows [BM i, BM i + BM) x columns
// [128 j, 128 j + 128) with two warpgroups: for BM 128 each takes 64 rows
// and both 64-column halves, for BM 64 each takes one half. Both operands
// stream through a ring of STAGES swizzled chunks of 128 bytes of K
// (cp.async); per chunk each warpgroup issues 4 or 8 wgmma m64n64k32 and
// waits for them before the chunk's stage is refilled.
template <int BM, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
w8a8_wgmma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const int8_t* __restrict__ wq, const float* __restrict__ wscale,
                  const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K,
                  int ldw, int Kq, int act) {
  constexpr int STAGE = (BM + WBN) * WBK;
  constexpr int HALVES = BM / 64;  // 64-column halves a warpgroup takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][WBN + 4], over the ring once it is dead
  float* xs_s = reinterpret_cast<float*>(smem + wg_smem(BM, STAGES) - 1024 - (BM + 2 * WBN) * 4);
  float* ws_s = xs_s + BM;  // [WBN]
  float* b_s = ws_s + WBN;  // [WBN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * WBN;
  const int nchunks = (Kq + WBK - 1) / WBK;
  const int wg = warp >> 2;
  const int row0 = BM == 128 ? wg * 64 : 0;   // the warpgroup's rows
  const int col0 = BM == 128 ? 0 : wg * 64;   // and its first column

  // As in the mma.sync kernel: the first weight chunks before the wait.
  issue_epilogue_cols<WBN>(ws_s, b_s, wscale, bias, N, n0, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st)
    if (st < nchunks) issue_swz<WBN>(ring + st * STAGE + BM * WBK, wq, n0, N, ldw, st * WBK, K, tid);
  grid_wait();
  grid_launch_next();
  issue_epilogue_rows<BM>(xs_s, xs, M, m0, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nchunks) issue_swz<BM>(ring + st * STAGE, xq, m0, M, Kq, st * WBK, Kq, tid);
    cp_async_commit();
  }

  int acc[HALVES][32];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    fence_proxy_async();          // and are visible to wgmma
    __syncthreads();              // everyone's; chunk c - 1's wgmmas are done
    const int nx = c + STAGES - 1;
    if (nx < nchunks) {
      int8_t* nxs = ring + (nx % STAGES) * STAGE;
      issue_swz<BM>(nxs, xq, m0, M, Kq, nx * WBK, Kq, tid);
      issue_swz<WBN>(nxs + BM * WBK, wq, n0, N, ldw, nx * WBK, K, tid);
    }
    cp_async_commit();
    const uint32_t a = smem_u32(ring + (c % STAGES) * STAGE) + row0 * WBK;
    const uint32_t b = smem_u32(ring + (c % STAGES) * STAGE + BM * WBK) + col0 * WBK;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < WBK / 32; ++ks)
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
        wgmma_m64n64k32(acc[h], wg_desc(a + ks * 32, 1024), wg_desc(b + h * 64 * WBK + ks * 32, 1024));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) fence_regs(acc[h]);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead: the output tile goes over it

  // Accumulator (row r or r + 8, column c or c + 1) of each 8-column step
  // -> (f32(acc) * xs) * wscale (+ bias) into Cs.
  const int r = row0 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = col0 + h * 64 + nt * 8 + (lane & 3) * 2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r + 8 * e;
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          y[j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[h][nt * 4 + 2 * e + j]), xs_s[row]),
                           ws_s[c + j]);
          if (bias != nullptr) y[j] = __fadd_rn(y[j], b_s[c + j]);
        }
        *reinterpret_cast<float2*>(Cs + row * (WBN + 4) + c) = make_float2(y[0], y[1]);
      }
    }
  __syncthreads();
  store_rows_act<BM, WBN>(Cs, out, M, N, m0, n0, act, warp, lane);
}

// ----------------------------------------------------------------- launch

template <typename Kern, typename... Args>
cudaError_t launch_ex(Kern kernel, dim3 grid, int smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Kern, typename... Args>
cudaError_t launch_smem(Kern kern, uint64_t& attr_set, dim3 grid, int smem, cudaStream_t s,
                        Args... args) {
  cudaError_t err = allow_smem(kern, attr_set);
  if (err != cudaSuccess) return err;
  return launch_ex(kern, grid, smem, s, args...);
}

struct Plan {
  int variant, bm, bn, stages, gx, gy, qgrid, smem;
};

template <bool XVEC, int NV>
cudaError_t launch_gemv(const Plan& p, const float* x, const int8_t* wq, const float* wscale,
                        const float* bias, float* out, int M, int N, int K, int ldw, int act,
                        cudaStream_t s) {
  static uint64_t attr_set = 0;
  return launch_smem(w8a8_gemv_kernel<XVEC, NV>, attr_set, dim3(p.gx), p.smem, s, x, wq, wscale,
                     bias, out, M, N, K, ldw, act);
}

template <bool WVEC, bool XVEC, int NV>
cudaError_t launch_narrow(const Plan& p, const float* x, const int8_t* wq, const float* wscale,
                          const float* bias, float* out, int M, int N, int K, int ldw, int act,
                          cudaStream_t s) {
#define HPS_NARROW(BN)                                                                         \
  if (p.bn == BN) {                                                                            \
    static uint64_t attr_set = 0;                                                              \
    return launch_smem(w8a8_narrow_kernel<WVEC, XVEC, NV, BN>, attr_set, dim3(p.gx), p.smem, s, \
                       x, wq, wscale, bias, out, M, N, K, ldw, act);                           \
  }
  HPS_NARROW(128)
  HPS_NARROW(64)
#undef HPS_NARROW
  return cudaErrorInvalidValue;
}

template <bool XVEC, int NV>
cudaError_t launch_quant(const Plan& p, const float* x, int8_t* xq, float* xs, int M, int K,
                         cudaStream_t s) {
  return launch_ex(w8a8_quant_kernel<XVEC, NV>, dim3(p.qgrid), 0, s, x, xq, xs, M, K,
                   quant_kq(K));
}

// The mma.sync product: with QIN (K <= 64) a 64 x 128 tile quantizing its
// own rows from a 4-stage ring, else after the quantize kernel, 64 x 128 or
// 32 x 64 tiles on an 8-stage ring.
template <bool WVEC, bool QIN, bool XVEC>
cudaError_t launch_tile(const Plan& p, const float* x, const int8_t* xq, const float* xs,
                        const int8_t* wq, const float* wscale, const float* bias, float* out,
                        int M, int N, int K, int ldw, int act, cudaStream_t s) {
#define HPS_TILE(BM, BN, NST)                                                                  \
  if (p.bm == BM && p.bn == BN && p.stages == NST) {                                           \
    static uint64_t attr_set = 0;                                                              \
    return launch_smem(w8a8_tile_kernel<WVEC, QIN, XVEC, BM, BN, NST>, attr_set,                \
                       dim3(p.gx, p.gy), p.smem, s, x, xq, xs, wq, wscale, bias, out, M, N, K,  \
                       ldw, quant_kq(K), act);                                                 \
  }
  if constexpr (QIN) {
    HPS_TILE(64, 128, 4)
  } else {
    HPS_TILE(64, 128, 8)
    HPS_TILE(32, 64, 8)
  }
#undef HPS_TILE
  return cudaErrorInvalidValue;
}

cudaError_t launch_wgmma(const Plan& p, const int8_t* xq, const float* xs, const int8_t* wq,
                         const float* wscale, const float* bias, float* out, int M, int N, int K,
                         int ldw, int act, cudaStream_t s) {
#define HPS_WG(BM, NST)                                                                        \
  if (p.bm == BM && p.stages == NST) {                                                         \
    static uint64_t attr_set = 0;                                                              \
    return launch_smem(w8a8_wgmma_kernel<BM, NST>, attr_set, dim3(p.gx, p.gy), p.smem, s, xq,   \
                       xs, wq, wscale, bias, out, M, N, K, ldw, quant_kq(K), act);             \
  }
  HPS_WG(128, 3)
  HPS_WG(64, 3)
  HPS_WG(64, 4)
#undef HPS_WG
  return cudaErrorInvalidValue;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Whether the kernel takes the plan: the launch shapes it was built for,
// the grid the shapes need and the shared memory they take (a product
// after the quantize kernel may ask for more, which it leaves unused: the
// plan does that to keep a second CTA off an SM).
bool plan_ok(const Plan& p, int M, int N, int K, bool wvec) {
  const int qgrid = cdiv(M, WARPS);  // the quantize kernel: a warp per row
  switch (p.variant) {
    case V_GEMV:
      return N <= GEMV_MAX_N && K <= GEMV_MAX_K && p.bm == WARPS && p.bn == N &&
             p.stages == 0 && p.gx >= 1 &&
             p.gy == 1 && p.qgrid == 0 && p.smem == N * gemv_kq(K);
    case V_NARROW: {
      const int slices = cdiv(N, p.bn > 0 ? p.bn : 1);
      return K <= NARROW_MAX_K && p.bm == NBM && (p.bn == 128 || p.bn == 64) && p.stages == 0 &&
             p.gy == 1 && p.qgrid == 0 && p.gx % slices == 0 && p.gx >= slices &&
             p.gx / slices <= cdiv(M, NBM) && p.smem == narrow_smem(p.bn, K) &&
             p.smem <= MAX_SMEM;
    }
    case V_TILE: {
      // QIN: 64 x 128 on 4 stages, K in one chunk, no quantize kernel.
      const bool qin = p.stages == 4 && K <= BK && p.bm == 64 && p.bn == 128 && p.qgrid == 0;
      const bool after = p.stages == 8 && p.qgrid == qgrid &&
                         ((p.bm == 64 && p.bn == 128) || (p.bm == 32 && p.bn == 64));
      return (qin || after) && p.gx == cdiv(M, p.bm) && p.gy == cdiv(N, p.bn) &&
             p.gy <= 65535 && (p.smem == tile_smem(p.bm, p.bn, p.stages) ||
                               (after && p.smem > tile_smem(p.bm, p.bn, p.stages))) &&
             p.smem <= MAX_SMEM;
    }
    case V_WGMMA:
      return wvec &&
             ((p.bm == 128 && p.stages == 3) || (p.bm == 64 && (p.stages == 3 || p.stages == 4))) &&
             p.bn == WBN && p.gx == cdiv(M, p.bm) && p.gy == cdiv(N, WBN) && p.gy <= 65535 &&
             p.qgrid == qgrid && p.smem >= wg_smem(p.bm, p.stages) && p.smem <= MAX_SMEM;
    default:
      return false;
  }
}

}  // namespace

extern "C" {

const char* hps_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [M, K] f32, wq [N, ldw] int8 with ldw >= K (columns past K are row
// padding and are ignored), wscale [N] f32, bias [N] f32 or null, out [M, N]
// f32, all contiguous. xvec: K % 4 == 0 and x 16-byte aligned; wvec:
// ldw % 16 == 0 and wq 16-byte aligned (the caller checks); out 16-byte
// aligned. act: 0 none, 1 relu, 2 sigmoid, 3 tanh, 4 gelu (tanh form).
// The launch plan (variant 0 GEMV, 1 narrow, 2 mma.sync product, 3 wgmma
// product; rows and columns of an output tile; ring stages; the grid; the
// quantize kernel's grid, 0 for the GEMV, the narrow kernel and the mma.sync
// product of K <= 64, which quantize their own rows; the dynamic shared
// memory of the GEMV, the narrow kernel or the product) comes from the caller (ops/quant_matmul.py
// k5_plan); a plan the kernel does not take returns cudaErrorInvalidValue.
// With a quantize grid the product takes `scratch`: M * Kq bytes of xq
// (Kq = K rounded up to 64) then M floats of xs, 16-byte aligned (else
// null). Returns cudaGetLastError() after the launches.
int hps_w8a8_dense(int device, void* stream, const float* x, const int8_t* wq,
                   const float* wscale, const float* bias, float* out, int M, int N,
                   int K, int ldw, int act, int xvec, int wvec, int variant, int bm, int bn,
                   int stages, int gx, int gy, int qgrid, int smem, int8_t* scratch) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0 || N == 0) return 0;
  const Plan p{variant, bm, bn, stages, gx, gy, qgrid, smem};
  if (M < 0 || N < 0 || K <= 0 || K > MAX_K || ldw < K || act < ACT_NONE || act > ACT_GELU ||
      !plan_ok(p, M, N, K, wvec != 0) || (p.qgrid > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nv = K <= 128 ? 1 : K <= 256 ? 2 : K <= 512 ? 4 : K <= KREG ? 8 : 0;
  if (variant == V_GEMV) {
#define HPS_GEMV(XV, NV) launch_gemv<XV, NV>(p, x, wq, wscale, bias, out, M, N, K, ldw, act, s)
    if (xvec) {
      err = nv == 1 ? HPS_GEMV(true, 1) : nv == 2 ? HPS_GEMV(true, 2) : nv == 4 ? HPS_GEMV(true, 4)
          : nv == 8 ? HPS_GEMV(true, 8) : HPS_GEMV(true, 0);
    } else {
      err = nv == 1 ? HPS_GEMV(false, 1) : nv == 2 ? HPS_GEMV(false, 2)
          : nv == 4 ? HPS_GEMV(false, 4) : nv == 8 ? HPS_GEMV(false, 8) : HPS_GEMV(false, 0);
    }
#undef HPS_GEMV
    return static_cast<int>(err);
  }
  if (variant == V_NARROW) {
#define HPS_NV(WV, XV)                                                                 \
  (nv == 1   ? launch_narrow<WV, XV, 1>(p, x, wq, wscale, bias, out, M, N, K, ldw, act, s) \
   : nv == 2 ? launch_narrow<WV, XV, 2>(p, x, wq, wscale, bias, out, M, N, K, ldw, act, s) \
             : launch_narrow<WV, XV, 4>(p, x, wq, wscale, bias, out, M, N, K, ldw, act, s))
    err = xvec ? (wvec ? HPS_NV(true, true) : HPS_NV(false, true))
               : (wvec ? HPS_NV(true, false) : HPS_NV(false, false));
#undef HPS_NV
    return static_cast<int>(err);
  }
  if (p.qgrid == 0) {  // V_TILE, K <= 64: the product quantizes its own rows
#define HPS_QIN(WV, XV) \
  launch_tile<WV, true, XV>(p, x, nullptr, nullptr, wq, wscale, bias, out, M, N, K, ldw, act, s)
    err = xvec ? (wvec ? HPS_QIN(true, true) : HPS_QIN(false, true))
               : (wvec ? HPS_QIN(true, false) : HPS_QIN(false, false));
#undef HPS_QIN
    return static_cast<int>(err);
  }
  int8_t* xq = scratch;
  float* xs = reinterpret_cast<float*>(scratch + static_cast<int64_t>(M) * quant_kq(K));
#define HPS_QUANT(XV, NV) launch_quant<XV, NV>(p, x, xq, xs, M, K, s)
  if (xvec) {
    err = nv == 1 ? HPS_QUANT(true, 1) : nv == 2 ? HPS_QUANT(true, 2)
        : nv == 4 ? HPS_QUANT(true, 4) : nv == 8 ? HPS_QUANT(true, 8) : HPS_QUANT(true, 0);
  } else {
    err = nv == 1 ? HPS_QUANT(false, 1) : nv == 2 ? HPS_QUANT(false, 2)
        : nv == 4 ? HPS_QUANT(false, 4) : nv == 8 ? HPS_QUANT(false, 8) : HPS_QUANT(false, 0);
  }
#undef HPS_QUANT
  if (err != cudaSuccess) return static_cast<int>(err);
  if (variant == V_WGMMA)
    err = launch_wgmma(p, xq, xs, wq, wscale, bias, out, M, N, K, ldw, act, s);
  else if (wvec)
    err = launch_tile<true, false, false>(p, x, xq, xs, wq, wscale, bias, out, M, N, K, ldw, act, s);
  else
    err = launch_tile<false, false, false>(p, x, xq, xs, wq, wscale, bias, out, M, N, K, ldw, act,
                                           s);
  return static_cast<int>(err);
}

}  // extern "C"
