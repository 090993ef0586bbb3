// K5: one w8a8 dense layer, fused.
//
// Replaces the Pallas kernels `_kernel` and `_no_bias_kernel`
// (hugectr_backend_tpu/ops/quant_matmul.py:49 and :108) with the semantics
// they share with the XLA formulation `xla_w8a8` (the same file, :112):
//
//     xs[m]    = max(max_k |x[m, k]|, 1e-12) / 127           (IEEE divide)
//     xq[m, k] = clip(round_half_even(x[m, k] / xs[m]), -127, 127)
//     y[m, n]  = act((f32(sum_k xq[m, k] * wq[n, k]) * xs[m]) * wscale[n] + bias[n])
//
// with x [M, K] f32, wq [N, K] int8 (the nn.Linear layout: K contiguous, the
// "col" operand of mma), wscale [N] f32, bias [N] f32 or null, and act one of
// none, relu, sigmoid, tanh, gelu (tanh form). The int32 sum is exact, and
// the divides, the rounding and the rescale are done with the round-to-
// nearest intrinsics in this order (no FMA contraction), so for act none and
// relu the result equals the plain PyTorch version bit for bit. Inputs are
// taken to be finite.
//
// What bounds it on an H100: device-memory bytes. At the DLRM's widths
// (M = 4096, K and N up to 1024) a layer reads 4MK bytes of x and KN of
// weights and writes 4MN; at 3.35 TB/s that takes longer than the 2MKN int8
// operations take on the tensor cores (1979 TOP/s). The TPU kernel keeps the
// whole [K, N] weight in VMEM and sweeps M; here a CTA owns a 64 x 128 output
// tile. The CTAs of one row tile (up to 8 column tiles) form a thread-block
// cluster: each quantizes its share of the 64 rows and writes them into the
// shared memory of every CTA of the cluster (distributed shared memory), so
// x is read and quantized once, not once per column tile (8 times over at
// N = 1024, which cost more than the whole product, measured).
//
// 1. Quantize: a warp takes one row at a time; for K <= 1024 the whole row
//    sits in registers (a lane holds 4 columns in each 128), every load
//    issued before any arithmetic; beyond that, a second read from L1/L2.
//    The int8 row goes to every CTA of the cluster, zero-padded to a
//    multiple of 64 in K, so the K tail needs no masking in the product (a
//    zero adds nothing). Each value is scaled by RN(1 / xs) and rounded;
//    only a value that lands within 4e-5 of a half-integer takes the IEEE
//    divide, which gives the same integer as the divide for every value
//    (see quant1): a divide per element made the quantize phase bound by
//    instruction issue.
// 2. Product: the weight streams in chunks of 128 x 64 bytes, through a
//    4-stage cp.async ring when its rows are a multiple of 16 bytes (the
//    first three chunks fly while x is quantized; the serving path pads its
//    K = 479 layer's rows to 480), else through registers one chunk ahead, a
//    byte at a time (K = 13 in the DLRM). Eight warps each run a
//    32 x 32 block of mma.sync m16n8k32 s8 x s8 -> s32.
// 3. Epilogue: rescale and bias on the accumulators, staged as an f32 tile in
//    shared memory (over the dead operand tiles); then the activation on the
//    way out, whole rows with float4 stores.
// No wgmma, TMA or persistent scheduling yet.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;        // rows of x per CTA
constexpr int BN = 128;       // output columns per CTA
constexpr int BK = 64;        // K bytes per weight chunk (two mma k-steps)
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int WARPS = THREADS / 32;
constexpr int WN = BN / 4;    // columns per warp
constexpr int NT = WN / 8;    // mma n-tiles per warp
constexpr int SKEW = 16;      // row padding (bytes): conflict-free fragment loads
constexpr int BS_LD = BK + SKEW;
constexpr int CS_LD = BN + 4; // f32 output tile row stride
constexpr int STAGES = 4;     // cp.async ring depth (16-byte weight path)
constexpr int KREG = 1024;    // up to this K, a row is quantized from registers
constexpr int MAX_CLUSTER = 8;  // portable thread-block cluster size
constexpr int MAX_SMEM = 232448;  // 227 KB of dynamic shared memory per block

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

// Row r of the tile (`xr`; zeros when `live` is false) -> int8 at row r of
// As in every CTA of the cluster, zero-padded to Kpad; its scale -> xs_s[r]
// in every CTA.
template <bool XVEC>
__device__ __forceinline__ void quantize_row(cg::cluster_group& cluster, const float* xr,
                                             bool live, int8_t* As, int as_ld, float* xs_s, int r,
                                             int K, int Kpad, int lane) {
  const unsigned ranks = cluster.num_blocks();
  float xs;
  if (K <= KREG) {
    float4 v[KREG / 128];
#pragma unroll
    for (int j = 0; j < KREG / 128; ++j) v[j] = load4<XVEC>(xr, live, (lane + 32 * j) * 4, K);
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < KREG / 128; ++j) amax = amax4(amax, v[j]);
    xs = __fdiv_rn(fmaxf(warp_max(amax), 1e-12f), 127.0f);
    const float inv = __frcp_rn(xs);
#pragma unroll
    for (int j = 0; j < KREG / 128; ++j) {
      const int k = (lane + 32 * j) * 4;
      if (k >= Kpad) break;
      const uint32_t q = quant4(v[j], xs, inv);
      for (unsigned d = 0; d < ranks; ++d)
        *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(As + r * as_ld + k, d)) = q;
    }
  } else {
    float amax = 0.0f;
    for (int k = lane * 4; k < K; k += 128) amax = amax4(amax, load4<XVEC>(xr, live, k, K));
    xs = __fdiv_rn(fmaxf(warp_max(amax), 1e-12f), 127.0f);
    const float inv = __frcp_rn(xs);
    for (int k = lane * 4; k < Kpad; k += 128) {
      const uint32_t q = quant4(load4<XVEC>(xr, live, k, K), xs, inv);
      for (unsigned d = 0; d < ranks; ++d)
        *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(As + r * as_ld + k, d)) = q;
    }
  }
  if (lane == 0)
    for (unsigned d = 0; d < ranks; ++d) *cluster.map_shared_rank(xs_s + r, d) = xs;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16-byte path (ldw % 16 == 0): weight chunk [n0, n0 + BN) x [k0, k0 + BK)
// into `bs` with cp.async; pieces starting past N or K are zero-filled (the
// bytes of a piece past K are row padding, met by zeros of x). Always
// commits a group, so the group count stays uniform.
__device__ __forceinline__ void issue_b16(int8_t* bs, const int8_t* __restrict__ wq, int N,
                                          int K, int ldw, int n0, int k0, int tid, bool live) {
#pragma unroll
  for (int i = 0; i < BN * BK / 16 / THREADS; ++i) {
    const int seg = tid + i * THREADS;
    const int n = n0 + (seg >> 2);
    const int k = k0 + (seg & 3) * 16;
    const bool pred = live && n < N && k < K;
    cp_async16(bs + (seg >> 2) * BS_LD + (seg & 3) * 16,
               pred ? wq + static_cast<int64_t>(n) * ldw + k : wq, pred);
  }
  cp_async_commit();
}

// Byte path: the chunk into registers, consecutive threads on consecutive
// bytes of a row; bytes past N or K are zero.
constexpr int B8_ROWS = BN * BK / THREADS;  // bytes (rows of the chunk) per thread

__device__ __forceinline__ void load_b8(uint32_t (&r)[B8_ROWS / 4], const int8_t* __restrict__ wq,
                                        int N, int K, int ldw, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < B8_ROWS / 4; ++i) r[i] = 0u;
  const int k = k0 + (tid & (BK - 1));
#pragma unroll
  for (int i = 0; i < B8_ROWS; ++i) {
    // Issued unconditionally (from wq[0] when masked), masked after.
    const int n = n0 + (tid / BK) + (THREADS / BK) * i;
    const bool in = n < N && k < K;
    const uint32_t b = static_cast<uint8_t>(__ldg(wq + (in ? static_cast<int64_t>(n) * ldw + k : 0)));
    r[i >> 2] |= (in ? b : 0u) << (8 * (i & 3));
  }
}

__device__ __forceinline__ void store_b8(int8_t* bs, const uint32_t (&r)[B8_ROWS / 4], int tid) {
  const int k = tid & (BK - 1);
#pragma unroll
  for (int i = 0; i < B8_ROWS; ++i)
    bs[((tid / BK) + (THREADS / BK) * i) * BS_LD + k] =
        static_cast<int8_t>((r[i >> 2] >> (8 * (i & 3))) & 0xFFu);
}

// One chunk of the product: BK bytes of K, from As at column ka and from bc.
__device__ __forceinline__ void mma_chunk(int (&acc)[2][NT][4], const int8_t* As, int as_ld,
                                          const int8_t* bc, int ka, int wm, int wn, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 32) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* p0 = As + (wm + mt * 16 + g) * as_ld + ka + ks + t * 4;
      const int8_t* p1 = p0 + 8 * as_ld;
      a[mt][0] = ld32(p0);
      a[mt][1] = ld32(p1);
      a[mt][2] = ld32(p0 + 16);
      a[mt][3] = ld32(p1 + 16);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int8_t* q = bc + (wn + nt * 8 + g) * BS_LD + ks + t * 4;
      const uint32_t b0 = ld32(q);
      const uint32_t b1 = ld32(q + 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

// Shared memory: [As | weight ring] overlaid by the f32 output tile, then xs.
__host__ __device__ constexpr int tile_bytes(int as_ld, int nbuf) {
  return BM * as_ld + nbuf * BN * BS_LD > BM * CS_LD * 4 ? BM * as_ld + nbuf * BN * BS_LD
                                                         : BM * CS_LD * 4;
}

// The activation, and whole rows of the output tile out: float4 stores where
// N allows (N % 4 == 0; out 16-byte aligned), else single floats.
template <int ACT>
__device__ __forceinline__ void store_rows(const float* Cs, float* __restrict__ out, int M, int N,
                                           int m0, int n0, int warp, int lane) {
  const bool vec_out = (N & 3) == 0;
  for (int r = warp; r < BM; r += WARPS) {
    const int row = m0 + r;
    if (row >= M) break;
    float* orow = out + static_cast<int64_t>(row) * N + n0;
    const float* crow = Cs + r * CS_LD;
    for (int c = lane * 4; c < BN; c += 128) {
      const float4 y = *reinterpret_cast<const float4*>(crow + c);
      const float4 v = make_float4(activate(y.x, ACT), activate(y.y, ACT),
                                   activate(y.z, ACT), activate(y.w, ACT));
      if (vec_out && n0 + c + 3 < N) {
        *reinterpret_cast<float4*>(orow + c) = v;
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + c + j < N) orow[c + j] = e[j];
      }
    }
  }
}

template <bool XVEC, bool WVEC>
__global__ void __launch_bounds__(THREADS, 2)
w8a8_dense_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                  const float* __restrict__ wscale, const float* __restrict__ bias,
                  float* __restrict__ out, int M, int N, int K, int ldw, int Kpad, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NBUF = WVEC ? STAGES : 2;
  const int as_ld = Kpad + SKEW;
  int8_t* As = reinterpret_cast<int8_t*>(smem);                              // [BM][as_ld]
  int8_t* Bs = As + BM * as_ld;                                               // [NBUF][BN][BS_LD]
  float* Cs = reinterpret_cast<float*>(smem);                                 // [BM][CS_LD]
  float* xs_s = reinterpret_cast<float*>(smem + tile_bytes(as_ld, NBUF));     // [BM]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int nchunks = Kpad / BK;

  // The first weight chunks are in flight while the activations are quantized.
  [[maybe_unused]] uint32_t breg[B8_ROWS / 4];
  if constexpr (WVEC) {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st)
      issue_b16(Bs + st * BN * BS_LD, wq, N, K, ldw, n0, st * BK, tid, st < nchunks);
  } else {
    load_b8(breg, wq, N, K, ldw, n0, 0, tid);
  }

  // 1. Quantize this CTA's share of the tile's rows, into every CTA of the
  // cluster (the column tiles of this row tile), once all of them run.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = (BM + cluster.num_blocks() - 1) / cluster.num_blocks();
  const int r_end = min(BM, static_cast<int>(cluster.block_rank() + 1) * share);
  for (int r = cluster.block_rank() * share + warp; r < r_end; r += WARPS) {
    const int row = m0 + r;
    quantize_row<XVEC>(cluster, x + static_cast<int64_t>(row < M ? row : 0) * K, row < M, As,
                       as_ld, xs_s, r, K, Kpad, lane);
  }
  if constexpr (!WVEC) store_b8(Bs, breg, tid);
  cluster.sync();  // every CTA's As and xs_s are complete

  // 2. s8 x s8 -> s32 over the K chunks.
  const int wm = (warp >> 2) * 32;  // the warp's rows in the tile
  const int wn = (warp & 3) * WN;   // the warp's columns in the tile
  const int g = lane >> 2;          // mma groupID
  const int t = lane & 3;           // mma threadID_in_group
  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  if constexpr (WVEC) {
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
      __syncthreads();              // and everyone's; chunk c - 1 is consumed
      const int nx = c + STAGES - 1;
      issue_b16(Bs + (nx % STAGES) * BN * BS_LD, wq, N, K, ldw, n0, nx * BK, tid, nx < nchunks);
      mma_chunk(acc, As, as_ld, Bs + (c % STAGES) * BN * BS_LD, c * BK, wm, wn, g, t);
    }
    cp_async_wait<0>();
  } else {
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) load_b8(breg, wq, N, K, ldw, n0, (c + 1) * BK, tid);
      mma_chunk(acc, As, as_ld, Bs + (c & 1) * BN * BS_LD, c * BK, wm, wn, g, t);
      if (c + 1 < nchunks) store_b8(Bs + ((c + 1) & 1) * BN * BS_LD, breg, tid);
      __syncthreads();
    }
  }
  __syncthreads();  // As and the ring are dead: the output tile goes over them

  // 3. Epilogue: (f32(acc) * xs) * wscale (+ bias) into Cs.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = wn + nt * 8 + t * 2;
    float ws[2], b[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = n0 + c + j < N;
      ws[j] = in ? __ldg(wscale + n0 + c + j) : 0.0f;
      b[j] = in && bias != nullptr ? __ldg(bias + n0 + c + j) : 0.0f;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mt * 16 + g + h * 8;
        const float xs = xs_s[r];
        float y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          y[j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + j]), xs), ws[j]);
          if (bias != nullptr) y[j] = __fadd_rn(y[j], b[j]);
        }
        *reinterpret_cast<float2*>(Cs + r * CS_LD + c) = make_float2(y[0], y[1]);
      }
    }
  }
  __syncthreads();
  // The activation, chosen once here, and whole rows out.
  switch (act) {
    case ACT_RELU: store_rows<ACT_RELU>(Cs, out, M, N, m0, n0, warp, lane); break;
    case ACT_SIGMOID: store_rows<ACT_SIGMOID>(Cs, out, M, N, m0, n0, warp, lane); break;
    case ACT_TANH: store_rows<ACT_TANH>(Cs, out, M, N, m0, n0, warp, lane); break;
    case ACT_GELU: store_rows<ACT_GELU>(Cs, out, M, N, m0, n0, warp, lane); break;
    default: store_rows<ACT_NONE>(Cs, out, M, N, m0, n0, warp, lane); break;
  }
}

template <bool XVEC, bool WVEC>
cudaError_t launch(const float* x, const int8_t* wq, const float* wscale, const float* bias,
                   float* out, int M, int N, int K, int ldw, int act, cudaStream_t stream) {
  const int kpad = (K + BK - 1) / BK * BK;
  const size_t smem = static_cast<size_t>(tile_bytes(kpad + SKEW, WVEC ? STAGES : 2)) +
                      BM * sizeof(float);
  if (smem > static_cast<size_t>(MAX_SMEM)) return cudaErrorInvalidValue;
  // Raise the shared-memory limit once per template instance and device.
  static uint64_t attr_set = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || !(attr_set >> device & 1u)) {
    err = cudaFuncSetAttribute(w8a8_dense_kernel<XVEC, WVEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    if (device < 64) attr_set |= uint64_t{1} << device;
  }
  // A cluster spans the column tiles of a row tile: all of them up to 8, else
  // the largest count up to 8 that divides them.
  const int ntiles = (N + BN - 1) / BN;
  int cx = ntiles < MAX_CLUSTER ? ntiles : MAX_CLUSTER;
  while (ntiles % cx) --cx;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntiles, (M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, w8a8_dense_kernel<XVEC, WVEC>, x, wq, wscale, bias, out, M, N, K,
                           ldw, kpad, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
// Returns cudaGetLastError() after the launch.
int hps_w8a8_dense(int device, void* stream, const float* x, const int8_t* wq,
                   const float* wscale, const float* bias, float* out, int M, int N,
                   int K, int ldw, int act, int xvec, int wvec) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || ldw < K || act < ACT_NONE || act > ACT_GELU)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xvec && wvec) {
    err = launch<true, true>(x, wq, wscale, bias, out, M, N, K, ldw, act, s);
  } else if (xvec) {
    err = launch<true, false>(x, wq, wscale, bias, out, M, N, K, ldw, act, s);
  } else if (wvec) {
    err = launch<false, true>(x, wq, wscale, bias, out, M, N, K, ldw, act, s);
  } else {
    err = launch<false, false>(x, wq, wscale, bias, out, M, N, K, ldw, act, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
