// K4 backward (and K2's): the gradient of the fused DLRM dot interaction.
//
// Replaces the XLA backward `_bwd` of the Pallas kernel K4
// (hugectr_backend_tpu/ops/fused_interaction.py:150) and its chunked twin
// `_bwd_parts` (:536). The forward computes, per sample b,
//
//     z   = [bottom[b]; features]                 F x D
//     out = [bottom[b] | triu(bf16(z) bf16(z)^T, 1)]
//
// and its backward, given g = d loss / d out ([B, D + P], P = F(F-1)/2), is
//
//     S[f, h] = g[b, D + pair(min(f, h), max(f, h))],  S[f, f] = 0
//     dz[f, :] = sum_h S[f, h] * z[h, :]              (f32 z, f32 sums)
//     g_bottom = g[b, :D] + dz[0, :],   g_feature[t] = dz[1 + t, :]
//
// The JAX backward uses the f32 z, NOT the bf16-rounded z of the forward
// (:163), and so does this kernel: nothing here is rounded to bf16, and the
// products run as f32 FMAs on the CUDA cores (no TF32, no bf16 tensor
// cores; the reference is an f32 einsum). Features come as descriptors
// (base pointer, batch stride), for z and for the gradients alike, so the
// stacked K4 input ([B, T, D] as strided views) and the chunked parts of K2
// share this kernel; a null gradient pointer is not written.
//
// What bounds it on an H100: device-memory bytes. At B = 4096, T = 26,
// D = 128 it reads g (7.85 MB) and z (56.6 MB) and writes dz (56.6 MB),
// about 121 MB or 36 us at 3.35 TB/s; its 0.76 GFLOP of f32 FMAs take about
// 11 us at the 67 TFLOP/s non-tensor f32 rate. So the loads must stream:
//
// - Persistent CTAs of 128 threads (the caller's plan: as many as fit on an
//   SM, times the SMs) walk work items (sample b, a slice of up to 128
//   columns of D), with the next items' g row (the P pair gradients and the
//   slice of the direct part) and z slice (F rows) in flight through a 2- or
//   3-stage cp.async ring while the current item computes.
// - S (F x SLD, symmetric) lives in shared memory: row h holds S[f, h] for
//   the groups of 7 rows f a thread computes, 8 floats apart (SLD = 8 x the
//   groups). Its diagonal and padding are zeroed once per CTA; per item, the
//   P staged pair gradients are scattered into it through a table of their
//   two positions, built once per CTA.
// - A thread owns 4 columns (one float4 of z; 1 column off the 16-byte
//   path) x 7 rows of dz: per h, one float4 of z and two broadcast float4s
//   of S feed 28 FMAs (7 rows, not 8, so that F = 27 wastes one row in 28,
//   not five in 32). The stores go straight from the registers, a warp over
//   consecutive columns.
// - No divide per element: every strided loop steps its (row, column) pair
//   by a quotient and remainder taken once per launch.
//
// A launch takes up to 1,024 features (their descriptors ride in the
// parameter block, a small one up to 128). S, the pair table and two ring
// stages must fit a block's shared memory, which holds F = 147 at most (with
// 4-column slices); past that ops/fused_interaction.py bwd_plan takes the
// wide route at the end of this file, which keeps nothing in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define HPS_FT 7  // rows of dz per thread
#define HPS_FG 8  // their stride in a row of S (two float4s)

namespace {

constexpr int THREADS = 128;
constexpr int MAX_SMEM = 232448;
constexpr int MAX_FEATS = 1024;   // features a launch takes
constexpr int SMALL_FEATS = 128;  // ... in the small parameter block

template <int MAXD>
struct Params {
  int B, D, F, SLD, P;        // F = 1 + n_feats; SLD = HPS_FG x ceil(F / HPS_FT)
  int DC, nslices;            // columns per work item; items per sample
  int stage_floats;           // one ring stage: g pairs, g direct slice, then z slice
  int z_off;                  // offset of the z slice in a stage (floats, multiple of 4)
  int s_floats;               // S (F x SLD), rounded up to 4
  int t_words;                // the pair table (P words), rounded up to 4
  const float* bottom;
  long long bottom_ld;
  const float* grad;          // [B, D + P], row stride grad_ld
  long long grad_ld;
  float* g_bottom;            // null: not written
  long long g_bottom_ld;
  // Feature t of sample b: feat[t] + b * feat_stride[t] (z), gfeat[t] +
  // b * gfeat_stride[t] (its gradient; a null gfeat[t] is not written).
  // 32-bit strides keep the parameter block small.
  const float* feat[MAXD];
  float* gfeat[MAXD];
  int feat_stride[MAXD];
  int gfeat_stride[MAXD];
};

template <int MAXD>
__device__ __forceinline__ const float* z_row(const Params<MAXD>& p, int f, int b) {
  if (f == 0) return p.bottom + b * p.bottom_ld;
  return p.feat[f - 1] + static_cast<long long>(b) * p.feat_stride[f - 1];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A strided walk i = start, start + 128, ... over a grid of `cols` columns,
// as (row, column) without a divide per step.
struct Walk {
  int row, col, drow, dcol, cols;
  __device__ __forceinline__ Walk(int start, int cols_) : cols(cols_) {
    row = start / cols;
    col = start - row * cols;
    drow = THREADS / cols;
    dcol = THREADS - drow * cols;
  }
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// Work item `item` (sample b, column slice s) into ring stage `st`: the P
// pair gradients, the slice of g's direct part, the F rows of the z slice.
template <int VEC, int MAXD>
__device__ __forceinline__ void issue_item(const Params<MAXD>& p, int item, float* st, int tid) {
  const int b = item / p.nslices;
  const int d0 = (item - b * p.nslices) * p.DC;
  const int dcn = min(p.DC, p.D - d0);
  const float* grow = p.grad + b * p.grad_ld;
  for (int i = tid; i < p.P; i += THREADS) cp_async4(st + i, grow + p.D + i);
  for (int i = tid; i < dcn; i += THREADS) cp_async4(st + p.P + i, grow + d0 + i);
  float* zs = st + p.z_off;
  const int cpr = p.DC / VEC;
  for (Walk w(tid, cpr); w.row < p.F; w.next()) {
    const int c = w.col * VEC;
    const float* src = z_row(p, w.row, b) + d0 + c;
    if constexpr (VEC == 4) {
      cp_async16(zs + w.row * p.DC + c, c < dcn ? src : p.bottom, c < dcn);
    } else if (c < dcn) {
      cp_async4(zs + w.row * p.DC + c, src);
    }
  }
}

// Position of dz row f in a row of S: group f / HPS_FT, HPS_FG floats each.
__device__ __forceinline__ int s_pos(int f) { return f / HPS_FT * HPS_FG + f % HPS_FT; }

template <int VEC, int NST, int MAXD>
__global__ void __launch_bounds__(THREADS)
    dot_interaction_bwd_kernel(const __grid_constant__ Params<MAXD> p) {
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                                                   // [F][SLD]
  uint32_t* pairs = reinterpret_cast<uint32_t*>(smem + p.s_floats);  // [P]
  float* ring = smem + p.s_floats + p.t_words;                       // NST stages
  const int tid = threadIdx.x;
  const int F = p.F, SLD = p.SLD, DC = p.DC;
  const int items = p.B * p.nslices;
  const int cpr = DC / VEC;           // column groups of an item
  const int groups = SLD / HPS_FG;    // row groups of dz

  // The first items in flight.
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    const int item = blockIdx.x + s * gridDim.x;
    if (item < items) issue_item<VEC, MAXD>(p, item, ring + s * p.stage_floats, tid);
    cp_async_commit();
  }
  // S's diagonal and padding stay zero; pair (lo, hi) goes to S[hi][lo] and
  // S[lo][hi] (a thread per lo).
  for (int i = tid; i < F * SLD; i += THREADS) S[i] = 0.0f;
  for (int lo = tid; lo < F; lo += THREADS) {
    uint32_t* row = pairs + lo * F - ((lo * (lo + 1)) >> 1) - lo - 1;
    for (int hi = lo + 1; hi < F; ++hi)
      row[hi] = static_cast<uint32_t>(hi * SLD + s_pos(lo)) |
                static_cast<uint32_t>(lo * SLD + s_pos(hi)) << 16;
  }

  int k = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    cp_async_wait<NST - 2>();  // this thread's copies of item k have landed
    __syncthreads();           // and everyone's; item k - 1 is done (its stage and S are free)
    const int nxt = item + (NST - 1) * gridDim.x;
    if (nxt < items)
      issue_item<VEC, MAXD>(p, nxt, ring + ((k + NST - 1) % NST) * p.stage_floats, tid);
    cp_async_commit();

    const float* st = ring + (k % NST) * p.stage_floats;
    const float* zs = st + p.z_off;
    // S from the staged pair gradients.
    for (int q = tid; q < p.P; q += THREADS) {
      const uint32_t w = pairs[q];
      const float v = st[q];
      S[w & 0xFFFFu] = v;
      S[w >> 16] = v;
    }
    __syncthreads();

    const int b = item / p.nslices;
    const int d0 = (item - b * p.nslices) * DC;
    const int dcn = min(DC, p.D - d0);
    for (Walk w(tid, cpr); w.row < groups; w.next()) {
      const int f0 = w.row * HPS_FT;
      const float* sg = S + w.row * HPS_FG;
      const int c = w.col * VEC;
      if (c >= dcn) continue;
      float acc[HPS_FT][VEC];
#pragma unroll
      for (int i = 0; i < HPS_FT; ++i)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[i][j] = 0.0f;
#pragma unroll 3
      for (int h = 0; h < F; ++h) {
        float zv[VEC];
        if constexpr (VEC == 4) {
          const float4 z4 = *reinterpret_cast<const float4*>(zs + h * DC + c);
          zv[0] = z4.x;
          zv[1] = z4.y;
          zv[2] = z4.z;
          zv[3] = z4.w;
        } else {
          zv[0] = zs[h * DC + c];
        }
        const float4 s0 = *reinterpret_cast<const float4*>(sg + h * SLD);
        const float4 s1 = *reinterpret_cast<const float4*>(sg + h * SLD + 4);
        const float sv[HPS_FT] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z};
#pragma unroll
        for (int i = 0; i < HPS_FT; ++i)
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[i][j] = fmaf(sv[i], zv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < HPS_FT; ++i) {
        const int f = f0 + i;
        if (f >= F) break;
        float* dst;
        if (f == 0) {
          if (p.g_bottom == nullptr) continue;
          dst = p.g_bottom + b * p.g_bottom_ld + d0 + c;
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[0][j] += st[p.P + c + j];  // g[b, d] + dz[0, d]
        } else {
          if (p.gfeat[f - 1] == nullptr) continue;
          dst = p.gfeat[f - 1] + static_cast<long long>(b) * p.gfeat_stride[f - 1] + d0 + c;
        }
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
          dst[0] = acc[i][0];
        }
      }
    }
  }
  cp_async_wait<0>();
}

struct Args {
  int B, D, n_feats;
  const float* bottom;
  long long bottom_ld;
  const long long *feat_ptrs, *feat_strides;
  const float* grad;
  long long grad_ld;
  float* g_bottom;
  long long g_bottom_ld;
  const long long *gfeat_ptrs, *gfeat_strides;
  int vec4, nst, dc, grid, smem;
};

template <int MAXD>
int launch(const Args& a, cudaStream_t stream) {
  Params<MAXD> p;
  p.B = a.B;
  p.D = a.D;
  p.F = 1 + a.n_feats;
  p.SLD = (p.F + HPS_FT - 1) / HPS_FT * HPS_FG;
  p.P = p.F * (p.F - 1) / 2;
  p.DC = a.dc;
  p.nslices = a.dc > 0 ? (a.D + a.dc - 1) / a.dc : 0;
  p.z_off = (p.P + a.dc + 3) & ~3;
  p.stage_floats = (p.z_off + p.F * a.dc + 3) & ~3;
  p.s_floats = (p.F * p.SLD + 3) & ~3;
  p.t_words = (p.P + 3) & ~3;
  const long long want =
      4ll * (p.s_floats + p.t_words + static_cast<long long>(a.nst) * p.stage_floats);
  // Pair positions in S are 16-bit.
  if ((a.nst != 2 && a.nst != 3) || a.dc < 1 || a.dc > a.D || (a.vec4 && a.dc % 4 != 0) ||
      (a.vec4 && a.D % 4 != 0) || a.grid < 1 || a.smem != want || a.smem > MAX_SMEM ||
      p.F * p.SLD > 65536) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.bottom = a.bottom;
  p.bottom_ld = a.bottom_ld;
  p.grad = a.grad;
  p.grad_ld = a.grad_ld;
  p.g_bottom = a.g_bottom;
  p.g_bottom_ld = a.g_bottom_ld;
  for (int t = 0; t < a.n_feats; ++t) {
    p.feat[t] = reinterpret_cast<const float*>(a.feat_ptrs[t]);
    p.feat_stride[t] = static_cast<int>(a.feat_strides[t]);
    p.gfeat[t] = reinterpret_cast<float*>(a.gfeat_ptrs[t]);
    p.gfeat_stride[t] = static_cast<int>(a.gfeat_strides[t]);
  }
  auto kern = a.vec4 ? (a.nst == 3 ? dot_interaction_bwd_kernel<4, 3, MAXD>
                                   : dot_interaction_bwd_kernel<4, 2, MAXD>)
                     : (a.nst == 3 ? dot_interaction_bwd_kernel<1, 3, MAXD>
                                   : dot_interaction_bwd_kernel<1, 2, MAXD>);
  if (a.smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<a.grid, THREADS, a.smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ the wide route
//
// Past the shared memory of the kernel above (F = 147), past 16-bit
// positions in S, or past MAX_FEATS features, the plan takes this kernel
// (ops/fused_interaction.py bwd_plan returns a BwdWidePlan). It keeps
// nothing in shared memory: a thread owns WIDE_ROWS rows f0 .. f0 + 7 of
// dz in VEC columns of one sample and walks h over the F rows of z
// (neighbouring threads on neighbouring columns, so each z load is
// coalesced), reading S[f, h] from the sample's row of g (the same words
// for every thread of a warp at D = 128: broadcasts from L1). The pair
// positions need no multiply per step: for h < f0 the 8 rows' pairs
// (h, f) are 8 consecutive words whose start moves by F - h - 2 a step;
// for h >= f0 + 8 each row's pair (f, h) moves by one. f32 FMAs in the
// order h = 0, 1, ...; the direct part of g is added to the bottom's row
// last. Feature descriptors come from a device buffer, so F has no limit
// but device memory.

constexpr int WIDE_ROWS = 8;

struct WideParams {
  int B, D, F;                // F = 1 + n_feats
  const float* bottom;
  long long bottom_ld;
  const float* grad;          // [B, D + P], row stride grad_ld
  long long grad_ld;
  float* g_bottom;            // null: not written
  long long g_bottom_ld;
  // [n_feats][4]: z row pointer, its batch stride, the gradient's row
  // pointer (0: not written), its batch stride (floats).
  const long long* desc;
};

template <int VEC>
__device__ __forceinline__ void load_z(const WideParams& p, int h, long long b, int c,
                                       float (&zv)[VEC]) {
  const float* zr = h == 0 ? p.bottom + b * p.bottom_ld
                           : reinterpret_cast<const float*>(__ldg(p.desc + 4 * (h - 1))) +
                                 b * __ldg(p.desc + 4 * (h - 1) + 1);
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(zr + c));
    zv[0] = v.x;
    zv[1] = v.y;
    zv[2] = v.z;
    zv[3] = v.w;
  } else {
    zv[0] = __ldg(zr + c);
  }
}

template <int VEC>
__device__ __forceinline__ void fma_rows(float (&acc)[WIDE_ROWS][VEC], const float (&sv)[WIDE_ROWS],
                                         const float (&zv)[VEC]) {
#pragma unroll
  for (int i = 0; i < WIDE_ROWS; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i][j] = fmaf(sv[i], zv[j], acc[i][j]);
}

// VEC 4: D % 4 == 0 and every z and gradient row 16-byte aligned.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    dot_interaction_bwd_wide_kernel(const __grid_constant__ WideParams p) {
  const int F = p.F, D = p.D;
  const int cpr = D / VEC;  // column chunks of a row
  const long long groups = (F + WIDE_ROWS - 1) / WIDE_ROWS;
  const long long per_sample = groups * cpr;
  const long long items = static_cast<long long>(p.B) * per_sample;
  for (long long it = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; it < items;
       it += static_cast<long long>(gridDim.x) * THREADS) {
    const long long b = it / per_sample;
    const long long rem = it - b * per_sample;
    const int f0 = static_cast<int>(rem / cpr) * WIDE_ROWS;
    const int c = static_cast<int>(rem % cpr) * VEC;
    const float* pairs = p.grad + b * p.grad_ld + D;
    float acc[WIDE_ROWS][VEC];
#pragma unroll
    for (int i = 0; i < WIDE_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[i][j] = 0.0f;
    float zv[VEC], sv[WIDE_ROWS];
    // h < f0: S[f0 + i, h] = pairs[ps(h) + f0 - h - 1 + i], ps(h) the first
    // pair of row h.
    long long at = f0 - 1;  // ps(0) + f0 - 0 - 1
#pragma unroll 2
    for (int h = 0; h < f0; ++h) {
      load_z<VEC>(p, h, b, c, zv);
#pragma unroll
      for (int i = 0; i < WIDE_ROWS; ++i) sv[i] = f0 + i < F ? __ldg(pairs + at + i) : 0.0f;
      fma_rows<VEC>(acc, sv, zv);
      at += F - h - 2;
    }
    // The diagonal block: each pair's position in full.
    const int h1 = min(f0 + WIDE_ROWS, F);
    for (int h = f0; h < h1; ++h) {
      load_z<VEC>(p, h, b, c, zv);
#pragma unroll
      for (int i = 0; i < WIDE_ROWS; ++i) {
        const long long f = f0 + i, lo = min(f, static_cast<long long>(h)),
                        hi = max(f, static_cast<long long>(h));
        sv[i] = f < F && f != h ? __ldg(pairs + lo * (2 * F - lo - 1) / 2 + (hi - lo - 1)) : 0.0f;
      }
      fma_rows<VEC>(acc, sv, zv);
    }
    // h >= f0 + 8: S[f, h] = pairs[ps(f) - f - 1 + h] for each row f.
    const float* row[WIDE_ROWS];
#pragma unroll
    for (int i = 0; i < WIDE_ROWS; ++i) {
      const long long f = f0 + i;
      row[i] = pairs + (f * (2 * F - f - 1) / 2 - f - 1);
    }
#pragma unroll 2
    for (int h = h1; h < F; ++h) {
      load_z<VEC>(p, h, b, c, zv);
#pragma unroll
      for (int i = 0; i < WIDE_ROWS; ++i) sv[i] = __ldg(row[i] + h);
      fma_rows<VEC>(acc, sv, zv);
    }
#pragma unroll
    for (int i = 0; i < WIDE_ROWS; ++i) {
      const int f = f0 + i;
      if (f >= F) break;
      float* dst;
      if (f == 0) {
        if (p.g_bottom == nullptr) continue;
        dst = p.g_bottom + b * p.g_bottom_ld + c;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[0][j] += __ldg(p.grad + b * p.grad_ld + c + j);
      } else {
        dst = reinterpret_cast<float*>(__ldg(p.desc + 4 * (f - 1) + 2));
        if (dst == nullptr) continue;
        dst += b * __ldg(p.desc + 4 * (f - 1) + 3) + c;
      }
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        dst[0] = acc[i][0];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* hps_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bottom [B, D] f32 (row stride bottom_ld); n_feats features, feature t of
// sample b at feat_ptrs[t] + b * feat_strides[t] (f32, contiguous over D);
// grad [B, D + P] f32 (row stride grad_ld); g_bottom [B, D] (row stride
// g_bottom_ld) or null; gradient of feature t at gfeat_ptrs[t] + b *
// gfeat_strides[t], a 0 pointer is not written. `vec4`: D % 4 == 0 and
// every z and gradient row start is 16-byte aligned (the caller checks).
// Strides fit in 31 bits (the caller checks). The launch plan (ring stages
// nst, columns per item dc, grid, dynamic shared memory) comes from the
// caller (ops/fused_interaction.py bwd_plan); a plan the kernel does not
// take returns cudaErrorInvalidValue. Returns cudaGetLastError() after the
// launch.
int hps_dot_interaction_bwd(int device, void* stream, int B, int D, int n_feats,
                            const float* bottom, long long bottom_ld,
                            const long long* feat_ptrs, const long long* feat_strides,
                            const float* grad, long long grad_ld, float* g_bottom,
                            long long g_bottom_ld, const long long* gfeat_ptrs,
                            const long long* gfeat_strides, int vec4, int nst, int dc, int grid,
                            int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_feats > MAX_FEATS || n_feats < 0 || D <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const Args a{B, D, n_feats, bottom, bottom_ld, feat_ptrs, feat_strides, grad, grad_ld,
               g_bottom, g_bottom_ld, gfeat_ptrs, gfeat_strides, vec4, nst, dc, grid, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n_feats <= SMALL_FEATS ? launch<SMALL_FEATS>(a, s) : launch<MAX_FEATS>(a, s);
}

// The wide route (see above). desc [n_feats][4] int64 on the device: feature
// t's z row pointer and batch stride, its gradient's row pointer (0: not
// written) and batch stride, in floats; vec4 and the rest as
// hps_dot_interaction_bwd.
// The plan (ops/fused_interaction.py bwd_plan, a BwdWidePlan) gives the
// grid of 128-thread CTAs. Returns cudaGetLastError() after the launch.
int hps_dot_interaction_bwd_wide(int device, void* stream, int B, int D, int n_feats,
                                 const float* bottom, long long bottom_ld, const long long* desc,
                                 const float* grad, long long grad_ld, float* g_bottom,
                                 long long g_bottom_ld, int vec4, int grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 0 || D < 1 || n_feats < 0 || grid < 1 || (n_feats > 0 && desc == nullptr) ||
      (vec4 && D % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const WideParams p{B, D, 1 + n_feats, bottom, bottom_ld, grad, grad_ld, g_bottom,
                     g_bottom_ld, desc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) dot_interaction_bwd_wide_kernel<4><<<grid, THREADS, 0, s>>>(p);
  else dot_interaction_bwd_wide_kernel<1><<<grid, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
