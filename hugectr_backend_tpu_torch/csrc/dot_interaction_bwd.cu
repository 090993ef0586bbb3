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
// 11 us at the 67 TFLOP/s non-tensor f32 rate. The design is the simple one:
// a CTA stages a few samples in shared memory, each as S (F x Fp f32, the
// symmetric pair gradients, zero diagonal and padding; Fp = F rounded up to
// 8) and z (F x D f32). Then each thread owns one column d of one sample
// and a tile of 8 rows f: for every h it reads z[h, d] once (consecutive
// lanes, consecutive columns: conflict-free) and S[h, f0..f0+7] as two
// broadcast float4 loads (S is symmetric, so row h holds column h), and
// does 8 FMAs. The stores go row by row over consecutive columns
// (coalesced). Several CTAs per SM overlap one's loads with another's FMAs.

#include <cuda_runtime.h>
#include <stdint.h>

#define HPS_MAX_FEATS 128
#define HPS_FT 8  // rows of dz per thread

namespace {

struct Params {
  int B, D, F, Fp, ns;        // F = 1 + n_feats; Fp = F rounded up to HPS_FT; ns samples per CTA
  int per_sample;             // floats of shared memory per sample
  const float* bottom;
  long long bottom_ld;
  const float* grad;          // [B, D + P], row stride grad_ld
  long long grad_ld;
  float* g_bottom;            // null: not written
  long long g_bottom_ld;
  // Feature t of sample b: feat[t] + b * feat_stride[t] (z), gfeat[t] +
  // b * gfeat_stride[t] (its gradient; a null gfeat[t] is not written).
  // 32-bit strides keep the parameter block under 4 KB.
  const float* feat[HPS_MAX_FEATS];
  float* gfeat[HPS_MAX_FEATS];
  int feat_stride[HPS_MAX_FEATS];
  int gfeat_stride[HPS_MAX_FEATS];
};

__device__ __forceinline__ const float* z_row(const Params& p, int f, int b) {
  if (f == 0) return p.bottom + b * p.bottom_ld;
  return p.feat[f - 1] + static_cast<long long>(b) * p.feat_stride[f - 1];
}

template <bool VEC4>
__global__ void __launch_bounds__(256)
    dot_interaction_bwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  const int F = p.F, D = p.D, Fp = p.Fp;
  const int b0 = blockIdx.x * p.ns;
  const int ns = min(p.ns, p.B - b0);

  // Stage S and z of each sample.
  for (int s = 0; s < ns; ++s) {
    const int b = b0 + s;
    float* S = smem + s * p.per_sample;
    float* z = S + F * Fp;
    const float* gp = p.grad + b * p.grad_ld + D;
    for (int i = threadIdx.x; i < F * Fp; i += blockDim.x) {
      const int r = i / Fp;
      const int c = i - r * Fp;
      float v = 0.0f;
      if (c < F && c != r) {
        const int lo = min(r, c), hi = max(r, c);
        v = __ldg(gp + lo * F - lo * (lo + 1) / 2 + (hi - lo - 1));
      }
      S[i] = v;
    }
    if (VEC4) {
      const int cpr = D >> 2;
      for (int i = threadIdx.x; i < F * cpr; i += blockDim.x) {
        const int f = i / cpr;
        const int c = (i - f * cpr) << 2;
        *reinterpret_cast<float4*>(z + f * D + c) =
            __ldg(reinterpret_cast<const float4*>(z_row(p, f, b) + c));
      }
    } else {
      for (int i = threadIdx.x; i < F * D; i += blockDim.x) {
        const int f = i / D;
        const int d = i - f * D;
        z[i] = __ldg(z_row(p, f, b) + d);
      }
    }
  }
  __syncthreads();

  const int nft = Fp / HPS_FT;
  const int items = ns * nft * D;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int d = it % D;
    const int rest = it / D;
    const int ft = rest % nft;
    const int s = rest / nft;
    const float* S = smem + s * p.per_sample;
    const float* z = S + F * Fp;
    const int f0 = ft * HPS_FT;
    float acc[HPS_FT];
#pragma unroll
    for (int i = 0; i < HPS_FT; ++i) acc[i] = 0.0f;
    for (int h = 0; h < F; ++h) {
      const float zh = z[h * D + d];
      const float4 s0 = *reinterpret_cast<const float4*>(S + h * Fp + f0);
      const float4 s1 = *reinterpret_cast<const float4*>(S + h * Fp + f0 + 4);
      acc[0] = fmaf(s0.x, zh, acc[0]);
      acc[1] = fmaf(s0.y, zh, acc[1]);
      acc[2] = fmaf(s0.z, zh, acc[2]);
      acc[3] = fmaf(s0.w, zh, acc[3]);
      acc[4] = fmaf(s1.x, zh, acc[4]);
      acc[5] = fmaf(s1.y, zh, acc[5]);
      acc[6] = fmaf(s1.z, zh, acc[6]);
      acc[7] = fmaf(s1.w, zh, acc[7]);
    }
    const int b = b0 + s;
#pragma unroll
    for (int i = 0; i < HPS_FT; ++i) {
      const int f = f0 + i;
      if (f >= F) break;
      if (f == 0) {
        if (p.g_bottom != nullptr) {
          p.g_bottom[b * p.g_bottom_ld + d] = __ldg(p.grad + b * p.grad_ld + d) + acc[i];
        }
      } else if (p.gfeat[f - 1] != nullptr) {
        p.gfeat[f - 1][static_cast<long long>(b) * p.gfeat_stride[f - 1] + d] = acc[i];
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
// every z row start is 16-byte aligned (the caller checks). Strides fit in
// 31 bits (the caller checks). Returns cudaGetLastError() after the launch.
int hps_dot_interaction_bwd(int device, void* stream, int B, int D, int n_feats,
                            const float* bottom, long long bottom_ld,
                            const long long* feat_ptrs, const long long* feat_strides,
                            const float* grad, long long grad_ld, float* g_bottom,
                            long long g_bottom_ld, const long long* gfeat_ptrs,
                            const long long* gfeat_strides, int vec4) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_feats > HPS_MAX_FEATS || n_feats < 0 || D <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  Params p;
  p.B = B;
  p.D = D;
  p.F = 1 + n_feats;
  p.Fp = (p.F + HPS_FT - 1) / HPS_FT * HPS_FT;
  p.per_sample = (p.F * p.Fp + p.F * D + 3) & ~3;  // keeps each sample's S 16-byte aligned
  p.bottom = bottom;
  p.bottom_ld = bottom_ld;
  p.grad = grad;
  p.grad_ld = grad_ld;
  p.g_bottom = g_bottom;
  p.g_bottom_ld = g_bottom_ld;
  for (int t = 0; t < n_feats; ++t) {
    p.feat[t] = reinterpret_cast<const float*>(feat_ptrs[t]);
    p.feat_stride[t] = static_cast<int>(feat_strides[t]);
    p.gfeat[t] = reinterpret_cast<float*>(gfeat_ptrs[t]);
    p.gfeat_stride[t] = static_cast<int>(gfeat_strides[t]);
  }
  const size_t per_sample_bytes = static_cast<size_t>(p.per_sample) * 4;
  int ns = static_cast<int>((48 * 1024) / per_sample_bytes);
  if (ns > 8) ns = 8;
  if (ns < 1) ns = 1;
  p.ns = ns;
  const size_t smem = per_sample_bytes * ns;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = vec4 ? dot_interaction_bwd_kernel<true> : dot_interaction_bwd_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + ns - 1) / ns;
  kern<<<blocks, 256, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
