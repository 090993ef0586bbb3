// K2 and K3: the fused DLRM dot interaction over chunked features.
//
// Replaces the Pallas kernels `_kernel_parts` and `_kernel_parts_fm` (K2,
// hugectr_backend_tpu/ops/fused_interaction.py:298 and :322) and
// `_kernel_oh_parts` (K3, the same file, :620). Per sample b:
//
//     z    = [bottom[b]; oh rows; fed feature rows]   F x D, rounded to bf16
//     out  = [bottom[b] | triu(z z^T, 1)]              D + F(F-1)/2 floats, f32
//
// The pairs come in the order of np.triu_indices(F, 1). For K3 the first
// n_oh rows after the bottom are built here from a small quantized arena,
// exactly as the Pallas body does (:626-638): z_j = bf16(f32(arena[slot]) *
// scale). For K2 n_oh is 0. A bf16 x bf16 product is exact in f32, so the
// result differs from the TPU's only in the order of the f32 sums.
//
// What bounds it on an H100: device-memory bytes. At the Criteo shape
// (B = 4096, F = 27, D = 128) it reads 56.6 MB of f32 features and writes
// 7.8 MB, against 0.37 GFLOP of pair products, which the bf16 tensor cores
// finish in well under a microsecond. The TPU kernel assembles z for a block
// of 256 samples in VMEM; here one warp owns one sample at a time: it loads
// the F feature rows (16-byte loads where the layout allows, several in
// flight per lane), rounds them to bf16 into a padded shared-memory tile,
// and runs the upper triangle of z z^T as mma.sync m16n8k16 tiles with f32
// accumulation. The pairs are staged in shared memory and written with
// coalesced stores. Features arrive as descriptors (base pointer, batch
// stride) passed by value, so general and part-major feature maps, strided
// views of a stacked [B, T, D] tensor, and parts with phantom tail rows all
// take the same code; rows that no feature names are never read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#define HPS_MAX_FEATS 128

namespace {

enum Kind { KIND_I8 = 0, KIND_FP8 = 1, KIND_BF16 = 2, KIND_F32 = 3 };

struct Feat {
  const float* ptr;
  long long stride;  // elements between consecutive samples
};

struct Params {
  int B, D, F, n_oh, n_feats;  // F = 1 + n_oh + n_feats
  int D_pad, F_pad, ld, P;     // tile geometry (bf16 elements), pair count
  long long out_ld;            // D + P
  const float* bottom;
  long long bottom_ld;
  float* out;
  const void* arena;
  long long arena_rows;
  const int* slots;
  long long slots_ld;
  const float* scales;  // null -> 1
  long long scales_ld;
  Feat feats[HPS_MAX_FEATS];
};

__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fed row i (0 = bottom, i >= 1 = feats[i - 1]) of sample b.
__device__ __forceinline__ const float* fed_row(const Params& p, int i, int b) {
  if (i == 0) return p.bottom + b * p.bottom_ld;
  const Feat& f = p.feats[i - 1];
  return f.ptr + b * f.stride;
}

__device__ __forceinline__ int fed_zrow(const Params& p, int i) {
  return i == 0 ? 0 : p.n_oh + i;
}

template <typename AT, bool VEC4>
__global__ void __launch_bounds__(256)
    dot_interaction_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tile = p.F_pad * p.ld;
  const int stage_len = (p.P + 3) & ~3;
  __nv_bfloat16* z = reinterpret_cast<__nv_bfloat16*>(smem) + warp * tile;
  float* stage =
      reinterpret_cast<float*>(smem + static_cast<size_t>(nwarps) * tile * 2) + warp * stage_len;

  // Padding rows (>= F) and columns (>= D) stay zero for every sample.
  for (int i = lane; i < tile; i += 32) z[i] = __float2bfloat16_rn(0.0f);
  __syncwarp();

  const int n_fed = 1 + p.n_feats;
  const AT* arena = static_cast<const AT*>(p.arena);
  for (int b = blockIdx.x * nwarps + warp; b < p.B; b += gridDim.x * nwarps) {
    float* out_row = p.out + b * p.out_ld;
    // Fed rows: load, copy the bottom row out, round to bf16 into the tile.
    if (VEC4) {
      const int cpr = p.D >> 2;
      const int total = n_fed * cpr;
      constexpr int U = 4;
      for (int base = 0; base < total; base += 32 * U) {
        float4 v[U];
        int fi[U], ci[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int idx = base + u * 32 + lane;
          fi[u] = -1;
          if (idx < total) {
            fi[u] = idx / cpr;
            ci[u] = (idx - fi[u] * cpr) << 2;
            v[u] = __ldg(reinterpret_cast<const float4*>(fed_row(p, fi[u], b) + ci[u]));
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (fi[u] < 0) continue;
          __nv_bfloat16* dst = z + fed_zrow(p, fi[u]) * p.ld + ci[u];
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v[u].x, v[u].y);
          *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(v[u].z, v[u].w);
          if (fi[u] == 0) {
            out_row[ci[u]] = v[u].x;
            out_row[ci[u] + 1] = v[u].y;
            out_row[ci[u] + 2] = v[u].z;
            out_row[ci[u] + 3] = v[u].w;
          }
        }
      }
    } else {
      const int total = n_fed * p.D;
      constexpr int U = 8;
      for (int base = 0; base < total; base += 32 * U) {
        float v[U];
        int fi[U], ci[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int idx = base + u * 32 + lane;
          fi[u] = -1;
          if (idx < total) {
            fi[u] = idx / p.D;
            ci[u] = idx - fi[u] * p.D;
            v[u] = __ldg(fed_row(p, fi[u], b) + ci[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (fi[u] < 0) continue;
          z[fed_zrow(p, fi[u]) * p.ld + ci[u]] = __float2bfloat16_rn(v[u]);
          if (fi[u] == 0) out_row[ci[u]] = v[u];
        }
      }
    }
    // Gathered one-hot rows (K3): z_j = bf16(f32(arena[slot]) * scale).
    for (int j = 0; j < p.n_oh; ++j) {
      const int slot = __ldg(p.slots + j * p.slots_ld + b);
      const float s = p.scales != nullptr ? __ldg(p.scales + j * p.scales_ld + b) : 1.0f;
      __nv_bfloat16* dst = z + (1 + j) * p.ld;
      if (slot < 0 || slot >= p.arena_rows) {
        for (int k = lane; k < p.D; k += 32) dst[k] = __float2bfloat16_rn(__int_as_float(0x7fc00000));
        continue;
      }
      const AT* src = arena + static_cast<int64_t>(slot) * p.D;
      for (int k = lane; k < p.D; k += 32) dst[k] = __float2bfloat16_rn(to_f32(src[k]) * s);
    }
    __syncwarp();

    // Upper triangle of z z^T on the tensor cores, into the stage.
    const int g = lane >> 2;
    const int t = lane & 3;
    for (int mt = 0; mt * 16 < p.F - 1; ++mt) {
      // Column tiles left of 16 * mt hold no pair with col > row.
      for (int nt = 2 * mt; nt * 8 < p.F; ++nt) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* a_lo = z + (mt * 16 + g) * p.ld + 2 * t;
        const __nv_bfloat16* a_hi = a_lo + 8 * p.ld;
        const __nv_bfloat16* bq = z + (nt * 8 + g) * p.ld + 2 * t;
        for (int kk = 0; kk < p.D_pad; kk += 16) {
          mma_bf16(c, ld32(a_lo + kk), ld32(a_hi + kk), ld32(a_lo + kk + 8),
                   ld32(a_hi + kk + 8), ld32(bq + kk), ld32(bq + kk + 8));
        }
        const int rows[2] = {mt * 16 + g, mt * 16 + g + 8};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rows[h];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nt * 8 + 2 * t + e;
            if (r < col && col < p.F) {
              stage[r * p.F - r * (r + 1) / 2 + (col - r - 1)] = c[2 * h + e];
            }
          }
        }
      }
    }
    __syncwarp();
    for (int q = lane; q < p.P; q += 32) out_row[p.D + q] = stage[q];
    __syncwarp();  // the next sample overwrites z and the stage
  }
}

template <typename AT>
int launch(Params& p, bool vec4, cudaStream_t stream) {
  const size_t per_warp =
      static_cast<size_t>(p.F_pad) * p.ld * 2 + static_cast<size_t>((p.P + 3) & ~3) * 4;
  int warps = static_cast<int>((48 * 1024) / per_warp);
  if (warps > 8) warps = 8;
  if (warps < 1) warps = 1;
  const size_t smem = per_warp * warps;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = vec4 ? dot_interaction_kernel<AT, true> : dot_interaction_kernel<AT, false>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (p.B + warps - 1) / warps;
  kern<<<blocks, warps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hps_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bottom [B, D] f32 (row stride bottom_ld); n_feats fed features, feature i
// at feat_ptrs[i] + b * feat_strides[i] (f32, contiguous over D); n_oh
// gathered features from `arena` [arena_rows, D] of `arena_kind`, slot of
// (j, b) at slots[j * slots_ld + b], scale at scales[j * scales_ld + b]
// (scales may be null); out [B, D + P] f32. `vec4`: D % 4 == 0 and every
// fed row start is 16-byte aligned (the caller checks). Returns
// cudaGetLastError() after the launch.
int hps_dot_interaction(int device, void* stream, int B, int D, int n_oh, int n_feats,
                        const float* bottom, long long bottom_ld,
                        const long long* feat_ptrs, const long long* feat_strides,
                        int arena_kind, const void* arena, long long arena_rows,
                        const int* slots, long long slots_ld, const float* scales,
                        long long scales_ld, float* out, int vec4) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_feats > HPS_MAX_FEATS || n_feats < 0 || n_oh < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  Params p;
  p.B = B;
  p.D = D;
  p.n_oh = n_oh;
  p.n_feats = n_feats;
  p.F = 1 + n_oh + n_feats;
  p.D_pad = (D + 15) / 16 * 16;
  p.F_pad = (p.F + 15) / 16 * 16;
  p.ld = p.D_pad + 8;  // 16-byte row skew: conflict-free fragment loads
  p.P = p.F * (p.F - 1) / 2;
  p.out_ld = D + p.P;
  p.bottom = bottom;
  p.bottom_ld = bottom_ld;
  p.out = out;
  p.arena = arena;
  p.arena_rows = arena_rows;
  p.slots = slots;
  p.slots_ld = slots_ld;
  p.scales = scales;
  p.scales_ld = scales_ld;
  for (int i = 0; i < n_feats; ++i) {
    p.feats[i].ptr = reinterpret_cast<const float*>(feat_ptrs[i]);
    p.feats[i].stride = feat_strides[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec4 != 0;
  switch (arena_kind) {
    case KIND_I8: return launch<int8_t>(p, v, s);
    case KIND_FP8: return launch<__nv_fp8_e4m3>(p, v, s);
    case KIND_BF16: return launch<__nv_bfloat16>(p, v, s);
    case KIND_F32: return launch<float>(p, v, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
