// K6: the one-hot worklist gather over a small-table arena, both bodies.
//
// Replaces the Pallas kernels `_onehot_kernel` (v1, rows times the summed
// scales; hugectr_backend_tpu/ops/onehot_gather.py:146) and
// `_onehot_rows_kernel` (v2, rows only; :218). For key n in key tile
// kt = n / m_tile, walk that tile's run of plan steps (run offsets in CSR
// form, `offsets[kt] .. offsets[kt + 1]`, row tiles `rt` in run order). At
// step s with r0 = rt[s] * r_tile the part is f32(values[slot]) when
// r0 <= slot < r0 + r_tile and 0 otherwise (v1: also scales[slot] or 0, 1
// per hit without scales); the first step of the run assigns its part, later
// steps add theirs. v1 writes rows * svec, v2 rows. A slot in none of its
// tile's row tiles gives a zero row.
//
// What bounds it on an H100: device-memory bytes. The TPU kernel multiplies
// a 0/1 mask by every row tile of the key's member on the MXU, because the
// MXU reads a tile sequentially and a TPU has no cheap per-row gather. On
// Hopper that product would cost 2 * m_tile * r_tile * D operations per step
// (about 28 GFLOP for the 16 tiny Criteo tables at batch 4096), far above
// the bytes of the gather. So this kernel is a masked gather: a group of
// threads shares one key, each moving 16 bytes of the row with one vector
// load (as csrc/gather_dequant.cu does); every thread of the group scans the
// key tile's run (the same `rt` words for every key of the tile, so the
// loads are broadcasts served from L1) and loads the row only at a step that
// matched. The row is never read for a slot outside the arena, and unmatched
// steps add 0 without touching the row, so a non-finite value in another row
// of the tile reaches no other key (the TPU body's 0 * inf gives NaN there).
//
// Storage types: int8, fp8 e4m3 (exact in f32, as the TPU's cast through
// bf16), bf16, f32. The wrapper refuses nibble-packed int4.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

enum Kind { KIND_I8 = 0, KIND_FP8 = 1, KIND_BF16 = 2, KIND_F32 = 3 };

__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// One thread per (key, chunk); a chunk is VEC stored elements (16 bytes when
// VEC > 1). `width` is the row width D in elements. V1: scale and multiply.
template <typename T, int VEC, bool V1>
__global__ void onehot_gather_kernel(const T* __restrict__ values, int width,
                                     const int* __restrict__ slots, int64_t n,
                                     const int* __restrict__ offsets,
                                     const int* __restrict__ rt, int m_tile, int r_tile,
                                     const float* __restrict__ scales,
                                     float* __restrict__ out) {
  const int chunks = width / VEC;
  const int64_t total = n * chunks;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / chunks;
    const int c = static_cast<int>(i - r * chunks);
    const int64_t slot = __ldg(slots + r);
    const int64_t kt = r / m_tile;
    const int s0 = __ldg(offsets + kt);
    const int s1 = __ldg(offsets + kt + 1);
    const T* src = values + slot * width + static_cast<int64_t>(c) * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    float sacc = 0.0f;
    for (int s = s0; s < s1; ++s) {
      const int64_t r0 = static_cast<int64_t>(__ldg(rt + s)) * r_tile;
      const bool hit = slot >= r0 && slot < r0 + r_tile;
      float part[VEC];
      if (hit) {
        if constexpr (VEC == 1) {
          part[0] = to_f32(src[0]);
        } else {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < VEC; ++j) part[j] = to_f32(e[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) part[j] = 0.0f;
      }
      if (s == s0) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = part[j];
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
      }
      if constexpr (V1) {
        const float sp = hit ? (scales != nullptr ? __ldg(scales + slot) : 1.0f) : 0.0f;
        sacc = s == s0 ? sp : __fadd_rn(sacc, sp);
      }
    }
    float* dst = out + r * width + static_cast<int64_t>(c) * VEC;
    if constexpr (V1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __fmul_rn(acc[j], sacc);
    }
    if constexpr (VEC == 1) {
      dst[0] = acc[0];
    } else {
      float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j) {
        d4[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <typename T, int VEC>
void launch(bool v1, const void* values, int width, const int* slots, int64_t n,
            const int* offsets, const int* rt, int m_tile, int r_tile,
            const float* scales, float* out, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * (width / VEC);
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  const T* v = static_cast<const T*>(values);
  if (v1) {
    onehot_gather_kernel<T, VEC, true><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        v, width, slots, n, offsets, rt, m_tile, r_tile, scales, out);
  } else {
    onehot_gather_kernel<T, VEC, false><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        v, width, slots, n, offsets, rt, m_tile, r_tile, scales, out);
  }
}

}  // namespace

extern "C" {

const char* hps_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// values [R_pad, width] of `kind` storage; slots [n] int32 with n a multiple
// of m_tile; offsets [n / m_tile + 1] and rt [S] int32 (validated on the
// host: every run non-empty, every row tile inside the arena); v1: scale and
// multiply (scales [R_pad] f32, or null for ones), else rows only; out
// [n, width] f32. `vec`: a row is a whole number of 16-byte chunks and
// `values`/`out` are 16-byte aligned (the caller checks). Returns
// cudaGetLastError() after the launch.
int hps_onehot_gather(int device, void* stream, int kind, const void* values, int width,
                      const int* slots, int64_t n, const int* offsets, const int* rt,
                      int m_tile, int r_tile, int v1, const float* scales, float* out,
                      int vec) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0 || width == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scaled = v1 != 0;
  switch (kind) {
    case KIND_I8:
      vec ? launch<int8_t, 16>(scaled, values, width, slots, n, offsets, rt, m_tile, r_tile, scales, out, s)
          : launch<int8_t, 1>(scaled, values, width, slots, n, offsets, rt, m_tile, r_tile, scales, out, s);
      break;
    case KIND_FP8:
      vec ? launch<__nv_fp8_e4m3, 16>(scaled, values, width, slots, n, offsets, rt, m_tile, r_tile, scales, out, s)
          : launch<__nv_fp8_e4m3, 1>(scaled, values, width, slots, n, offsets, rt, m_tile, r_tile, scales, out, s);
      break;
    case KIND_BF16:
      vec ? launch<__nv_bfloat16, 8>(scaled, values, width, slots, n, offsets, rt, m_tile, r_tile, scales, out, s)
          : launch<__nv_bfloat16, 1>(scaled, values, width, slots, n, offsets, rt, m_tile, r_tile, scales, out, s);
      break;
    case KIND_F32:
      vec ? launch<float, 4>(scaled, values, width, slots, n, offsets, rt, m_tile, r_tile, scales, out, s)
          : launch<float, 1>(scaled, values, width, slots, n, offsets, rt, m_tile, r_tile, scales, out, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
