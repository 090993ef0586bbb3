// K1: embedding gather + dequantize.
//
// Replaces the Pallas kernel `_grouped_gather_kernel`
// (hugectr_backend_tpu/ops/dequant_gather.py:54, called from
// `pallas_grouped_gather`) with the full semantics of its XLA twin
// `gather_dequant_xla` (hugectr_backend_tpu/tiers/hbm.py:658):
//
//     out[n, :] = f32(table[slot[n], :]) * s[n]
//
// where s[n] is the device scale of the row (`scales[slot[n]]`, the arena
// kind), a host-gathered per-key scale (`scin[n]`, the solo and one-hot
// kinds) or 1. Storage types: int8, fp8 e4m3, bf16, f32, and nibble-packed
// int4 in uint8 (even column = low nibble, sign-extended; hbm.py:683-693).
//
// What bounds it on an H100: device-memory bytes. Each output row reads one
// stored row (128 B for int8 at D = 128), a slot and a scale, and writes
// D f32 (512 B); there is no arithmetic to speak of. The TPU kernel DMAs the
// 8-row group around each slot and selects the row with a scale-weighted
// one-hot, because a TPU has no cheap per-row gather. Hopper does: here a
// few threads share one row, each moving 16 bytes with one vector load and
// writing its dequantized values with 16-byte stores, so a warp keeps
// several rows in flight. Row offsets are 64-bit (a 10M-row table times a
// wide row passes 2^31 bytes). The host checks slots before upload; a slot
// that is still out of range writes a NaN row here instead of reading out of
// bounds, and is never clamped.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

enum Kind { KIND_I8 = 0, KIND_FP8 = 1, KIND_BF16 = 2, KIND_F32 = 3, KIND_I4 = 4 };

__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ float row_scale(const float* __restrict__ dscales,
                                           const float* __restrict__ scin,
                                           int slot, int64_t r) {
  if (dscales != nullptr) return __ldg(dscales + slot);
  if (scin != nullptr) return __ldg(scin + r);
  return 1.0f;
}

__device__ __forceinline__ float nibble(unsigned v) {
  int x = static_cast<int>(v & 0xFu);
  return static_cast<float>(x >= 8 ? x - 16 : x);
}

// One thread per (row, chunk); a chunk is VEC stored elements (16 bytes when
// VEC > 1). `width` is the stored row width in elements.
template <typename T, int VEC>
__global__ void gather_dequant_kernel(const T* __restrict__ values, int64_t rows,
                                      int width, const int* __restrict__ slots,
                                      int64_t n, const float* __restrict__ dscales,
                                      const float* __restrict__ scin,
                                      float* __restrict__ out) {
  const int chunks = width / VEC;
  const int64_t total = n * chunks;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / chunks;
    const int c = static_cast<int>(i - r * chunks);
    const int slot = __ldg(slots + r);
    float* dst = out + r * width + static_cast<int64_t>(c) * VEC;
    if (slot < 0 || slot >= rows) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[j] = __int_as_float(0x7fc00000);
      continue;
    }
    const float s = row_scale(dscales, scin, slot, r);
    const T* src = values + static_cast<int64_t>(slot) * width + static_cast<int64_t>(c) * VEC;
    if constexpr (VEC == 1) {
      dst[0] = to_f32(src[0]) * s;
    } else {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
      const T* e = reinterpret_cast<const T*>(&raw);
      float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j) {
        d4[j] = make_float4(to_f32(e[4 * j]) * s, to_f32(e[4 * j + 1]) * s,
                            to_f32(e[4 * j + 2]) * s, to_f32(e[4 * j + 3]) * s);
      }
    }
  }
}

// Nibble-packed int4: `width` packed bytes per row, 2 * width outputs.
template <int VEC>
__global__ void gather_dequant_i4_kernel(const uint8_t* __restrict__ values, int64_t rows,
                                         int width, const int* __restrict__ slots,
                                         int64_t n, const float* __restrict__ dscales,
                                         const float* __restrict__ scin,
                                         float* __restrict__ out) {
  const int chunks = width / VEC;
  const int64_t total = n * chunks;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / chunks;
    const int c = static_cast<int>(i - r * chunks);
    const int slot = __ldg(slots + r);
    float* dst = out + r * 2 * width + static_cast<int64_t>(c) * 2 * VEC;
    if (slot < 0 || slot >= rows) {
#pragma unroll
      for (int j = 0; j < 2 * VEC; ++j) dst[j] = __int_as_float(0x7fc00000);
      continue;
    }
    const float s = row_scale(dscales, scin, slot, r);
    const uint8_t* src = values + static_cast<int64_t>(slot) * width + static_cast<int64_t>(c) * VEC;
    if constexpr (VEC == 1) {
      const unsigned b = src[0];
      dst[0] = nibble(b) * s;
      dst[1] = nibble(b >> 4) * s;
    } else {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
      const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
      float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // Four packed bytes -> eight values, low nibble first.
        const unsigned x = w[q];
        d4[2 * q] = make_float4(nibble(x) * s, nibble(x >> 4) * s,
                                nibble(x >> 8) * s, nibble(x >> 12) * s);
        d4[2 * q + 1] = make_float4(nibble(x >> 16) * s, nibble(x >> 20) * s,
                                    nibble(x >> 24) * s, nibble(x >> 28) * s);
      }
    }
  }
}

template <typename T, int VEC>
void launch(const void* values, int64_t rows, int width, const int* slots, int64_t n,
            const float* dscales, const float* scin, float* out, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * (width / VEC);
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  gather_dequant_kernel<T, VEC><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(values), rows, width, slots, n, dscales, scin, out);
}

template <int VEC>
void launch_i4(const void* values, int64_t rows, int width, const int* slots, int64_t n,
               const float* dscales, const float* scin, float* out, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * (width / VEC);
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  gather_dequant_i4_kernel<VEC><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const uint8_t*>(values), rows, width, slots, n, dscales, scin, out);
}

}  // namespace

extern "C" {

const char* hps_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// values [rows, width] of `kind` storage; slots [n] int32; dscales [rows] or
// null; scin [n] or null (at most one of the two); out [n, D] f32 with
// D = width (2 * width for int4). `vec`: every stored row is a whole number
// of 16-byte chunks and `values`/`out` are 16-byte aligned (the caller
// checks). Returns cudaGetLastError() after the launch.
int hps_gather_dequant(int device, void* stream, int kind, const void* values,
                       int64_t rows, int width, const int* slots, int64_t n,
                       const float* dscales, const float* scin, float* out, int vec) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0 || width == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KIND_I8:
      vec ? launch<int8_t, 16>(values, rows, width, slots, n, dscales, scin, out, s)
          : launch<int8_t, 1>(values, rows, width, slots, n, dscales, scin, out, s);
      break;
    case KIND_FP8:
      vec ? launch<__nv_fp8_e4m3, 16>(values, rows, width, slots, n, dscales, scin, out, s)
          : launch<__nv_fp8_e4m3, 1>(values, rows, width, slots, n, dscales, scin, out, s);
      break;
    case KIND_BF16:
      vec ? launch<__nv_bfloat16, 8>(values, rows, width, slots, n, dscales, scin, out, s)
          : launch<__nv_bfloat16, 1>(values, rows, width, slots, n, dscales, scin, out, s);
      break;
    case KIND_F32:
      vec ? launch<float, 4>(values, rows, width, slots, n, dscales, scin, out, s)
          : launch<float, 1>(values, rows, width, slots, n, dscales, scin, out, s);
      break;
    case KIND_I4:
      vec ? launch_i4<16>(values, rows, width, slots, n, dscales, scin, out, s)
          : launch_i4<1>(values, rows, width, slots, n, dscales, scin, out, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
