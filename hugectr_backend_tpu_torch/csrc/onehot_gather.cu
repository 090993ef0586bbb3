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
// Every step adds the same row or +0, so a key's result depends only on
// its row v, the number h of steps that hit and whether some step missed:
// h == 0 gives +0 (the row is never read), else v added to itself h - 1
// times in order, then + 0.0 once if a step missed. Adding +0 changes
// nothing but the sign of a zero sum, and it does so wherever in the run it
// comes, so this is the walk bit for bit: a -0.0 value stays -0.0 only when
// every step of the run hits; a row tile visited twice gives v + v; a
// non-finite row reaches only the keys that hit it.
//
// What bounds it on an H100: device-memory bytes, almost all of them the
// f32 output (512 bytes a key at D = 128 against 128 of int8 row). The TPU
// kernel multiplies a 0/1 mask by every row tile of the key's member on the
// MXU; on Hopper that product would cost 2 * m_tile * r_tile * D operations
// per step, far above the gather's bytes, so this is a masked gather laid
// out as K1 (csrc/gather_dequant.cu) is:
//
// - Keys are cut into units of 4 to 32 (the caller's plan,
//   ops/dequant_gather.py k1_plan), walked by a persistent grid of warps (3
//   CTAs of 8 warps per SM).
// - A key's run is resolved once per key: a lane per key loads the slot
//   and the run's bounds together,
//   then counts the run's row tiles that hold the slot (the same `rt` words
//   for every key of a key tile: broadcasts from L1), and v1 loads the
//   slot's scale beside them. Three rounds of memory latency per unit, then
//   the stores.
// - A lane takes pieces of 4 outputs (4 bytes of int8 or fp8, 8 of bf16,
//   16 of f32), neighbouring lanes neighbouring pieces of a row, so every
//   store writes 512 contiguous bytes; up to 16 pieces a lane are in flight
//   before the first is used (12 for v1 of int8 and fp8, whose per-key
//   scales take registers too; half as many where a key hits twice). A
//   unit where no key hits twice (every unit of a plan that visits each row
//   tile once) needs one select per value. Rows whose width is not a
//   multiple of 4 (or an arena not aligned to a piece) take an element
//   path.
//
// Storage types: int8, fp8 e4m3 (exact in f32, as the TPU's cast through
// bf16), bf16, f32. The wrapper refuses nibble-packed int4.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

enum Kind { KIND_I8 = 0, KIND_FP8 = 1, KIND_BF16 = 2, KIND_F32 = 3 };

constexpr int THREADS = 256;  // THREADS and the 3 CTAs per SM of k1_plan
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* values;     // [rows, dim] of the storage type
  const float* scales;    // [rows] (v1), or null: 1 per hit
  const int* slots;       // [n]
  const int* offsets;     // [n / m_tile + 1]: key tile k's steps are offsets[k] .. offsets[k + 1]
  const int* rt;          // [steps] row tile of each step, in run order
  float* out;             // [n, dim]
  long long n, rows;
  int dim, m_tile, r_tile;
  int rpu, units;         // keys per unit (a power of two <= 32), units in all
};

// A piece: the stored bytes of 4 consecutive outputs, loaded whole;
// `Piece<T>::IN_FLIGHT` of them a lane keeps in flight (16 registers).
template <typename T>
struct Piece;
template <>
struct Piece<int8_t> {
  using P = uint32_t;
  static constexpr int IN_FLIGHT = 16;
};
template <>
struct Piece<__nv_fp8_e4m3> {
  using P = uint32_t;
  static constexpr int IN_FLIGHT = 16;
};
template <>
struct Piece<__nv_bfloat16> {
  using P = uint2;
  static constexpr int IN_FLIGHT = 8;
};
template <>
struct Piece<float> {
  using P = uint4;
  static constexpr int IN_FLIGHT = 4;
};

__device__ __forceinline__ uint32_t ldg_piece(const uint32_t* p) { return __ldg(p); }
__device__ __forceinline__ uint2 ldg_piece(const uint2* p) { return __ldg(p); }
__device__ __forceinline__ uint4 ldg_piece(const uint4* p) { return __ldg(p); }

__device__ __forceinline__ float fp8_f32(uint32_t byte) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(byte & 0xFFu);
  return static_cast<float>(v);
}

__device__ __forceinline__ float bf16_f32(uint32_t half) { return __uint_as_float(half << 16); }

// A piece -> its 4 values in f32 (exact for every storage type).
__device__ __forceinline__ float4 widen4(int8_t, uint32_t x) {
  return make_float4(static_cast<float>(static_cast<int8_t>(x)),
                     static_cast<float>(static_cast<int8_t>(x >> 8)),
                     static_cast<float>(static_cast<int8_t>(x >> 16)),
                     static_cast<float>(static_cast<int8_t>(x >> 24)));
}
__device__ __forceinline__ float4 widen4(__nv_fp8_e4m3, uint32_t x) {
  return make_float4(fp8_f32(x), fp8_f32(x >> 8), fp8_f32(x >> 16), fp8_f32(x >> 24));
}
__device__ __forceinline__ float4 widen4(__nv_bfloat16, uint2 x) {
  return make_float4(bf16_f32(x.x & 0xFFFFu), bf16_f32(x.x >> 16), bf16_f32(x.y & 0xFFFFu),
                     bf16_f32(x.y >> 16));
}
__device__ __forceinline__ float4 widen4(float, uint4 x) {
  return make_float4(__uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
                     __uint_as_float(x.w));
}

// One stored element -> f32 (the element path).
__device__ __forceinline__ float widen1(int8_t, const void* v, int64_t at) {
  return static_cast<float>(__ldg(static_cast<const signed char*>(v) + at));
}
__device__ __forceinline__ float widen1(__nv_fp8_e4m3, const void* v, int64_t at) {
  return fp8_f32(__ldg(static_cast<const unsigned char*>(v) + at));
}
__device__ __forceinline__ float widen1(__nv_bfloat16, const void* v, int64_t at) {
  return bf16_f32(__ldg(static_cast<const unsigned short*>(v) + at));
}
__device__ __forceinline__ float widen1(float, const void* v, int64_t at) {
  return __ldg(static_cast<const float*>(v) + at);
}

// The walk of one key's run, given its part v: `code` = 2 h + (a step
// missed); see the head of the file.
__device__ __forceinline__ float walk(float v, int code) {
  const int h = code >> 1;
  if (h == 0) return 0.0f;
  float acc = v;
  for (int k = 1; k < h; ++k) acc = __fadd_rn(acc, v);
  return (code & 1) ? __fadd_rn(acc, 0.0f) : acc;
}

// walk() of 4 values. DUP: some key of the unit hits more than once (a row
// tile visited twice), else every key hits at most once and its piece is
// already zero where it hits nothing (the row was not read): then the walk
// is a select, with no loop and no branch in the unrolled store loop.
template <bool DUP>
__device__ __forceinline__ float4 walk4(float4 v, int code) {
  if constexpr (DUP) {
    return make_float4(walk(v.x, code), walk(v.y, code), walk(v.z, code), walk(v.w, code));
  } else {
    const bool miss = code & 1;
    return make_float4(miss ? __fadd_rn(v.x, 0.0f) : v.x, miss ? __fadd_rn(v.y, 0.0f) : v.y,
                       miss ? __fadd_rn(v.z, 0.0f) : v.z, miss ? __fadd_rn(v.w, 0.0f) : v.w);
  }
}

// The vector path of one unit: pieces over the lanes, neighbouring lanes on
// neighbouring pieces of a row. `ls`: the lane's key's slot, -1 where no
// step hits (the row is not read); `code` and `sv` (v1: the walked scale)
// per key.
template <typename T, bool V1, bool DUP>
__device__ __forceinline__ void unit_vec(const Params& p, int ls, int code, float sv, int nr,
                                         float* out, int lane) {
  using P = typename Piece<T>::P;
  // Fewer pieces in flight where more registers hold per-key values: the
  // rare DUP path's walk loop, and v1's scale for 4-byte pieces (int8,
  // fp8), which spilled at 16 (80 registers a thread keep 3 CTAs on an SM).
  constexpr int N = DUP ? Piece<T>::IN_FLIGHT / 2
                  : V1 && sizeof(P) == 4 ? 12 : Piece<T>::IN_FLIGHT;
  const int ppr = p.dim >> 2;  // pieces per row
  const int total = nr * ppr;
  const char* base = static_cast<const char*>(p.values);
  const int64_t row_bytes = static_cast<int64_t>(ppr) * sizeof(P);
  // Piece k = lane + 32 i is (row, column) of the unit; stepped, not divided.
  const int drow = 32 / ppr, dcol = 32 - drow * ppr;
  int row0 = lane / ppr, col0 = lane - row0 * ppr;
  for (int kb = 0; kb < total; kb += 32 * N) {
    P raw[N];
    int row = row0, col = col0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int k = kb + lane + 32 * i;
      const int s = __shfl_sync(FULL, ls, row & 31);
      raw[i] = k < total && s >= 0
                   ? ldg_piece(reinterpret_cast<const P*>(base + s * row_bytes) + col)
                   : P{};
      row += drow;
      col += dcol;
      if (col >= ppr) {
        col -= ppr;
        ++row;
      }
    }
    const int next_row = row, next_col = col;  // where the next batch starts
    row = row0;
    col = col0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int k = kb + lane + 32 * i;
      const int c = __shfl_sync(FULL, code, row & 31);
      float4 v = walk4<DUP>(widen4(T{}, raw[i]), c);
      if constexpr (V1) {
        const float s = __shfl_sync(FULL, sv, row & 31);
        v = make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s),
                        __fmul_rn(v.w, s));
      }
      if (k < total) reinterpret_cast<float4*>(out)[k] = v;
      row += drow;
      col += dcol;
      if (col >= ppr) {
        col -= ppr;
        ++row;
      }
    }
    row0 = next_row;
    col0 = next_col;
  }
}

template <typename T, bool V1, bool VEC>
__global__ void __launch_bounds__(THREADS, 3) onehot_gather_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * WARPS;
  for (int u = blockIdx.x * WARPS + (threadIdx.x >> 5); u < p.units; u += nw) {
    const long long k0 = static_cast<long long>(u) * p.rpu;
    const int nr = static_cast<int>(min(static_cast<long long>(p.rpu), p.n - k0));
    // Round one: a lane per key, its slot and its key tile's run.
    int slot = -1, s0 = 0, s1 = 0;
    if (lane < nr) {
      const long long key = k0 + lane;
      const long long kt = key / p.m_tile;
      slot = __ldg(p.slots + key);
      s0 = __ldg(p.offsets + kt);
      s1 = __ldg(p.offsets + kt + 1);
    }
    // Round two: the steps whose row tile holds the slot (none for a slot
    // outside the arena: every row tile lies inside it), and v1's scale.
    const bool in_arena = slot >= 0 && slot < p.rows;
    const int tile = in_arena ? slot / p.r_tile : -1;
    float sk = 1.0f;
    if (V1 && p.scales != nullptr && in_arena) sk = __ldg(p.scales + slot);
    int h = 0;
#pragma unroll 4
    for (int s = s0; s < s1; ++s) h += __ldg(p.rt + s) == tile;
    const int code = 2 * h + (h < s1 - s0);
    const int ls = h > 0 ? slot : -1;
    const float sv = V1 ? walk(sk, code) : 1.0f;
    float* out = p.out + k0 * p.dim;
    if constexpr (VEC) {
      if (__any_sync(FULL, h > 1)) unit_vec<T, V1, true>(p, ls, code, sv, nr, out, lane);
      else unit_vec<T, V1, false>(p, ls, code, sv, nr, out, lane);
    } else {
      // Element path: a row's elements over the lanes, 32 at a time.
      const int total = nr * p.dim;
      for (int base = 0; base < total; base += 32) {
        const int k = base + lane;
        const int row = k / p.dim;
        const int c = k - row * p.dim;
        const int s = __shfl_sync(FULL, ls, row & 31);
        const int cd = __shfl_sync(FULL, code, row & 31);
        const float scl = __shfl_sync(FULL, sv, row & 31);
        if (k >= total) continue;
        const float v = s >= 0 ? widen1(T{}, p.values, static_cast<int64_t>(s) * p.dim + c) : 0.0f;
        const float w = walk(v, cd);
        out[k] = V1 ? __fmul_rn(w, scl) : w;
      }
    }
  }
}

template <typename T>
int launch(bool v1, bool vec, const Params& p, int grid, cudaStream_t s) {
  if (v1) {
    if (vec) onehot_gather_kernel<T, true, true><<<grid, THREADS, 0, s>>>(p);
    else onehot_gather_kernel<T, true, false><<<grid, THREADS, 0, s>>>(p);
  } else {
    if (vec) onehot_gather_kernel<T, false, true><<<grid, THREADS, 0, s>>>(p);
    else onehot_gather_kernel<T, false, false><<<grid, THREADS, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hps_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// values [rows, width] of `kind` storage; slots [n] int32 with n a multiple
// of m_tile; offsets [n / m_tile + 1] and rt [S] int32 (validated on the
// host: every run non-empty, every row tile inside the arena); v1: scale and
// multiply (scales [rows] f32, or null for ones), else rows only; out
// [n, width] f32, 16-byte aligned. `vec`: width % 4 == 0 and `values`
// aligned to a piece of 4 elements (the caller checks). The plan (k1_plan
// of ops/dequant_gather.py for one group of n rows): `rpu` keys per unit, a
// power of two up to 32, ceil(n / rpu) = `units`, `grid` CTAs of 256
// threads; a plan the kernel does not take returns cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launch.
int hps_onehot_gather(int device, void* stream, int kind, const void* values, long long rows,
                      int width, const int* slots, long long n, const int* offsets,
                      const int* rt, int m_tile, int r_tile, int v1, const float* scales,
                      float* out, int vec, int rpu, int units, int grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0 || width == 0) return 0;
  if (n < 0 || width < 0 || rows < 0 || m_tile < 1 || r_tile < 1 || rpu < 1 || rpu > 32 ||
      (rpu & (rpu - 1)) != 0 || units != (n + rpu - 1) / rpu || grid < 1 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || (vec && width % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{values, v1 ? scales : nullptr, slots, offsets, rt, out, n, rows, width,
                 m_tile, r_tile, rpu, units};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scaled = v1 != 0, vv = vec != 0;
  switch (kind) {
    case KIND_I8: return launch<int8_t>(scaled, vv, p, grid, s);
    case KIND_FP8: return launch<__nv_fp8_e4m3>(scaled, vv, p, grid, s);
    case KIND_BF16: return launch<__nv_bfloat16>(scaled, vv, p, grid, s);
    case KIND_F32: return launch<float>(scaled, vv, p, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
