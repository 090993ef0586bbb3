// K1: embedding gather + dequantize, every group of a lookup in one launch.
//
// Replaces the Pallas kernel `_grouped_gather_kernel`
// (hugectr_backend_tpu/ops/dequant_gather.py:54, called from
// `pallas_grouped_gather`) with the full semantics of the JAX lookup
// program `gather_rows_for_groups` (hugectr_backend_tpu/cache/
// lookup_program.py:102), which jits every group of a lookup into one
// program. For each group, and each of its rows n:
//
//     out[n, :] = f32(table[slot[n], :]) * s[n]
//
// where s[n] is the device scale of the row (`scales[slot[n]]`, the arena
// kind), a host-gathered per-key scale (`scin[n]`, the solo and one-hot
// kinds) or 1. Storage types: int8, fp8 e4m3, bf16, f32, and nibble-packed
// int4 in uint8 (even column = low nibble, sign-extended; hbm.py:683-693).
// A one-hot group comes as one descriptor per member: a slot outside the
// member's rows [lo, hi) gives a zero row (0 * s), as the JAX package's
// one-hot product does (`onehot_member_rows`, lookup_program.py:37). A slot
// outside the table writes a NaN row instead of reading out of bounds (the
// host refuses such slots before upload); nothing is clamped.
//
// What bounds it on an H100: device-memory bytes. Each output row reads one
// stored row (128 B for int8 at D = 128), a slot and a scale, and writes
// D f32 (512 B); there is no arithmetic to speak of. A lookup of a Criteo
// predict is 9 groups of 4,096 to 16,384 rows: one launch per group leaves
// the card mostly idle (a 4,096-row launch took 3.6 µs against a 0.79 µs
// bound), so this kernel takes them all at once:
//
// - Work is cut into units of 4 to 32 rows of one group; the units of all
//   groups are numbered in one sequence, and a persistent grid of warps (3
//   CTAs of 8 warps per SM) walks it, each warp a unit at a time. A group's
//   units interleave with the others' across the warps, so no group trails.
// - A warp loads its unit's slots and per-key scales with one coalesced
//   load, then issues every row load of the unit (up to 16 a lane, 64
//   bytes a lane) and the device scales beside them before it uses the
//   first: two dependent rounds of memory latency per unit. A lane takes
//   pieces of 4 outputs (4 bytes of int8, 8 of bf16, ...), neighbouring
//   lanes neighbouring pieces of a row, so every load reads whole rows and
//   every store writes 512 contiguous bytes of output (16 bytes a lane).
//   Stores are plain (the output is read next by the interaction, out of
//   L2).
// - Rows whose width is not a multiple of 4 take an element path. Row
//   offsets are 64-bit (a 10M-row table times a wide row passes 2^31
//   bytes).
//
// The launch plan (grid, rows per unit, unit numbering) comes from the
// caller (ops/dequant_gather.py k1_plan); a plan the kernel does not take
// is refused.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

// One group (one member of a one-hot group) of a lookup. Mirrored by
// `_Group` in ops/dequant_gather.py.
struct HpsGroup {
  const void* values;     // [rows, width] of `kind`
  const float* dscales;   // [rows] device scales, or null
  const float* scin;      // [n] per-key scales, or null
  long long rows;         // a slot outside [0, rows) writes NaN
  long long lo, hi;       // the member's slots; outside them (inside the table): a zero row
  long long slot0;        // the group's first slot in `slots`
  long long out_off;      // the group's first output element
  int n;                  // rows to gather (>= 1)
  int kind, width;        // storage kind; stored row width in elements (int4: bytes)
  int dim;                // output row width (width, 2 * width for int4)
  int vec;                // the vector path: dim % 4 == 0, values aligned to a piece
  int rpu;                // rows per unit: a power of two <= 32
  int unit0;              // the group's first unit
};

namespace {

using Group = HpsGroup;

enum Kind { KIND_I8 = 0, KIND_FP8 = 1, KIND_BF16 = 2, KIND_F32 = 3, KIND_I4 = 4 };

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUPS = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int MAXG>
struct Params {
  const int* slots;
  float* out;
  int n_groups, units;
  Group g[MAXG];
};

__device__ __forceinline__ float nibble(unsigned v) {
  int x = static_cast<int>(v & 0xFu);
  return static_cast<float>(x >= 8 ? x - 16 : x);
}

__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// A piece: the stored bytes of 4 consecutive outputs (int8 / fp8 4 bytes,
// bf16 8, f32 16, int4 2), loaded whole; `Piece<T>::IN_FLIGHT` of them a
// lane keeps in flight (16 registers).
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
template <>
struct Piece<uint8_t> {  // nibble-packed int4
  using P = unsigned short;
  static constexpr int IN_FLIGHT = 16;
};

__device__ __forceinline__ uint32_t ldg_piece(const uint32_t* p) { return __ldg(p); }
__device__ __forceinline__ uint2 ldg_piece(const uint2* p) { return __ldg(p); }
__device__ __forceinline__ uint4 ldg_piece(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ unsigned short ldg_piece(const unsigned short* p) { return __ldg(p); }

__device__ __forceinline__ float fp8_f32(uint32_t byte) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(byte & 0xFFu);
  return static_cast<float>(v);
}

__device__ __forceinline__ float bf16_f32(uint32_t half) {
  return __uint_as_float(half << 16);
}

// A piece -> its 4 f32 values times s.
__device__ __forceinline__ float4 dequant4(int8_t, uint32_t x, float s) {
  return make_float4(static_cast<float>(static_cast<int8_t>(x)) * s,
                     static_cast<float>(static_cast<int8_t>(x >> 8)) * s,
                     static_cast<float>(static_cast<int8_t>(x >> 16)) * s,
                     static_cast<float>(static_cast<int8_t>(x >> 24)) * s);
}
__device__ __forceinline__ float4 dequant4(__nv_fp8_e4m3, uint32_t x, float s) {
  return make_float4(fp8_f32(x) * s, fp8_f32(x >> 8) * s, fp8_f32(x >> 16) * s,
                     fp8_f32(x >> 24) * s);
}
__device__ __forceinline__ float4 dequant4(__nv_bfloat16, uint2 x, float s) {
  return make_float4(bf16_f32(x.x & 0xFFFFu) * s, bf16_f32(x.x >> 16) * s,
                     bf16_f32(x.y & 0xFFFFu) * s, bf16_f32(x.y >> 16) * s);
}
__device__ __forceinline__ float4 dequant4(float, uint4 x, float s) {
  return make_float4(__uint_as_float(x.x) * s, __uint_as_float(x.y) * s,
                     __uint_as_float(x.z) * s, __uint_as_float(x.w) * s);
}
__device__ __forceinline__ float4 dequant4(uint8_t, unsigned short x, float s) {
  return make_float4(nibble(x) * s, nibble(x >> 4) * s, nibble(x >> 8) * s,
                     nibble(x >> 12) * s);
}

// The vector path of one unit: pieces over the lanes, neighbouring lanes on
// neighbouring pieces of a row, so that each load instruction reads whole
// rows and each store writes 512 contiguous bytes. Round two: every piece
// of the unit (up to IN_FLIGHT a lane) in flight before the first is used.
// `bad`: the unit's rows whose slot lies outside the table (NaN rows).
template <typename T>
__device__ __forceinline__ void unit_vec(const Group& G, int slot, float sk, unsigned bad, int nr,
                                         float* out, int lane) {
  using P = typename Piece<T>::P;
  constexpr int N = Piece<T>::IN_FLIGHT;
  const int ppr = G.dim >> 2;  // pieces per row
  const int total = nr * ppr;
  const char* base = static_cast<const char*>(G.values);
  const int64_t row_bytes = static_cast<int64_t>(ppr) * sizeof(P);
  const float q = __int_as_float(0x7fc00000);
  // Piece k = lane + 32 i is (row, column) of the unit; stepped, not divided.
  const int drow = 32 / ppr, dcol = 32 - drow * ppr;
  int row0 = lane / ppr, col0 = lane - row0 * ppr;
  for (int kb = 0; kb < total; kb += 32 * N) {
    P raw[N];
    int row = row0, col = col0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int k = kb + lane + 32 * i;
      const int s = __shfl_sync(FULL, slot, row & 31);
      // Outside the member (or the table) the piece stays zero: 0 * s.
      const bool in = k < total && s >= G.lo && s < G.hi;
      raw[i] = in ? ldg_piece(reinterpret_cast<const P*>(base + s * row_bytes) + col) : P{};
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
      const float sc = __shfl_sync(FULL, sk, row & 31);
      if (k < total)
        reinterpret_cast<float4*>(out)[k] =
            (bad >> (row & 31) & 1u) ? make_float4(q, q, q, q) : dequant4(T{}, raw[i], sc);
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

// One element (int4: one packed byte, two outputs) of the element path.
__device__ __forceinline__ void put_elem(const Group& G, int slot, int c, float s,
                                         float* dst) {
  const float q = __int_as_float(0x7fc00000);
  const int outs = G.kind == KIND_I4 ? 2 : 1;
  if (slot < 0 || slot >= G.rows) {
    for (int j = 0; j < outs; ++j) dst[j] = q;
    return;
  }
  if (slot < G.lo || slot >= G.hi) {  // outside the member: 0 * s
    for (int j = 0; j < outs; ++j) dst[j] = 0.0f * s;
    return;
  }
  const int64_t at = static_cast<int64_t>(slot) * G.width + c;
  switch (G.kind) {
    case KIND_I8:
      dst[0] = to_f32(__ldg(static_cast<const int8_t*>(G.values) + at)) * s;
      break;
    case KIND_FP8: {
      const unsigned char b = __ldg(static_cast<const unsigned char*>(G.values) + at);
      dst[0] = to_f32(*reinterpret_cast<const __nv_fp8_e4m3*>(&b)) * s;
      break;
    }
    case KIND_BF16:
      dst[0] = to_f32(static_cast<const __nv_bfloat16*>(G.values)[at]) * s;
      break;
    case KIND_F32:
      dst[0] = __ldg(static_cast<const float*>(G.values) + at) * s;
      break;
    default: {  // KIND_I4
      const unsigned b = __ldg(static_cast<const unsigned char*>(G.values) + at);
      dst[0] = nibble(b) * s;
      dst[1] = nibble(b >> 4) * s;
    }
  }
}

template <int MAXG>
__global__ void __launch_bounds__(THREADS, 3)
    grouped_gather_kernel(const __grid_constant__ Params<MAXG> p) {
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * WARPS;
  for (int u = blockIdx.x * WARPS + (threadIdx.x >> 5); u < p.units; u += nw) {
    // The unit's group: the last one that starts at or before it (a launch
    // of one group reads its descriptor at fixed offsets).
    int lo = 0, hi = MAXG == 1 ? 0 : p.n_groups - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (p.g[mid].unit0 <= u) lo = mid; else hi = mid - 1;
    }
    const Group& G = p.g[lo];
    const int r0 = (u - G.unit0) * G.rpu;
    const int nr = min(G.rpu, G.n - r0);
    // Round one: the unit's slots and per-key scales, a lane per row.
    int slot = 0;
    float sk = 1.0f;
    if (lane < nr) {
      slot = __ldg(p.slots + G.slot0 + r0 + lane);
      if (G.scin != nullptr) sk = __ldg(G.scin + r0 + lane);
    }
    const bool in_table = slot >= 0 && slot < G.rows;
    if (G.dscales != nullptr && lane < nr && in_table) sk = __ldg(G.dscales + slot);
    float* out = p.out + G.out_off + static_cast<int64_t>(r0) * G.dim;
    if (G.vec) {
      const unsigned bad = __ballot_sync(FULL, lane < nr && !in_table);
      switch (G.kind) {
        case KIND_I8: unit_vec<int8_t>(G, slot, sk, bad, nr, out, lane); break;
        case KIND_FP8: unit_vec<__nv_fp8_e4m3>(G, slot, sk, bad, nr, out, lane); break;
        case KIND_BF16: unit_vec<__nv_bfloat16>(G, slot, sk, bad, nr, out, lane); break;
        case KIND_F32: unit_vec<float>(G, slot, sk, bad, nr, out, lane); break;
        default: unit_vec<uint8_t>(G, slot, sk, bad, nr, out, lane);
      }
      continue;
    }
    // Element path: a row's elements over the lanes, 32 at a time.
    const int total = nr * G.width;
    const int per = G.kind == KIND_I4 ? 2 : 1;
    for (int base = 0; base < total; base += 32) {
      const int k = base + lane;
      const int row = k / G.width;
      const int c = k - row * G.width;
      const int s_row = __shfl_sync(FULL, slot, row & 31);
      const float sc = __shfl_sync(FULL, sk, row & 31);
      if (k < total) put_elem(G, s_row, c, sc, out + static_cast<int64_t>(row) * G.dim + c * per);
    }
  }
}

bool group_ok(const Group& g, int unit0) {
  if (g.n < 1 || g.kind < KIND_I8 || g.kind > KIND_I4 || g.width < 1 || g.rows < 0 ||
      g.lo < 0 || g.lo > g.hi || g.hi > g.rows || g.slot0 < 0 || g.out_off < 0 ||
      g.values == nullptr || (g.dscales != nullptr && g.scin != nullptr) ||
      g.unit0 != unit0 || g.rpu < 1 || g.rpu > 32 || (g.rpu & (g.rpu - 1)) != 0)
    return false;
  if (g.dim != (g.kind == KIND_I4 ? 2 * g.width : g.width)) return false;
  // The vector path: pieces of 4 outputs (4, 4, 8, 16, 2 bytes), aligned.
  const int pb = g.kind == KIND_BF16 ? 8 : g.kind == KIND_F32 ? 16 : g.kind == KIND_I4 ? 2 : 4;
  if (g.vec && (g.dim % 4 != 0 || g.out_off % 4 != 0 ||
                reinterpret_cast<uintptr_t>(g.values) % pb != 0))
    return false;
  return true;
}

template <int MAXG>
int launch(const int* slots, float* out, const Group* groups, int n_groups, int units, int grid,
           cudaStream_t stream) {
  Params<MAXG> p;
  p.slots = slots;
  p.out = out;
  p.n_groups = n_groups;
  p.units = units;
  for (int i = 0; i < n_groups; ++i) p.g[i] = groups[i];
  grouped_gather_kernel<MAXG><<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hps_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Gather and dequantize `n_groups` groups in one launch. slots: every
// group's int32 slots, group g's at slots[groups[g].slot0 ...]; out: the f32
// output, group g's [n, dim] rows at out[groups[g].out_off ...] (16-byte
// aligned). The plan (ops/dequant_gather.py k1_plan): each group's rows per
// unit and first unit (units numbered group after group, ceil(n / rpu)
// each), `units` in all, `grid` CTAs of 256 threads. A plan or a group the
// kernel does not take returns cudaErrorInvalidValue. Returns
// cudaGetLastError() after the launch.
int hps_gather_dequant_groups(int device, void* stream, const int* slots, float* out,
                              const HpsGroup* groups, int n_groups, int units, int grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_groups < 0 || n_groups > MAX_GROUPS || units < 0 || grid < 0 ||
      (units > 0 && grid < 1) || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int unit0 = 0;
  for (int i = 0; i < n_groups; ++i) {
    if (!group_ok(groups[i], unit0)) return static_cast<int>(cudaErrorInvalidValue);
    unit0 += (groups[i].n + groups[i].rpu - 1) / groups[i].rpu;
  }
  if (unit0 != units) return static_cast<int>(cudaErrorInvalidValue);
  if (units == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_groups <= 1) return launch<1>(slots, out, groups, n_groups, units, grid, s);
  if (n_groups <= 32) return launch<32>(slots, out, groups, n_groups, units, grid, s);
  return launch<MAX_GROUPS>(slots, out, groups, n_groups, units, grid, s);
}

}  // extern "C"
