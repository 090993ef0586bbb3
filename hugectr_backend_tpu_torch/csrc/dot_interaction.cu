// K2, K3 and K4's forward: the fused DLRM dot interaction.
//
// Replaces the Pallas kernels `_kernel_parts` and `_kernel_parts_fm` (K2,
// hugectr_backend_tpu/ops/fused_interaction.py:298 and :322),
// `_kernel_oh_parts` (K3, the same file, :620) and `_kernel` (K4, :65). Per
// sample b:
//
//     z    = [bottom[b]; oh rows; fed feature rows]   F x D, rounded to bf16
//     out  = [bottom[b] | triu(z z^T, 1)]              D + F(F-1)/2 values
//
// The pairs come in the order of np.triu_indices(F, 1). For K3 the first
// n_oh rows after the bottom are built here from a small quantized arena, as
// the Pallas body does (:626-638): z_j = bf16(f32(arena[slot]) * scale) for
// a slot inside its member's rows [off, off + size), a zero row (0 * scale)
// for a slot outside them, as the body's one-hot mask gives, and a NaN row
// for a slot outside the arena. For K2 and K4 n_oh is 0. A bf16 x bf16
// product is exact in f32, so the result differs from the TPU's only in the
// order of the f32 sums.
//
// The bottom, the fed features and the output share one type, f32 or bf16
// (the JAX DLRM's compute_dtype; the Pallas bodies write `bottom.dtype`).
// The pair sums are f32 either way and round once to bf16 at the store on
// the bf16 route; a bf16 row is already a z row, so its copy into z is
// exact. A bf16 output row is D + P values of 2 bytes, so its start is
// 2-byte aligned only: that route stores element by element.
//
// What bounds it on an H100: device-memory bytes. At the Criteo shape
// (B = 4096, F = 27, D = 128) K3 reads 28.3 MB of f32 rows and the one-hot
// rows, slots and scales, and writes 7.8 MB, against 0.37 GFLOP of pair
// products, which the bf16 tensor cores finish in well under a microsecond
// (on the bf16 route the fed rows are half the bytes, the output 3.9 MB).
// So the kernel is a latency problem: a sample's rows must all be in flight
// at once, and enough samples with them.
//
// - A warp owns one sample at a time; CTAs of up to 8 warps, as many per SM
//   as shared memory and 128 registers a thread allow (2 at the Criteo
//   shape: 16 warps an SM), on a persistent grid that fits the card at
//   once: warp w takes samples w, w + warps, ...
// - A sample is loaded in two dependent rounds: its fed rows (16-byte
//   loads, up to 14 a lane) with the slots and scales of its one-hot rows,
//   then the one-hot rows themselves (16-byte loads, 4 chunks a lane). Wider
//   samples take further rounds. Keeping the next sample's rows in flight
//   under this one's product (in registers, or staged in shared memory with
//   cp.async) measured slower at the Criteo shape: it costs registers or
//   shared memory, so fewer warps are resident (PERF.md).
// - The rows are rounded to bf16 into a per-warp z tile in shared memory
//   (rows padded to 16, a 16-byte skew per row for conflict-free fragment
//   loads), and the upper triangle of z z^T runs as mma.sync m16n8k16 tiles
//   with f32 accumulation, one 16-row block of z at a time, 4 column tiles
//   at once on the block's A fragments (4 independent accumulations).
// - A row block's pairs are one contiguous run of the output row (the pairs
//   are row-major), so each block is staged in shared memory (the first
//   with the f32 bottom copy in front) at the alignment it has in device
//   memory, and written with 16-byte stores. The pair triangle is thus
//   tiled in row blocks: the only limit on F is the z tile and one block's
//   stage in shared memory (688 features at D = 128). Past it, or past
//   MAX_DESC descriptors, the plan takes the wide route at the end of this
//   file, which keeps z in device memory.
//
// Fed features arrive as descriptors (base pointer, batch stride), so
// general and part-major feature maps, strided views of a stacked [B, T, D]
// tensor, and parts with phantom tail rows all take the same code; rows that
// no feature names are never read. The launch plan (warps per CTA, grid,
// shared memory) comes from the caller (ops/fused_interaction.py k3_plan);
// a plan the kernel does not take is refused.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Kind { KIND_I8 = 0, KIND_FP8 = 1, KIND_BF16 = 2, KIND_F32 = 3 };

constexpr int MAX_WARPS = 8;    // warps per CTA
constexpr int MIN_CTAS = 2;     // of 256 threads per SM: at most 128 registers a thread
constexpr int NF = 14;          // fed 16-byte loads per lane per round (no spills at 128 registers)
constexpr int NO = 4;           // one-hot 16-byte loads per lane per round
constexpr int NG = 4;           // column tiles of the product sharing A fragments
constexpr int MAX_DESC = 1024;  // fed features and one-hot members a launch takes
constexpr int SMALL_DESC = 64;  // ... in the small parameter block
constexpr int MAX_SMEM = 232448;

struct Feat {
  const void* ptr;   // f32 or bf16, the launch's IO type
  long long stride;  // elements between consecutive samples
};

struct Member {
  int off, size;  // the member's arena rows [off, off + size)
};

template <int MAXD>
struct Params {
  int B, D, F, n_oh, n_fed;     // F = n_fed + n_oh; fed row 0 is the bottom
  int D_pad, F_pad, ld, P;      // tile geometry (bf16 elements), pair count
  int stage_len, warp_bytes;    // one warp's stage (floats); z tile + stage (bytes)
  int oh_vec, oh_cpr;           // one-hot rows of whole 16-byte chunks; chunks per row
  long long out_ld;             // D + P
  void* out;                    // f32 or bf16, the launch's IO type
  const void* arena;
  long long arena_rows;
  const int* slots;
  long long slots_ld;
  const float* scales;          // null -> 1
  long long scales_ld;
  Feat fed[MAXD + 1];           // fed row i of sample b: fed[i].ptr + b * fed[i].stride
  Member members[MAXD];
};

__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// One element of the IO type (f32 or bf16) read through the read-only cache,
// as f32, and one written from f32 with the streaming (evict-first) hint
// (bf16: rounded to nearest even): the wide route's accesses.
__device__ __forceinline__ float ld_io(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_io(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void st_io_cs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void st_io_cs(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A lane's walk over a grid of `cols` columns in steps of 32 elements, as
// (row, column), without a divide per step.
struct Walk {
  int row, col, drow, dcol, cols;
  __device__ __forceinline__ void start(int k, int cols_) {
    cols = cols_;
    row = k / cols;
    col = k - row * cols;
    drow = 32 / cols;
    dcol = 32 - drow * cols;
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

// Index of pair (r, r + 1) in the row-major upper triangle of F features.
__device__ __forceinline__ int pair_start(int r, int F) { return r * (2 * F - r - 1) / 2; }

// A fed element a lane loads: 4 values (16 bytes of f32, 8 of bf16), or a
// single value (rows off the vector path); NF of them a round.
template <bool VEC4, typename IO>
using FedT = typename std::conditional<
    VEC4, typename std::conditional<std::is_same<IO, float>::value, float4, uint2>::type,
    typename std::conditional<std::is_same<IO, float>::value, float, unsigned short>::type>::type;

template <bool VEC4, typename IO, int MAXD>
__device__ __forceinline__ void load_fed(const Params<MAXD>& p, int b, Walk w,
                                         FedT<VEC4, IO> (&fr)[NF]) {
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    if (w.row < p.n_fed) {
      const FedT<false, IO>* src =
          static_cast<const FedT<false, IO>*>(p.fed[w.row].ptr) + b * p.fed[w.row].stride;
      if constexpr (VEC4) {
        fr[i] = __ldg(reinterpret_cast<const FedT<true, IO>*>(src) + w.col);
      } else {
        fr[i] = __ldg(src + w.col);
      }
    }
    w.next();
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Round the loaded fed elements to bf16 into z (a bf16 row goes as it is);
// the bottom (fed row 0) also goes to the stage in f32, at `shift`.
template <bool VEC4, typename IO, int MAXD>
__device__ __forceinline__ void store_fed(const Params<MAXD>& p, Walk w,
                                          const FedT<VEC4, IO> (&fr)[NF],
                                          __nv_bfloat16* z, float* stage, int shift) {
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    if (w.row < p.n_fed) {
      const int zr = w.row == 0 ? 0 : p.n_oh + w.row;
      if constexpr (VEC4) {
        float4 v;
        if constexpr (std::is_same<IO, float>::value) {
          v = fr[i];
          *reinterpret_cast<uint2*>(z + zr * p.ld + 4 * w.col) =
              make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
        } else {
          *reinterpret_cast<uint2*>(z + zr * p.ld + 4 * w.col) = fr[i];
          v = make_float4(bf16_lo(fr[i].x), bf16_hi(fr[i].x), bf16_lo(fr[i].y), bf16_hi(fr[i].y));
        }
        if (w.row == 0) {
          float* s = stage + shift + 4 * w.col;
          s[0] = v.x;
          s[1] = v.y;
          s[2] = v.z;
          s[3] = v.w;
        }
      } else {
        float v;
        if constexpr (std::is_same<IO, float>::value) {
          v = fr[i];
          z[zr * p.ld + w.col] = __float2bfloat16_rn(v);
        } else {
          v = bf16_lo(fr[i]);
          z[zr * p.ld + w.col] = __ushort_as_bfloat16(fr[i]);
        }
        if (w.row == 0) stage[shift + w.col] = v;
      }
    }
    w.next();
  }
}

// The first round of one-hot chunks: each chunk's slot and scale.
template <int MAXD>
__device__ __forceinline__ void load_oh_keys(const Params<MAXD>& p, int b, Walk w,
                                             int (&sl)[NO], float (&sc)[NO]) {
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    sl[j] = 0;
    sc[j] = 1.0f;
    if (w.row < p.n_oh) {
      sl[j] = __ldg(p.slots + w.row * p.slots_ld + b);
      if (p.scales != nullptr) sc[j] = __ldg(p.scales + w.row * p.scales_ld + b);
    }
    w.next();
  }
}

// The chunks' arena rows: zeros outside the member (and outside the arena).
template <int MAXD>
__device__ __forceinline__ void load_oh_rows(const Params<MAXD>& p, Walk w, const int (&sl)[NO],
                                             uint4 (&raw)[NO]) {
  const char* arena = static_cast<const char*>(p.arena);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    raw[j] = make_uint4(0u, 0u, 0u, 0u);
    if (w.row < p.n_oh) {
      const Member m = p.members[w.row];
      const int s = sl[j];
      if (s >= m.off && s < m.off + m.size && s >= 0 && s < p.arena_rows)
        raw[j] = __ldg(reinterpret_cast<const uint4*>(
                           arena + static_cast<int64_t>(s) * p.oh_cpr * 16) + w.col);
    }
    w.next();
  }
}

// z_j = bf16(f32(arena[slot]) * scale) into z row 1 + j; a zero chunk gives
// 0 * scale, a slot outside the arena NaN.
template <typename AT, int MAXD>
__device__ __forceinline__ void store_oh(const Params<MAXD>& p, Walk w, const int (&sl)[NO],
                                         const float (&sc)[NO], const uint4 (&raw)[NO],
                                         __nv_bfloat16* z) {
  constexpr int V = 16 / sizeof(AT);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (w.row < p.n_oh) {
      const bool nan = sl[j] < 0 || sl[j] >= p.arena_rows;
      const AT* e = reinterpret_cast<const AT*>(&raw[j]);
      uint32_t out[V / 2];
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        const float lo = nan ? __int_as_float(0x7fc00000) : to_f32(e[2 * k]) * sc[j];
        const float hi = nan ? __int_as_float(0x7fc00000) : to_f32(e[2 * k + 1]) * sc[j];
        out[k] = pack_bf16(lo, hi);
      }
      __nv_bfloat16* dst = z + (1 + w.row) * p.ld + V * w.col;
      if constexpr (V == 16) {
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(out[0], out[1], out[2], out[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(out[4], out[5], out[6], out[7]);
      } else if constexpr (V == 8) {
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(out[0], out[1], out[2], out[3]);
      } else {
        reinterpret_cast<uint2*>(dst)[0] = make_uint2(out[0], out[1]);
      }
    }
    w.next();
  }
}

// The one-hot rows one element a lane at a time: rows that are not whole
// 16-byte chunks, or an arena that is not 16-byte aligned.
template <typename AT, int MAXD>
__device__ __forceinline__ void oh_elements(const Params<MAXD>& p, int b, int lane,
                                            __nv_bfloat16* z) {
  const AT* arena = static_cast<const AT*>(p.arena);
  const int total = p.n_oh * p.D;
  for (int k = lane; k < total; k += 32) {
    const int j = k / p.D;
    const int c = k - j * p.D;
    const int s = __ldg(p.slots + j * p.slots_ld + b);
    const float sc = p.scales != nullptr ? __ldg(p.scales + j * p.scales_ld + b) : 1.0f;
    const Member m = p.members[j];
    float v;
    if (s < 0 || s >= p.arena_rows) v = __int_as_float(0x7fc00000);
    else if (s < m.off || s >= m.off + m.size) v = 0.0f * sc;
    else v = to_f32(arena[static_cast<int64_t>(s) * p.D + c]) * sc;
    z[(1 + j) * p.ld + c] = __float2bfloat16_rn(v);
  }
}

template <typename AT, bool VEC4, int MAXD, typename IO>
__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_CTAS)
    dot_interaction_kernel(const __grid_constant__ Params<MAXD> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned char* mine = smem + static_cast<size_t>(warp) * p.warp_bytes;
  __nv_bfloat16* z = reinterpret_cast<__nv_bfloat16*>(mine);
  float* stage = reinterpret_cast<float*>(mine + static_cast<size_t>(p.F_pad) * p.ld * 2);

  // Padding rows (>= F) and columns (>= D) stay zero for every sample.
  for (int i = lane; i < p.F_pad * p.ld / 8; i += 32)
    reinterpret_cast<uint4*>(z)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();

  const int fcols = VEC4 ? p.D >> 2 : p.D;  // fed loads per row
  Walk fw0, ow0;
  fw0.start(lane, fcols);
  ow0.start(lane, p.oh_vec ? p.oh_cpr : 1);
  const int fed_rounds = (p.n_fed * fcols + 32 * NF - 1) / (32 * NF);
  const int oh_rounds = p.oh_vec ? (p.n_oh * p.oh_cpr + 32 * NO - 1) / (32 * NO) : 0;
  const int step = gridDim.x * nwarps;
  const int F = p.F;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int b = blockIdx.x * nwarps + warp; b < p.B; b += step) {
    const long long row0 = static_cast<long long>(b) * p.out_ld;
    const int shift0 = static_cast<int>(row0 & 3);
    // Round one: the one-hot slots and scales with the fed rows (14 16-byte
    // loads a lane a round; one round at the Criteo shape's 13 fed rows).
    int sl[NO];
    float sc[NO];
    if (oh_rounds > 0) load_oh_keys(p, b, ow0, sl, sc);
    Walk fw = fw0;
    for (int r = 0; r < fed_rounds; ++r) {
      FedT<VEC4, IO> fr[NF];
      load_fed<VEC4, IO>(p, b, fw, fr);
      store_fed<VEC4, IO>(p, fw, fr, z, stage, shift0);
      for (int i = 0; i < NF; ++i) fw.next();
    }
    // Round two: the one-hot rows.
    if (oh_rounds > 0) {
      Walk ow = ow0;
      for (int r = 0; r < oh_rounds; ++r) {
        if (r > 0) load_oh_keys(p, b, ow, sl, sc);
        uint4 raw[NO];
        load_oh_rows(p, ow, sl, raw);
        store_oh<AT>(p, ow, sl, sc, raw, z);
        for (int j = 0; j < NO; ++j) ow.next();
      }
    } else if (p.n_oh > 0) {
      oh_elements<AT>(p, b, lane, z);
    }
    __syncwarp();

    // The upper triangle of z z^T, one block of 16 rows at a time; in a
    // block, NG column tiles at once share the A fragments.
    const int nt_end = (F + 7) >> 3;
    for (int mt = 0; mt == 0 || mt * 16 < F - 1; ++mt) {
      const int r0 = mt * 16;
      const int r1 = min(r0 + 16, F - 1);
      const int plo = pair_start(r0, F);
      const int phi = pair_start(r1, F);
      const long long gs = row0 + (mt == 0 ? 0 : p.D + plo);
      const int len = (mt == 0 ? p.D : 0) + phi - plo;
      const int shift = static_cast<int>(gs & 3);
      const int base = shift + (mt == 0 ? p.D : 0) - plo;  // stage index of pair q: base + q
      const __nv_bfloat16* a_lo = z + (r0 + g) * p.ld + 2 * t;
      const __nv_bfloat16* a_hi = a_lo + 8 * p.ld;
      // Column tiles left of 16 * mt hold no pair with col > row.
      for (int nt0 = 2 * mt; nt0 < nt_end; nt0 += NG) {
        float c[NG][4];
#pragma unroll
        for (int j = 0; j < NG; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
        for (int kk = 0; kk < p.D_pad; kk += 16) {
          const uint32_t a0 = ld32(a_lo + kk), a1 = ld32(a_hi + kk);
          const uint32_t a2 = ld32(a_lo + kk + 8), a3 = ld32(a_hi + kk + 8);
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            if (nt0 + j < nt_end) {
              const __nv_bfloat16* bq = z + ((nt0 + j) * 8 + g) * p.ld + 2 * t + kk;
              mma_bf16(c[j], a0, a1, a2, a3, ld32(bq), ld32(bq + 8));
            }
          }
        }
#pragma unroll
        for (int j = 0; j < NG; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + g + 8 * h;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = (nt0 + j) * 8 + 2 * t + e;
              if (r < col && col < F)
                stage[base + pair_start(r, F) + (col - r - 1)] = c[j][2 * h + e];
            }
          }
        }
      }
      __syncwarp();
      if constexpr (std::is_same<IO, float>::value) {
        // stage[shift, shift + len) -> out[gs, gs + len), 16 bytes at a time
        // where a whole vector lies inside.
        float* dst = static_cast<float*>(p.out) + (gs - shift);
        const int n4 = (shift + len + 3) >> 2;
        for (int q = lane; q < n4; q += 32) {
          const int lo = 4 * q;
          if (lo >= shift && lo + 4 <= shift + len) {
            reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(stage)[q];
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (lo + e >= shift && lo + e < shift + len) dst[lo + e] = stage[lo + e];
          }
        }
      } else {
        // A bf16 row starts 2-byte aligned only: one element a lane, rounded.
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) + gs;
        for (int q = lane; q < len; q += 32) dst[q] = __float2bfloat16_rn(stage[shift + q]);
      }
      __syncwarp();  // the next block (or sample) overwrites the stage
    }
  }
}

// The stage of one warp: the largest row block (the first: the bottom copy
// and the pairs of rows 0..15) plus 3 floats of alignment, in floats.
int stage_len(int F, int D) {
  const int r1 = F - 1 < 16 ? F - 1 : 16;
  return (3 + D + r1 * (2 * F - r1 - 1) / 2 + 3) & ~3;
}

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

struct Args {
  int B, D, n_oh, n_feats;
  const void* bottom;
  long long bottom_ld;
  const long long *feat_ptrs, *feat_strides;
  const void* arena;
  long long arena_rows;
  const int* slots;
  long long slots_ld;
  const float* scales;
  long long scales_ld;
  const int *member_offs, *member_sizes;
  void* out;
  int vec4, oh_vec, warps, grid, smem;
};

template <typename AT, int MAXD, typename IO>
int launch(const Args& a, cudaStream_t stream) {
  Params<MAXD> p;
  p.B = a.B;
  p.D = a.D;
  p.n_oh = a.n_oh;
  p.n_fed = 1 + a.n_feats;
  p.F = p.n_fed + a.n_oh;
  p.D_pad = (a.D + 15) / 16 * 16;
  p.F_pad = (p.F + 15) / 16 * 16;
  p.ld = p.D_pad + 8;  // 16-byte row skew: conflict-free fragment loads
  p.P = p.F * (p.F - 1) / 2;
  p.stage_len = stage_len(p.F, a.D);
  p.warp_bytes = p.F_pad * p.ld * 2 + 4 * p.stage_len;
  p.oh_vec = a.oh_vec;
  p.oh_cpr = a.oh_vec ? a.D * static_cast<int>(sizeof(AT)) / 16 : 0;
  p.out_ld = a.D + p.P;
  p.out = a.out;
  p.arena = a.arena;
  p.arena_rows = a.arena_rows;
  p.slots = a.slots;
  p.slots_ld = a.slots_ld;
  p.scales = a.scales;
  p.scales_ld = a.scales_ld;
  p.fed[0].ptr = a.bottom;
  p.fed[0].stride = a.bottom_ld;
  for (int i = 0; i < a.n_feats; ++i) {
    p.fed[1 + i].ptr = reinterpret_cast<const void*>(a.feat_ptrs[i]);
    p.fed[1 + i].stride = a.feat_strides[i];
  }
  for (int j = 0; j < a.n_oh; ++j) {
    p.members[j].off = a.member_offs[j];
    p.members[j].size = a.member_sizes[j];
  }
  if (a.warps < 1 || a.warps > MAX_WARPS || a.grid < 1 ||
      a.smem != a.warps * p.warp_bytes || a.smem > MAX_SMEM ||
      (a.oh_vec && a.D * static_cast<int>(sizeof(AT)) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  static uint64_t done[2] = {0, 0};
  auto kern = a.vec4 ? dot_interaction_kernel<AT, true, MAXD, IO>
                     : dot_interaction_kernel<AT, false, MAXD, IO>;
  cudaError_t err = allow_smem(kern, done[a.vec4 ? 1 : 0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<a.grid, a.warps * 32, a.smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename AT, typename IO>
int launch_kind(const Args& a, cudaStream_t s) {
  if (a.n_feats < SMALL_DESC && a.n_oh <= SMALL_DESC) return launch<AT, SMALL_DESC, IO>(a, s);
  return launch<AT, MAX_DESC, IO>(a, s);
}

template <typename IO>
int launch_io(int arena_kind, const Args& a, cudaStream_t s) {
  switch (arena_kind) {
    case KIND_I8: return launch_kind<int8_t, IO>(a, s);
    case KIND_FP8: return launch_kind<__nv_fp8_e4m3, IO>(a, s);
    case KIND_BF16: return launch_kind<__nv_bfloat16, IO>(a, s);
    case KIND_F32: return launch_kind<float, IO>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------ the wide route
//
// Past one warp's z tile in shared memory (F = 688 at D = 128), or past
// MAX_DESC fed features or one-hot members, the plan takes this kernel
// (ops/fused_interaction.py k3_plan returns a K3WidePlan). A persistent CTA
// of 8 warps takes a sample at a time: its threads round the sample's rows
// to bf16 into the CTA's own z tile (F and D padded to 16, rows 16 bytes
// longer), then its warps walk the pair triangle in items of one 16-row
// block by NG column tiles, loading both operands' fragments from that
// tile, and stage each item's pairs so that a row's run of them is stored
// by consecutive lanes. The tile lives in shared memory where it fits a
// block's (F = 792 at D = 128), else in device memory (`scratch`), where
// the fragments are re-read per item from L2 or, once the tiles of every
// CTA pass L2, from device memory (the slower place, measured). The output is
// stored with the streaming hint (evict first), so that it does not push
// the tiles out of L2. The bottom copy goes out in f32. Descriptors (fed
// rows, members) come from device buffers, so F has no limit but device
// memory. The rounding and the products are the narrow kernel's: z rounded
// to bf16, products summed in f32 with mma.sync.

constexpr int WIDE_THREADS = 256;
constexpr int WIDE_BATCH = 8;  // fed loads a thread keeps in flight
constexpr int WIDE_STAGE_BYTES = (WIDE_THREADS / 32) * 16 * (NG * 8 + 1) * 4;  // static

struct WideParams {
  int B, D, n_oh, n_fed, F;      // F = n_fed + n_oh; fed row 0 is the bottom
  int D_pad, F_pad, ld;          // ld: row stride of the z tile (D_pad + 8)
  long long out_ld;              // D + P
  void* out;                     // f32 or bf16, the launch's IO type
  const void* arena;
  long long arena_rows;
  const int* slots;
  long long slots_ld;
  const float* scales;           // null -> 1
  long long scales_ld;
  const long long* fed;          // [n_fed][2]: row pointer and batch stride (elements)
  const int* members;            // [n_oh][2]: offset, size
  __nv_bfloat16* scratch;        // [gridDim.x][F_pad][ld], or null: z in shared memory
};

// One step of a 256-thread walk over a grid of `cols` columns.
__device__ __forceinline__ void wide_step(int& row, int& col, int drow, int dcol, int cols) {
  row += drow;
  col += dcol;
  if (col >= cols) {
    col -= cols;
    ++row;
  }
}

__device__ __forceinline__ long long pair_start64(long long r, long long F) {
  return r * (2 * F - r - 1) / 2;
}

template <typename AT, typename IO>
__global__ void __launch_bounds__(WIDE_THREADS)
    dot_interaction_wide_kernel(const __grid_constant__ WideParams p) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = WIDE_THREADS / 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  extern __shared__ __align__(16) unsigned char zsm[];
  const int F = p.F, D = p.D, ld = p.ld;
  __nv_bfloat16* z = p.scratch == nullptr
                         ? reinterpret_cast<__nv_bfloat16*>(zsm)
                         : p.scratch + static_cast<size_t>(blockIdx.x) * p.F_pad * ld;
  // Padding rows (>= F) and columns (>= D) stay zero for every sample.
  for (size_t i = tid; i < static_cast<size_t>(p.F_pad) * ld; i += WIDE_THREADS)
    z[i] = __float2bfloat16_rn(0.0f);
  const AT* arena = static_cast<const AT*>(p.arena);
  const int nt_end = (F + 7) >> 3;
  __shared__ float stage[WIDE_THREADS / 32][16][NG * 8 + 1];  // a warp's item of pairs:
                                                             // WIDE_STAGE_BYTES
  float (*st)[NG * 8 + 1] = stage[warp];
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    __syncthreads();  // the previous sample's product is done with z
    IO* orow = static_cast<IO*>(p.out) + static_cast<long long>(b) * p.out_ld;
    // The fed rows, then the one-hot rows: element tid + WIDE_THREADS i of
    // each as (row, column), stepped, with WIDE_BATCH loads a thread in
    // flight before any is used.
    const int drow = WIDE_THREADS / D, dcol = WIDE_THREADS - drow * D;
    int row = tid / D, col = tid - (tid / D) * D;
    while (row < p.n_fed) {
      float v[WIDE_BATCH];
      int rr[WIDE_BATCH], cc[WIDE_BATCH];
#pragma unroll
      for (int u = 0; u < WIDE_BATCH; ++u) {
        rr[u] = row;
        cc[u] = col;
        v[u] = row < p.n_fed ? ld_io(reinterpret_cast<const IO*>(__ldg(p.fed + 2 * row)) +
                                     b * __ldg(p.fed + 2 * row + 1) + col)
                             : 0.0f;
        wide_step(row, col, drow, dcol, D);
      }
#pragma unroll
      for (int u = 0; u < WIDE_BATCH; ++u) {
        if (rr[u] >= p.n_fed) break;
        z[static_cast<size_t>(rr[u] == 0 ? 0 : p.n_oh + rr[u]) * ld + cc[u]] =
            __float2bfloat16_rn(v[u]);
        if (rr[u] == 0) st_io_cs(orow + cc[u], v[u]);
      }
    }
    row = tid / D;
    col = tid - row * D;
    while (row < p.n_oh) {
      int sl[WIDE_BATCH], rr[WIDE_BATCH], cc[WIDE_BATCH];
      float sc[WIDE_BATCH];
      bool in[WIDE_BATCH];
#pragma unroll
      for (int u = 0; u < WIDE_BATCH; ++u) {
        rr[u] = row;
        cc[u] = col;
        sl[u] = 0;
        sc[u] = 1.0f;
        in[u] = false;
        if (row < p.n_oh) {
          sl[u] = __ldg(p.slots + row * p.slots_ld + b);
          if (p.scales != nullptr) sc[u] = __ldg(p.scales + row * p.scales_ld + b);
          const int off = __ldg(p.members + 2 * row), size = __ldg(p.members + 2 * row + 1);
          in[u] = sl[u] >= off && sl[u] < off + size && sl[u] >= 0 && sl[u] < p.arena_rows;
        }
        wide_step(row, col, drow, dcol, D);
      }
      float v[WIDE_BATCH];
#pragma unroll
      for (int u = 0; u < WIDE_BATCH; ++u)
        v[u] = in[u] ? to_f32(arena[static_cast<int64_t>(sl[u]) * D + cc[u]]) : 0.0f;
#pragma unroll
      for (int u = 0; u < WIDE_BATCH; ++u) {
        if (rr[u] >= p.n_oh) break;
        // Outside the member: 0 * scale; outside the arena: NaN.
        const float x = sl[u] < 0 || sl[u] >= p.arena_rows ? __int_as_float(0x7fc00000)
                                                           : v[u] * sc[u];
        z[static_cast<size_t>(1 + rr[u]) * ld + cc[u]] = __float2bfloat16_rn(x);
      }
    }
    __syncthreads();
    // Items (16-row block mt, NG column tiles from nt0) dealt over the warps.
    int item = 0;
    for (int mt = 0; mt * 16 < F - 1; ++mt) {
      const int r0 = mt * 16;
      for (int nt0 = 2 * mt; nt0 < nt_end; nt0 += NG, ++item) {
        if (item % nwarps != warp) continue;
        float c[NG][4];
#pragma unroll
        for (int j = 0; j < NG; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
        const __nv_bfloat16* a_lo = z + static_cast<size_t>(r0 + g) * ld + 2 * t;
        const __nv_bfloat16* a_hi = a_lo + 8 * ld;
#pragma unroll 4
        for (int kk = 0; kk < p.D_pad; kk += 16) {
          const uint32_t a0 = ld32(a_lo + kk), a1 = ld32(a_hi + kk);
          const uint32_t a2 = ld32(a_lo + kk + 8), a3 = ld32(a_hi + kk + 8);
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            if (nt0 + j < nt_end) {
              const __nv_bfloat16* bq =
                  z + static_cast<size_t>((nt0 + j) * 8 + g) * ld + 2 * t + kk;
              mma_bf16(c[j], a0, a1, a2, a3, ld32(bq), ld32(bq + 8));
            }
          }
        }
        // Through the warp's stage: a row's pairs of the item's 32 columns
        // are one contiguous run of the output, stored a lane a column.
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) st[g + 8 * h][j * 8 + 2 * t + e] = c[j][2 * h + e];
        __syncwarp();
        const int col = nt0 * 8 + lane;
        for (int r = r0; r < r0 + 16; ++r)
          if (r < col && col < F)
            st_io_cs(orow + D + pair_start64(r, F) + (col - r - 1), st[r - r0][lane]);
        __syncwarp();
      }
    }
  }
}

struct WideArgs {
  int B, D, n_oh, n_fed;
  const long long* fed;
  const void* arena;
  long long arena_rows;
  const int* slots;
  long long slots_ld;
  const float* scales;
  long long scales_ld;
  const int* members;
  void* out;
  __nv_bfloat16* scratch;
  int grid, smem;
};

template <typename AT, typename IO>
int launch_wide(const WideArgs& a, cudaStream_t stream) {
  WideParams p;
  p.B = a.B;
  p.D = a.D;
  p.n_oh = a.n_oh;
  p.n_fed = a.n_fed;
  p.F = a.n_fed + a.n_oh;
  p.D_pad = (a.D + 15) / 16 * 16;
  p.F_pad = (p.F + 15) / 16 * 16;
  p.ld = p.D_pad + 8;  // 16-byte row skew: conflict-free fragment loads from shared memory
  p.out_ld = a.D + static_cast<long long>(p.F) * (p.F - 1) / 2;
  p.out = a.out;
  p.arena = a.arena;
  p.arena_rows = a.arena_rows;
  p.slots = a.slots;
  p.slots_ld = a.slots_ld;
  p.scales = a.scales;
  p.scales_ld = a.scales_ld;
  p.fed = a.fed;
  p.members = a.members;
  p.scratch = a.scratch;
  // z in shared memory (no scratch): exactly its tile; in device memory: none.
  const long long tile = 2ll * p.F_pad * p.ld;
  if ((a.scratch == nullptr) != (a.smem > 0) || (a.smem > 0 && a.smem != tile) ||
      a.smem > MAX_SMEM - WIDE_STAGE_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = dot_interaction_wide_kernel<AT, IO>;
  if (a.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<a.grid, WIDE_THREADS, a.smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename IO>
int launch_wide_io(int arena_kind, const WideArgs& a, cudaStream_t s) {
  switch (arena_kind) {
    case KIND_I8: return launch_wide<int8_t, IO>(a, s);
    case KIND_FP8: return launch_wide<__nv_fp8_e4m3, IO>(a, s);
    case KIND_BF16: return launch_wide<__nv_bfloat16, IO>(a, s);
    case KIND_F32: return launch_wide<float, IO>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* hps_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bottom [B, D] (row stride bottom_ld); n_feats fed features, feature i
// at feat_ptrs[i] + b * feat_strides[i] (contiguous over D); n_oh
// gathered features from `arena` [arena_rows, D] of `arena_kind`, slot of
// (j, b) at slots[j * slots_ld + b], scale at scales[j * scales_ld + b]
// (scales may be null), member j's rows [member_offs[j], + member_sizes[j]);
// out [B, D + P], 16-byte aligned. The bottom, the fed features and out are
// f32, or bf16 with `io_bf16`. `vec4`: D % 4 == 0 and every fed row start
// is aligned to 4 values; `oh_vec`: arena rows are whole 16-byte chunks
// and the arena is 16-byte aligned (the caller checks). The plan (warps per
// CTA, grid, dynamic shared memory) comes from the caller
// (ops/fused_interaction.py k3_plan); a plan or a shape the kernel does not
// take returns cudaErrorInvalidValue. Returns cudaGetLastError() after the
// launch.
int hps_dot_interaction(int device, void* stream, int B, int D, int n_oh, int n_feats,
                        const void* bottom, long long bottom_ld,
                        const long long* feat_ptrs, const long long* feat_strides,
                        int arena_kind, const void* arena, long long arena_rows,
                        const int* slots, long long slots_ld, const float* scales,
                        long long scales_ld, const int* member_offs, const int* member_sizes,
                        void* out, int io_bf16, int vec4, int oh_vec, int warps, int grid,
                        int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_feats > MAX_DESC || n_feats < 0 || n_oh < 0 || n_oh > MAX_DESC || D < 1 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Args a{B, D, n_oh, n_feats, bottom, bottom_ld, feat_ptrs, feat_strides, arena,
               arena_rows, slots, slots_ld, scales, scales_ld, member_offs, member_sizes,
               out, vec4, n_oh > 0 && oh_vec, warps, grid, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return io_bf16 ? launch_io<__nv_bfloat16>(arena_kind, a, s) : launch_io<float>(arena_kind, a, s);
}

// The wide route (see above). fed [n_fed][2] int64 on the device: row
// pointer and batch stride (elements) of fed row i, row 0 the bottom;
// members [n_oh][2] int32 on the device; the arena, slots and scales as
// hps_dot_interaction's; out [B, D + P]; the fed rows and out f32, or bf16
// with `io_bf16`. The plan
// (ops/fused_interaction.py k3_plan, a K3WidePlan) gives the grid of
// 256-thread CTAs and where z lives: `smem` bytes of dynamic shared memory
// (2 * F_pad * (D_pad + 8), F and D rounded up to 16) and a null scratch,
// or smem 0 and a scratch of grid * F_pad * (D_pad + 8) bf16. Returns
// cudaGetLastError() after the launch.
int hps_dot_interaction_wide(int device, void* stream, int B, int D, int n_oh, int n_fed,
                             const long long* fed, int arena_kind, const void* arena,
                             long long arena_rows, const int* slots, long long slots_ld,
                             const float* scales, long long scales_ld, const int* members,
                             void* out, int io_bf16, void* scratch, int grid, int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 0 || D < 1 || n_fed < 1 || n_oh < 0 || grid < 1 || fed == nullptr || smem < 0 ||
      (n_oh > 0 && (members == nullptr || slots == nullptr || arena == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const WideArgs a{B, D, n_oh, n_fed, fed, arena, arena_rows, slots, slots_ld, scales,
                   scales_ld, members, out, static_cast<__nv_bfloat16*>(scratch), grid, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return io_bf16 ? launch_wide_io<__nv_bfloat16>(arena_kind, a, s)
                 : launch_wide_io<float>(arena_kind, a, s);
}

}  // extern "C"
