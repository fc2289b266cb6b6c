// Fused dequantize -> gate(s) -> requantize sweeps over the block-compressed
// ket of the TurboQuant engine, for Hopper (sm_90a).  Built by hand with
// nvcc into a shared library with a plain C interface and loaded with
// ctypes (qrack_tpu_torch/ops/turboquant_kernel.py, which also holds the
// plain PyTorch versions, a CPU emulation of the products below and the
// launch counts).
//
// Replaces the JAX package's Pallas kernels in
// qrack_tpu/ops/pallas_turboquant.py:
//   qtt_tq_gate_low  <- make_tq_gate_low (:95): one generic 2x2, target
//                       inside the tile;
//   qtt_tq_diag      <- make_tq_diag (:139): one diagonal, any target;
//   qtt_tq_window    <- make_tq_window (:186): a whole fused window, with
//                       the window's structure as a runtime int32 op table
//                       (kind, target, has_ctrl, float offset, int offset)
//                       over the split-mask operand layout of
//                       ops/fusion.py sharded_operands, so one binary
//                       serves every window.
// All three are one templated kernel, tq_sweep<BP, CT>.
//
// State: codes (B, 2D) int8 or int16, one row per block of D = 2^bp
// amplitudes ([re_0..re_{D-1}, im_0..im_{D-1}] rotated by the shared
// (2D, 2D) matrix), and scales (B,) float32.  A tile is T = 2^tp
// amplitudes, TB = T / D rows.  Per tile:
//   1. dequantize  rows = (codes @ rot_t) * (scale / qmax);
//   2. apply the gate or the window's ops to the tile's amplitudes;
//   3. y2 = rows @ rot, scale = max|y2| over the row,
//      codes = rint(y2 / (scale > 0 ? scale : 1) * qmax).
// A tile that no op acts on (its high control test fails, or a whole-tile
// diagonal factor is exactly 1) is not touched at all, so its codes and
// scales stay bit for bit, as the JAX kernels' select keeps them.  Which
// tiles those are depends only on the tile id, the masks and the payload,
// so a block decides it before it loads anything.
//
// Bound: the two products cost 2 * 2 * (2D)^2 flops per row of D
// amplitudes, 16 * D flops per amplitude (1024 at D = 64): 4.4e12 flops
// for a w32 sweep with every tile dirty, against 8.9 GB of code and scale
// bytes (5.3 ms at 3.35 TB/s).  So the kernel is bound by operations, and
// the design puts them on the tensor cores with float32 accuracy:
//  * Products as mma.sync m16n8k8 TF32 with a split operand ("3xTF32"):
//    x = hi + lo, hi = tf32(x), lo = tf32(x - hi), each rounded to nearest
//    with ties away from zero (cvt.rna.tf32.f32's rounding, done here as
//    two integer operations on the bit pattern, the same as tf32_rna in
//    ops/turboquant_kernel.py; the cvt instruction gives the same bits
//    and was slower on the H100), and lo*hi + hi*lo + hi*hi accumulated
//    in float32.  int8 codes are exact in TF32 (lo = 0), so the
//    first product takes two passes, codes times the split rotation, and
//    the row factor scale / qmax is applied to the product; the JAX
//    kernels multiply the codes by it first, so the rounding order
//    differs there.  int16 codes split exactly and take three.  At 495
//    TFLOP/s the 2 + 3 passes of a fully dirty w32 int8 sweep take
//    22.2 ms, the 3 + 3 of an int16 sweep 26.7 ms.
//  * 8 warps in a 2 x 4 grid, each owning 32 x 32 of a 64 x 128 output
//    (2 m16 x 4 n8 MMA tiles, 32 float accumulators) over 16 k8 steps.
//    Within a k8 step the k order is permuted (slot t is column 2t, slot
//    t + 4 column 2t + 1, the same for A and B), so a thread's two k values
//    are neighbours and load as one word where the layout allows.
//  * One float32 copy of the rotation in shared memory (64 KiB), read as
//    rot_t by the first product and as rot by the second, by addressing
//    alone; its fragments split into hi and lo in registers as they load.
//    For 2D < 128 it is held block-diagonal (128 / 2D copies), so every
//    block size runs the same 128-wide product and a row of the tile is a
//    128-wide "super-row" of code rows.  The rot_t argument is not read.
//  * Float arrays 128 wide (rotation, tile) swap the 8-word groups of a
//    row by an XOR with ((r ^ (r >> 1)) & 3) << 3, which keeps the
//    fragment loads of both reading orders free of bank conflicts; the
//    code buffers swap 8-byte (int8) or 16-byte (int16) chunks by r & 7.
//    A lane's fragment rows all share r & 7, so its addresses are a few
//    per-thread constants plus the step's offset.
//  * Each persistent block finds its next dirty tile ahead of time and
//    loads that tile's codes and scales with cp.async into a second
//    buffer while the current tile is in the products, gates and
//    requantize.  The codes stay codes in shared memory and convert to
//    exact floats (a byte permute and a subtraction) as the first
//    product's A fragments load, so no float copy of them is kept.
//  * Two blocks share an SM at int8 (115,200 bytes of shared memory and
//    at most 128 registers a thread each), so one block's products
//    overlap the other's gates, requantize and barriers.
//  * The gate and window stage (apply_gen, apply_diag, apply_cphase,
//    apply_window) works on the shared float32 tile between the two
//    products, and the requantize takes one warp per row, a lane
//    storing its neighbouring codes as one word.
//  * Launch parameters (shared-memory attributes, SM count, occupancy)
//    are computed once per template instance, device and tile size.
// Measured on an H100 (chip_smoke.py and PERF.md): a fully dirty w32
// int8 sweep takes about 80 ms, about 3.5 times its operations bound.
// Besides its MMAs, a warp issues the fragment loads and the hi/lo
// split of each operand on the same issue slots, and the MMAs hide only
// a part of them.
//
// Rounding: rintf-style round half to even (__float2int_rn, or the same
// by adding 1.5 * 2^23), the order y2 / safe * qmax and scale / qmax
// kept as in the JAX kernels.  The products' sums run in another order
// than cuBLAS's and the CPU's, and the split keeps about 22 of float32's
// 24 bits per operand, so a code can move by one where the exact value
// sits at a rounding boundary.
//
// Offsets into codes and scales are 64-bit (2^33 code bytes at w32);
// tile ids (up to 2^20) and in-tile indices are int32, and masks arrive
// split at the tile, so no mask above bit 31 travels as one int32.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

enum { K_CPHASE = 0, K_DIAG = 1, K_GEN = 3 };
enum { MODE_GATE_LOW = 0, MODE_DIAG = 1, MODE_WINDOW = 2 };
constexpr int ROW = 5;        // op-table columns
constexpr int THREADS = 256;  // 8 warps
constexpr int W = 128;        // product width: 2D, block-diagonal below 128
constexpr int MCH = 64;       // super-rows the 8 warps cover per pass
constexpr int MAX_DEV = 64;   // devices and tile sizes the launch cache keys
constexpr int MAX_TP = 32;

struct Params {
  void* codes;
  float* scales;
  const float* rot;
  int tp;
  int nblk;
  float qmax;
  int mode;
  // gate_low: m = mtrx_planes [re00, re01, re10, re11, im00, ..., im11];
  // diag: m[0..3] = d0.re, d0.im, d1.re, d1.im
  float m[8];
  int target, hm, hv, lm, lv, tm_lo, tb_hi;
  // window
  const int* table;
  int nops;
  const float* fv;
  const int* iv;
};

// ---------------------------------------------------------------------------
// shared-memory layout
// ---------------------------------------------------------------------------

// XOR that swaps the 8-word groups of row r of a 128-wide float array
// (rotation, tile); it depends on r & 7 only
__device__ __forceinline__ int rx(int r) { return ((r ^ (r >> 1)) & 3) << 3; }

// word of element f (= row * 128 + column) of such an array
__device__ __forceinline__ int sw(int f) { return f ^ rx(f >> 7); }

// XOR that swaps the 8-byte (int8) or 16-byte (int16) chunks of row r of
// a code buffer (128 codes a row); it depends on r & 7 only
template <typename CT>
__device__ __forceinline__ int cx(int r) {
  return (r & 7) << (sizeof(CT) == 1 ? 3 : 4);
}

// byte of code f (= row * 128 + column) of a code buffer
template <typename CT>
__device__ __forceinline__ int cbyte(int f) {
  return (f * (int)sizeof(CT)) ^ cx<CT>(f >> 7);
}

// super-rows of the float tile and of each code buffer
__host__ __device__ __forceinline__ int tile_rows(int tp) {
  const int rows = ((2 << tp) + W - 1) / W;
  return rows < MCH ? MCH : rows;
}

// the rotation, the float tile, two code buffers and two scale buffers
// (ops/turboquant_kernel.py smem_bytes)
size_t smem_bytes(int bp, int tp, int code_bytes) {
  const size_t mr = tile_rows(tp), tb = size_t(1) << (tp - bp);
  return sizeof(float) * (W * W + mr * W + 2 * tb) + 2 * mr * W * code_bytes;
}

// ---------------------------------------------------------------------------
// asynchronous copies and the split-TF32 product
// ---------------------------------------------------------------------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// TF32 bits of x, rounded to nearest with ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & ~0x1FFFu;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col) in TF32, float32 accumulators
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two neighbouring codes at p as exact floats: the biased code in the
// low mantissa bits of 2^23, minus 2^23 and the bias
template <typename CT>
__device__ __forceinline__ void codes2(const unsigned char* p, float& x0,
                                       float& x1) {
  if constexpr (sizeof(CT) == 1) {
    const uint32_t b = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
    x0 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540)) - 8388736.f;
    x1 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7541)) - 8388736.f;
  } else {
    const uint32_t b = *reinterpret_cast<const uint32_t*>(p) ^ 0x80008000u;
    x0 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7510)) - 8421376.f;
    x1 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7532)) - 8421376.f;
  }
}

// Fragment addressing.  Lane (g, t) = (lane / 4, lane % 4) holds A rows
// g and g + 8 of an m16 tile and B column g of an n8 tile, at k slots t
// and t + 4, which the k permutation places at columns k0 + 2t and
// k0 + 2t + 1.  A warp's rows and columns start at multiples of 32, so
// every row a lane reads as "row g" of a tile has r & 7 == g and one XOR
// swap, and the per-step offsets below are constants or one XOR.

// The first product for super-rows [r0, r0 + 32) and columns [c0, c0 + 32)
// of this warp: acc = codes (A, from the code buffer) @ rot_t (B[k][j] =
// rot[j][k], from the rotation by addressing).
template <typename CT>
__device__ __forceinline__ void product_codes(const unsigned char* cbuf,
                                              const float* rs, int r0, int c0,
                                              float (&acc)[2][4][4]) {
  constexpr int S = sizeof(CT);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned char* pa = cbuf + (r0 + g) * W * S + 2 * t * S;
  const int xa = cx<CT>(g), xb = rx(g);
  const float* pb = rs + (c0 + g) * W + 2 * t;
#pragma unroll 4
  for (int k0 = 0; k0 < W; k0 += 8) {
    const unsigned char* a0 = pa + ((k0 * S) ^ xa);
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x0, x1;
        codes2<CT>(a0 + (16 * mt + 8 * h) * W * S, x0, x1);
        if constexpr (S == 1) {  // exact in TF32
          ahi[mt][h] = __float_as_uint(x0);
          ahi[mt][2 + h] = __float_as_uint(x1);
        } else {
          split(x0, ahi[mt][h], alo[mt][h]);
          split(x1, ahi[mt][2 + h], alo[mt][2 + h]);
        }
      }
    }
    const float* b0 = pb + (k0 ^ xb);
    uint32_t bhi[4][2], blo[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(b0 + nt * 8 * W);
      split(b.x, bhi[nt][0], blo[nt][0]);
      split(b.y, bhi[nt][1], blo[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if constexpr (S != 1) mma(acc[mt][nt], alo[mt], bhi[nt]);
        mma(acc[mt][nt], ahi[mt], blo[nt]);
        mma(acc[mt][nt], ahi[mt], bhi[nt]);
      }
    }
  }
}

// The second product for this warp's 32 x 32: acc = tile (A, float) @ rot.
// B's rows k0 + 2t + e (e = 0, 1) have r & 7 == 2t + e.
__device__ __forceinline__ void product_tile(const float* v, const float* rs,
                                             int r0, int c0,
                                             float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* pa = v + (r0 + g) * W + 2 * t;
  const int xa = rx(g);
  int ob[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      ob[e][nt] = (2 * t + e) * W + c0 + g + ((nt * 8) ^ rx(2 * t + e));
#pragma unroll 4
  for (int k0 = 0; k0 < W; k0 += 8) {
    const float* a0 = pa + (k0 ^ xa);
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 a = *reinterpret_cast<const float2*>(
            a0 + (16 * mt + 8 * h) * W);
        split(a.x, ahi[mt][h], alo[mt][h]);
        split(a.y, ahi[mt][2 + h], alo[mt][2 + h]);
      }
    }
    const float* b0 = rs + k0 * W;
    uint32_t bhi[4][2], blo[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      split(b0[ob[0][nt]], bhi[nt][0], blo[nt][0]);
      split(b0[ob[1][nt]], bhi[nt][1], blo[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma(acc[mt][nt], alo[mt], bhi[nt]);
        mma(acc[mt][nt], ahi[mt], blo[nt]);
        mma(acc[mt][nt], ahi[mt], bhi[nt]);
      }
    }
  }
}

// Store this warp's accumulators into the float tile, each scaled by the
// row factor of its code row (fq == nullptr: unscaled).  Rows beyond the
// tile's TB code rows get factor 0.
template <int BP>
__device__ __forceinline__ void store_acc(float* v, const float* fq, int TB,
                                          int r0, int c0,
                                          const float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int x = rx(g);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * mt + 8 * h + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = c0 + nt * 8 + 2 * t;
        float s = 1.f;
        if (fq) {
          const int row = (r * W + c) >> (BP + 1);
          s = row < TB ? fq[row] : 0.f;
        }
        *reinterpret_cast<float2*>(v + r * W + (c ^ x)) =
            make_float2(acc[mt][nt][2 * h] * s, acc[mt][nt][2 * h + 1] * s);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the gate and window stage, on the float tile
// ---------------------------------------------------------------------------

// flat element of amplitude e's real part in the row layout
template <int BP>
__device__ __forceinline__ int amp(int e) {
  return ((e >> BP) << (BP + 1)) | (e & ((1 << BP) - 1));
}

template <int BP>
__device__ __forceinline__ void cmul_at(float* v, int e, float fr, float fi) {
  const int k = amp<BP>(e);
  const int kr = sw(k), ki = sw(k + (1 << BP));
  const float a = v[kr], b = v[ki];
  v[kr] = a * fr - b * fi;
  v[ki] = a * fi + b * fr;
}

// generic 2x2 on pairs (i0, i0 | 2^t) inside the tile, low control test
// per output element
template <int BP>
__device__ void apply_gen(float* v, int T, int t, const float* mat, int lm,
                          int lv) {
  constexpr int D = 1 << BP;
  float m[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = mat[k];
  const int half = T >> 1, low = (1 << t) - 1;
  for (int p = threadIdx.x; p < half; p += THREADS) {
    const int i0 = ((p >> t) << (t + 1)) | (p & low);
    const int i1 = i0 | (1 << t);
    const int k0 = amp<BP>(i0), k1 = amp<BP>(i1);
    const int k0r = sw(k0), k0i = sw(k0 + D), k1r = sw(k1), k1i = sw(k1 + D);
    const float a0r = v[k0r], a0i = v[k0i], a1r = v[k1r], a1i = v[k1i];
    if ((i0 & lm) == lv) {
      v[k0r] = m[0] * a0r - m[4] * a0i + m[1] * a1r - m[5] * a1i;
      v[k0i] = m[0] * a0i + m[4] * a0r + m[1] * a1i + m[5] * a1r;
    }
    if ((i1 & lm) == lv) {
      v[k1r] = m[2] * a0r - m[6] * a0i + m[3] * a1r - m[7] * a1i;
      v[k1i] = m[2] * a0i + m[6] * a0r + m[3] * a1i + m[7] * a1r;
    }
  }
}

// diagonal: factor d1 where the target bit is set (in-tile bit tm_lo, or
// the whole tile when hib), else d0; only where the low control test holds
template <int BP>
__device__ void apply_diag(float* v, int T, int tm_lo, bool hib, float d0r,
                           float d0i, float d1r, float d1i, int lm, int lv) {
  for (int e = threadIdx.x; e < T; e += THREADS) {
    if ((e & lm) == lv) {
      const bool bit = hib || (e & tm_lo) != 0;
      cmul_at<BP>(v, e, bit ? d1r : d0r, bit ? d1i : d0i);
    }
  }
}

template <int BP>
__device__ void apply_cphase(float* v, int T, int clo, float fr, float fi) {
  for (int e = threadIdx.x; e < T; e += THREADS)
    if ((e & clo) == clo) cmul_at<BP>(v, e, fr, fi);
}

// one window op's masks, split at the tile
struct OpMasks {
  int lm, lv, gm, gv;
};

__device__ __forceinline__ OpMasks op_masks(const Params& p, const int* row) {
  if (!row[2]) return {0, 0, 0, 0};
  const int* c = p.iv + row[4];
  return {c[0], c[1], c[2], c[3]};
}

__device__ __forceinline__ void cphase_masks(const Params& p, const int* row,
                                             int& clo, int& chi) {
  if (row[2]) {
    clo = p.iv[row[4]];
    chi = p.iv[row[4] + 1];
  } else {
    const long long comb = 1LL << row[1];
    clo = (int)(comb & ((1LL << p.tp) - 1));
    chi = (int)(comb >> p.tp);
  }
}

// does window op `row` act on tile blk, and must the tile be requantised?
__device__ __forceinline__ bool op_dirty(const Params& p, const int* row,
                                         int blk) {
  const int kind = row[0], t = row[1];
  if (kind == K_CPHASE) {
    int clo, chi;
    cphase_masks(p, row, clo, chi);
    return (blk & chi) == chi;
  }
  const OpMasks mk = op_masks(p, row);
  if ((blk & mk.gm) != mk.gv) return false;
  if (kind == K_DIAG && t >= p.tp) {
    // whole-tile constant factor: identically 1 keeps the tile exact
    const float* f = p.fv + row[3];
    const bool hib = (blk >> (t - p.tp)) & 1;
    const float cr = hib ? f[2] : f[0], ci = hib ? f[3] : f[1];
    return !(mk.lm == 0 && cr == 1.f && ci == 0.f);
  }
  return true;
}

__device__ bool tile_dirty(const Params& p, int blk) {
  if (p.mode == MODE_GATE_LOW) return (blk & p.hm) == p.hv;
  if (p.mode == MODE_DIAG) {
    const bool hib = (blk & p.tb_hi) != 0;
    const float cr = hib ? p.m[2] : p.m[0], ci = hib ? p.m[3] : p.m[1];
    const bool ident = p.tm_lo == 0 && p.lm == 0 && cr == 1.f && ci == 0.f;
    return (blk & p.hm) == p.hv && !ident;
  }
  for (int k = 0; k < p.nops; ++k)
    if (op_dirty(p, p.table + k * ROW, blk)) return true;
  return false;
}

// this block's first dirty tile at or after blk (nblk: none)
__device__ __forceinline__ int next_dirty(const Params& p, int blk) {
  for (; blk < p.nblk; blk += gridDim.x)
    if (tile_dirty(p, blk)) return blk;
  return p.nblk;
}

template <int BP>
__device__ void apply_window(const Params& p, float* v, int T, int blk) {
  for (int k = 0; k < p.nops; ++k) {
    const int* row = p.table + k * ROW;
    const int kind = row[0], t = row[1];
    const float* f = p.fv + row[3];
    if (!op_dirty(p, row, blk)) continue;   // block-uniform
    if (kind == K_CPHASE) {
      int clo, chi;
      cphase_masks(p, row, clo, chi);
      apply_cphase<BP>(v, T, clo, f[0], f[1]);
    } else if (kind == K_DIAG) {
      const OpMasks mk = op_masks(p, row);
      const int tm_lo = t < p.tp ? (1 << t) : 0;
      const bool hib = t >= p.tp && ((blk >> (t - p.tp)) & 1);
      apply_diag<BP>(v, T, tm_lo, hib, f[0], f[1], f[2], f[3], mk.lm, mk.lv);
    } else {
      const OpMasks mk = op_masks(p, row);
      apply_gen<BP>(v, T, t, f, mk.lm, mk.lv);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the sweep
// ---------------------------------------------------------------------------

// start the copies of tile blk's codes and scales into (cbuf, sbuf)
template <int BP, typename CT>
__device__ __forceinline__ void load_tile(const Params& p, int blk,
                                          unsigned char* cbuf, float* sbuf,
                                          int T, int TB) {
  constexpr int N = 2 << BP;
  const long long row0 = (long long)blk * TB;
  const CT* gc = static_cast<const CT*>(p.codes) + row0 * N;
  // copies of the chunks that the code buffer's XOR swap keeps whole
  constexpr int CPY = 8 * sizeof(CT);
  const int bytes = 2 * T * (int)sizeof(CT);
  if (bytes % CPY == 0) {
    const char* g8 = reinterpret_cast<const char*>(gc);
    for (int w = threadIdx.x; w < bytes / CPY; w += THREADS) {
      const int f0 = w * CPY / (int)sizeof(CT);
      cp_async<CPY>(cbuf + cbyte<CT>(f0), g8 + w * CPY);
    }
  } else {  // a tile smaller than one chunk: plain loads
    for (int f = threadIdx.x; f < 2 * T; f += THREADS)
      *reinterpret_cast<CT*>(cbuf + cbyte<CT>(f)) = gc[f];
  }
  const float* gs = p.scales + row0;
  for (int i = threadIdx.x; i < TB; i += THREADS) cp_async<4>(sbuf + i, gs + i);
}

// V floats from p (V <= 4, p aligned to V floats)
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = q.x, out[1] = q.y, out[2] = q.z, out[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    out[0] = q.x, out[1] = q.y;
  } else {
    out[0] = *p;
  }
}

// the low BYTES bytes of w to p, as one store
template <int BYTES>
__device__ __forceinline__ void store_bits(void* p, unsigned long long w) {
  if constexpr (BYTES == 8) *static_cast<unsigned long long*>(p) = w;
  if constexpr (BYTES == 4) *static_cast<uint32_t*>(p) = (uint32_t)w;
  if constexpr (BYTES == 2) *static_cast<uint16_t*>(p) = (uint16_t)w;
  if constexpr (BYTES == 1) *static_cast<uint8_t*>(p) = (uint8_t)w;
}

// two blocks a SM where the shared memory allows (the note at the top)
template <int BP, typename CT>
__global__ void __launch_bounds__(THREADS, 2) tq_sweep(Params p) {
  constexpr int N = 2 << BP;
  const int T = 1 << p.tp, TB = T >> BP;
  const int rows = ((2 << p.tp) + W - 1) / W;   // super-rows of the tile
  const int MR = tile_rows(p.tp);
  const int cbytes = MR * W * (int)sizeof(CT);
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);  // rotation, W x W
  float* v = rs + W * W;                        // float tile, MR x W
  // two code buffers (MR x W) and two scale buffers (TB)
  unsigned char* cb = reinterpret_cast<unsigned char*>(v + MR * W);
  float* sb = reinterpret_cast<float*>(cb + 2 * cbytes);

  // the block's first dirty tile starts loading before the rotation
  int cur = next_dirty(p, blockIdx.x);
  if (cur < p.nblk) load_tile<BP, CT>(p, cur, cb, sb, T, TB);
  cp_async_commit();
  for (int i = threadIdx.x; i < W * W; i += THREADS) {
    const int r = i / W, c = i % W;
    rs[sw(i)] = (r / N == c / N) ? p.rot[(r % N) * N + c % N] : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = (warp >> 2) * 32, wc = (warp & 3) * 32;
  CT* codes = static_cast<CT*>(p.codes);
  int stage = 0;
  while (cur < p.nblk) {
    const int nxt = next_dirty(p, cur + gridDim.x);
    if (nxt < p.nblk)
      load_tile<BP, CT>(p, nxt, cb + (stage ^ 1) * cbytes,
                        sb + (stage ^ 1) * TB, T, TB);
    cp_async_commit();
    cp_async_wait_prev();   // this thread's copies of tile cur are in
    __syncthreads();        // ... and everyone's; the last requantize is done
    float* fq = sb + stage * TB;   // the row factors replace the scales
    for (int i = threadIdx.x; i < TB; i += THREADS)
      fq[i] = __fdiv_rn(fq[i], p.qmax);
    __syncthreads();

    // 1. dequantize: rows = (codes @ rot_t) * (scale / qmax)
    for (int m0 = 0; m0 < rows; m0 += MCH) {
      if (m0 + wr < rows) {   // warp-uniform
        float acc[2][4][4] = {};
        product_codes<CT>(cb + stage * cbytes, rs, m0 + wr, wc, acc);
        store_acc<BP>(v, fq, TB, m0 + wr, wc, acc);
      }
    }
    __syncthreads();

    // 2. the gate or the window's ops
    if (p.mode == MODE_GATE_LOW) {
      apply_gen<BP>(v, T, p.target, p.m, p.lm, p.lv);
      __syncthreads();
    } else if (p.mode == MODE_DIAG) {
      apply_diag<BP>(v, T, p.tm_lo, (cur & p.tb_hi) != 0, p.m[0], p.m[1],
                     p.m[2], p.m[3], p.lm, p.lv);
      __syncthreads();
    } else {
      apply_window<BP>(p, v, T, cur);
    }

    // 3. y2 = rows @ rot, in place once every warp has read its rows
    for (int m0 = 0; m0 < rows; m0 += MCH) {
      const bool mine = m0 + wr < rows;
      float acc[2][4][4] = {};
      if (mine) product_tile(v, rs, m0 + wr, wc, acc);
      __syncthreads();
      if (mine) store_acc<BP>(v, nullptr, TB, m0 + wr, wc, acc);
    }
    __syncthreads();

    // 4. requantize, straight to the codes and scales in device memory
    const long long row0 = (long long)cur * TB;
    CT* gc = codes + row0 * N;
    float* gs = p.scales + row0;
    if constexpr (N >= 32) {
      // one warp per row, V neighbouring values a lane: max-abs by
      // shuffles, then the codes, stored as one word a lane.  Adding
      // 1.5 * 2^23 rounds half to even exactly as __float2int_rn does
      // for |q| <= qmax < 2^22, and leaves the integer in the low bits.
      constexpr int V = N / 32;
      for (int rr = warp; rr < TB; rr += THREADS / 32) {
        const int f = rr * N + lane * V;
        float vals[V];
        load_vec<V>(v + sw(f), vals);
        float mx = 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j) mx = fmaxf(mx, fabsf(vals[j]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float safe = mx > 0.f ? mx : 1.f;
        unsigned long long w = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float q = __fmul_rn(__fdiv_rn(vals[j], safe), p.qmax);
          const int c = __float_as_int(__fadd_rn(q, 12582912.f)) - 0x4B400000;
          w |= (unsigned long long)(c & ((1 << (8 * sizeof(CT))) - 1))
               << (8 * sizeof(CT) * j);
        }
        store_bits<V * sizeof(CT)>(gc + f, w);
        if (lane == 0) gs[rr] = mx;
      }
    } else {
      for (int rr = threadIdx.x; rr < TB; rr += THREADS) {
        float mx = 0.f;
        for (int j = 0; j < N; ++j) mx = fmaxf(mx, fabsf(v[sw(rr * N + j)]));
        const float safe = mx > 0.f ? mx : 1.f;
        for (int j = 0; j < N; ++j)
          gc[rr * N + j] = (CT)__float2int_rn(
              __fmul_rn(__fdiv_rn(v[sw(rr * N + j)], safe), p.qmax));
        gs[rr] = mx;
      }
    }
    cur = nxt;
    stage ^= 1;
  }
}

// Grid size (SMs times resident blocks) of tq_sweep<BP, CT> at tile 2^tp
// on the current device, computed on its first launch there and kept.
template <int BP, typename CT>
int grid_size(int tp, int& grid) {
  static std::atomic<int> cached[MAX_DEV][MAX_TP];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEV || tp >= MAX_TP) return (int)cudaErrorInvalidValue;
  grid = cached[dev][tp].load(std::memory_order_relaxed);
  if (grid > 0) return 0;
  auto kern = tq_sweep<BP, CT>;
  int optin = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
      (err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) ||
      (err = cudaFuncSetAttribute(
           kern, cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, smem_bytes(BP, tp, sizeof(CT)))))
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  grid = sms * per_sm;
  cached[dev][tp].store(grid, std::memory_order_relaxed);
  return 0;
}

template <int BP, typename CT>
int launch_t(const Params& p, cudaStream_t stream) {
  int grid = 0;
  const int err = grid_size<BP, CT>(p.tp, grid);
  if (err) return err;
  const unsigned blocks = (unsigned)(grid < p.nblk ? grid : p.nblk);
  tq_sweep<BP, CT><<<blocks, THREADS, smem_bytes(BP, p.tp, sizeof(CT)),
                     stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename CT>
int launch_bp(int bp, const Params& p, cudaStream_t stream) {
  switch (bp) {
    case 0: return launch_t<0, CT>(p, stream);
    case 1: return launch_t<1, CT>(p, stream);
    case 2: return launch_t<2, CT>(p, stream);
    case 3: return launch_t<3, CT>(p, stream);
    case 4: return launch_t<4, CT>(p, stream);
    case 5: return launch_t<5, CT>(p, stream);
    case 6: return launch_t<6, CT>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch(int code_bytes, int bp, const Params& p, void* stream) {
  if (code_bytes == 1)
    return launch_bp<int8_t>(bp, p, (cudaStream_t)stream);
  if (code_bytes == 2)
    return launch_bp<int16_t>(bp, p, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

Params base(void* codes, float* scales, const float* rot, int tp, int nblk,
            float qmax, int mode) {
  Params p = {};
  p.codes = codes;
  p.scales = scales;
  p.rot = rot;
  p.tp = tp;
  p.nblk = nblk;
  p.qmax = qmax;
  p.mode = mode;
  return p;
}

}  // namespace

extern "C" {

// Every entry point updates codes and scales in place on `stream`,
// allocates nothing, and returns 0 or the CUDA error of the launch.  The
// caller checks shapes, dtypes and that the tile fits
// (ops/turboquant_kernel.py).  rot_t is accepted and not read: the
// kernel reads rot both ways.

int qtt_tq_gate_low(void* codes, int code_bytes, float* scales,
                    const float* rot, const float* /*rot_t*/, int bp, int tp,
                    int nblk, float qmax, const float* m_host, int target,
                    int hm, int hv, int lm, int lv, void* stream) {
  Params p = base(codes, scales, rot, tp, nblk, qmax, MODE_GATE_LOW);
  for (int k = 0; k < 8; ++k) p.m[k] = m_host[k];
  p.target = target;
  p.hm = hm;
  p.hv = hv;
  p.lm = lm;
  p.lv = lv;
  return launch(code_bytes, bp, p, stream);
}

int qtt_tq_diag(void* codes, int code_bytes, float* scales, const float* rot,
                const float* /*rot_t*/, int bp, int tp, int nblk, float qmax,
                const float* d_host, int tm_lo, int tb_hi, int lm, int lv,
                int hm, int hv, void* stream) {
  Params p = base(codes, scales, rot, tp, nblk, qmax, MODE_DIAG);
  for (int k = 0; k < 4; ++k) p.m[k] = d_host[k];
  p.tm_lo = tm_lo;
  p.tb_hi = tb_hi;
  p.lm = lm;
  p.lv = lv;
  p.hm = hm;
  p.hv = hv;
  return launch(code_bytes, bp, p, stream);
}

int qtt_tq_window(void* codes, int code_bytes, float* scales,
                  const float* rot, const float* /*rot_t*/, int bp, int tp,
                  int nblk, float qmax, const int* table, int nops,
                  const float* fv, const int* iv, void* stream) {
  Params p = base(codes, scales, rot, tp, nblk, qmax, MODE_WINDOW);
  p.table = table;
  p.nops = nops;
  p.fv = fv;
  p.iv = iv;
  return launch(code_bytes, bp, p, stream);
}

}  // extern "C"
