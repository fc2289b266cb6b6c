// Fused dequantize -> gate(s) -> requantize sweeps over the block-compressed
// ket of the TurboQuant engine, for Hopper (sm_90a).  Built by hand with
// nvcc into a shared library with a plain C interface and loaded with
// ctypes (qrack_tpu_torch/ops/turboquant_kernel.py, which also holds the
// plain PyTorch versions and the launch counts).
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
//
// State: codes (B, 2D) int8 or int16, one row per block of D = 2^bp
// amplitudes ([re_0..re_{D-1}, im_0..im_{D-1}] rotated by the shared
// (2D, 2D) matrix), and scales (B,) float32.  A tile is T = 2^tp
// amplitudes, TB = T / D rows.  Per tile:
//   1. dequantize  y = codes * (scale / qmax), rows = y @ rot_t;
//   2. apply the gate or the window's ops to the tile's amplitudes
//      (amplitude e sits at row e >> bp, column e & (D-1), imaginary part
//      D columns further on);
//   3. y2 = rows @ rot, scale = max|y2| over the row,
//      codes = rint(y2 / (scale > 0 ? scale : 1) * qmax).
// A tile that no op acts on (its high control test fails, or a whole-tile
// diagonal factor is exactly 1) is not touched at all, so its codes and
// scales stay bit for bit, as the JAX kernels' select keeps them.  Which
// tiles those are depends only on the tile id, the masks and the payload,
// so a block decides it before it loads anything.
//
// Bound: the two products cost 2 * 2 * (2D)^2 flops per row of D
// amplitudes, 16 * D flops per amplitude (1024 at D = 64), in IEEE
// float32 (no tensor cores: TF32 would keep three digits).  At the H100's
// 67 TFLOP/s that is about 65.6 ms for a w32 sweep, against 5.3 ms for
// its bytes, so the kernel is bound by operations.  The design therefore
// keeps both rotations resident in shared memory (one persistent block
// per SM walks over tiles) and blocks the products in registers: a thread
// holds 8 rows x 4 columns of the output, reads its 4 columns of the
// rotation as one 16-byte load and each row value as a warp-wide
// broadcast.  No tensor cores, TMA or double buffering yet.
//
// Rounding: rintf-style round half to even (__float2int_rn), the order
// y2 / safe * qmax and scale / qmax kept as in the JAX kernels.  The
// products' sum order differs from cuBLAS's and the CPU's, so a code can
// move by one where the exact value sits at a rounding boundary.
//
// Offsets into codes and scales are 64-bit (2^33 code bytes at w32);
// tile ids (up to 2^20) and in-tile indices are int32, and masks arrive
// split at the tile, so no mask above bit 31 travels as one int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { K_CPHASE = 0, K_DIAG = 1, K_GEN = 3 };
enum { MODE_GATE_LOW = 0, MODE_DIAG = 1, MODE_WINDOW = 2 };
constexpr int ROW = 5;        // op-table columns
constexpr int THREADS = 256;
constexpr int RB = 8;         // output rows a thread holds in a product

struct Params {
  void* codes;
  float* scales;
  const float* rot;
  const float* rot_t;
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

// C = A (M x N) @ B (N x N), all row-major in shared memory.  Every
// thread of the block calls it; the caller puts a barrier after it.
template <int N>
__device__ __forceinline__ void matmul(const float* __restrict__ A,
                                       const float* __restrict__ B,
                                       float* __restrict__ C, int M) {
  constexpr int CW = N >= 4 ? 4 : N;   // output columns per thread
  constexpr int NTX = N / CW;          // threads across a row
  constexpr int NTY = THREADS / NTX;   // row groups
  const int tx = threadIdx.x % NTX, ty = threadIdx.x / NTX;
  for (int r0 = ty * RB; r0 < M; r0 += NTY * RB) {
    float acc[RB][CW];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;
    const int rows = M - r0 < RB ? M - r0 : RB;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float b[CW];
      if constexpr (CW == 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(B + k * N + tx * 4);
        b[0] = b4.x; b[1] = b4.y; b[2] = b4.z; b[3] = b4.w;
      } else {
#pragma unroll
        for (int j = 0; j < CW; ++j) b[j] = B[k * N + tx * CW + j];
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float a = i < rows ? A[(r0 + i) * N + k] : 0.f;
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (i < rows) {
#pragma unroll
        for (int j = 0; j < CW; ++j) C[(r0 + i) * N + tx * CW + j] = acc[i][j];
      }
    }
  }
}

// index of amplitude e's real part in the row layout
template <int BP>
__device__ __forceinline__ int amp(int e) {
  return ((e >> BP) << (BP + 1)) | (e & ((1 << BP) - 1));
}

template <int BP>
__device__ __forceinline__ void cmul_at(float* v, int e, float fr, float fi) {
  const int k = amp<BP>(e);
  const float a = v[k], b = v[k + (1 << BP)];
  v[k] = a * fr - b * fi;
  v[k + (1 << BP)] = a * fi + b * fr;
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
    const float a0r = v[k0], a0i = v[k0 + D], a1r = v[k1], a1i = v[k1 + D];
    if ((i0 & lm) == lv) {
      v[k0] = m[0] * a0r - m[4] * a0i + m[1] * a1r - m[5] * a1i;
      v[k0 + D] = m[0] * a0i + m[4] * a0r + m[1] * a1i + m[5] * a1r;
    }
    if ((i1 & lm) == lv) {
      v[k1] = m[2] * a0r - m[6] * a0i + m[3] * a1r - m[7] * a1i;
      v[k1 + D] = m[2] * a0i + m[6] * a0r + m[3] * a1i + m[7] * a1r;
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

template <int BP, typename CT>
__global__ void __launch_bounds__(THREADS) tq_sweep(Params p) {
  constexpr int D = 1 << BP, N = 2 * D;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* rt = smem;            // rot_t (N x N)
  float* r = rt + N * N;       // rot   (N x N)
  const int T = 1 << p.tp, TB = T >> BP;
  float* y = r + N * N;        // TB x N
  float* v = y + TB * N;       // TB x N
  float* fq = v + TB * N;      // TB row factors scale / qmax
  for (int i = threadIdx.x; i < N * N; i += THREADS) {
    rt[i] = p.rot_t[i];
    r[i] = p.rot[i];
  }
  __syncthreads();
  CT* codes = static_cast<CT*>(p.codes);
  // codes of a tile in 16-byte words, when the tile is a whole number of
  // them (every tile of at least 16 bytes: T is a power of two)
  constexpr int PER16 = 16 / sizeof(CT);
  const bool vec = (TB * N) % PER16 == 0;
  for (int blk = blockIdx.x; blk < p.nblk; blk += gridDim.x) {
    if (!tile_dirty(p, blk)) continue;   // block-uniform
    const long long row0 = (long long)blk * TB;
    CT* gc = codes + row0 * N;
    float* gs = p.scales + row0;
    for (int i = threadIdx.x; i < TB; i += THREADS)
      fq[i] = __fdiv_rn(gs[i], p.qmax);
    __syncthreads();
    if (vec) {
      const uint4* g16 = reinterpret_cast<const uint4*>(gc);
#pragma unroll 2
      for (int w = threadIdx.x; w < TB * N / PER16; w += THREADS) {
        const uint4 word = g16[w];
        const unsigned u[4] = {word.x, word.y, word.z, word.w};
#pragma unroll
        for (int j = 0; j < PER16; ++j) {
          const int i = w * PER16 + j;
          float c;
          if constexpr (sizeof(CT) == 1)
            c = (float)(int8_t)((u[j >> 2] >> (8 * (j & 3))) & 0xffu);
          else
            c = (float)(int16_t)((u[j >> 1] >> (16 * (j & 1))) & 0xffffu);
          y[i] = __fmul_rn(c, fq[i >> (BP + 1)]);
        }
      }
    } else {
      for (int i = threadIdx.x; i < TB * N; i += THREADS)
        y[i] = __fmul_rn((float)gc[i], fq[i >> (BP + 1)]);
    }
    __syncthreads();
    matmul<N>(y, rt, v, TB);
    __syncthreads();
    if (p.mode == MODE_GATE_LOW) {
      apply_gen<BP>(v, T, p.target, p.m, p.lm, p.lv);
      __syncthreads();
    } else if (p.mode == MODE_DIAG) {
      apply_diag<BP>(v, T, p.tm_lo, (blk & p.tb_hi) != 0, p.m[0], p.m[1],
                     p.m[2], p.m[3], p.lm, p.lv);
      __syncthreads();
    } else {
      apply_window<BP>(p, v, T, blk);
    }
    matmul<N>(v, r, y, TB);
    __syncthreads();
    if constexpr (N >= 32) {
      // one warp per row: max-abs by shuffles, then the codes
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      for (int rr = warp; rr < TB; rr += THREADS / 32) {
        float vals[N / 32];
        float mx = 0.f;
#pragma unroll
        for (int j = 0; j < N / 32; ++j) {
          vals[j] = y[rr * N + lane + 32 * j];
          mx = fmaxf(mx, fabsf(vals[j]));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float safe = mx > 0.f ? mx : 1.f;
#pragma unroll
        for (int j = 0; j < N / 32; ++j)
          gc[rr * N + lane + 32 * j] =
              (CT)__float2int_rn(__fmul_rn(__fdiv_rn(vals[j], safe), p.qmax));
        if (lane == 0) gs[rr] = mx;
      }
    } else {
      for (int rr = threadIdx.x; rr < TB; rr += THREADS) {
        float mx = 0.f;
        for (int j = 0; j < N; ++j) mx = fmaxf(mx, fabsf(y[rr * N + j]));
        const float safe = mx > 0.f ? mx : 1.f;
        for (int j = 0; j < N; ++j)
          gc[rr * N + j] = (CT)__float2int_rn(
              __fmul_rn(__fdiv_rn(y[rr * N + j], safe), p.qmax));
        gs[rr] = mx;
      }
    }
    __syncthreads();
  }
}

// both rotations, two tile buffers (2T floats each) and TB row factors
size_t smem_bytes(int bp, int tp) {
  const size_t n = size_t(2) << bp;
  return sizeof(float) * (2 * n * n + 4 * (size_t(1) << tp) +
                          (size_t(1) << (tp - bp)));
}

template <int BP, typename CT>
int launch_t(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(BP, p.tp);
  auto kern = tq_sweep<BP, CT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(want < p.nblk ? want : p.nblk);
  kern<<<grid, THREADS, smem, stream>>>(p);
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

Params base(void* codes, float* scales, const float* rot, const float* rot_t,
            int tp, int nblk, float qmax, int mode) {
  Params p = {};
  p.codes = codes;
  p.scales = scales;
  p.rot = rot;
  p.rot_t = rot_t;
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
// caller checks shapes, dtypes and that the tile and rotations fit
// (ops/turboquant_kernel.py).

int qtt_tq_gate_low(void* codes, int code_bytes, float* scales,
                    const float* rot, const float* rot_t, int bp, int tp,
                    int nblk, float qmax, const float* m_host, int target,
                    int hm, int hv, int lm, int lv, void* stream) {
  Params p = base(codes, scales, rot, rot_t, tp, nblk, qmax, MODE_GATE_LOW);
  for (int k = 0; k < 8; ++k) p.m[k] = m_host[k];
  p.target = target;
  p.hm = hm;
  p.hv = hv;
  p.lm = lm;
  p.lv = lv;
  return launch(code_bytes, bp, p, stream);
}

int qtt_tq_diag(void* codes, int code_bytes, float* scales, const float* rot,
                const float* rot_t, int bp, int tp, int nblk, float qmax,
                const float* d_host, int tm_lo, int tb_hi, int lm, int lv,
                int hm, int hv, void* stream) {
  Params p = base(codes, scales, rot, rot_t, tp, nblk, qmax, MODE_DIAG);
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
                  const float* rot, const float* rot_t, int bp, int tp,
                  int nblk, float qmax, const int* table, int nops,
                  const float* fv, const int* iv, void* stream) {
  Params p = base(codes, scales, rot, rot_t, tp, nblk, qmax, MODE_WINDOW);
  p.table = table;
  p.nops = nops;
  p.fv = fv;
  p.iv = iv;
  return launch(code_bytes, bp, p, stream);
}

}  // extern "C"
