// Single-sweep fused gate window over a dense split-plane ket, for Hopper
// (sm_90a).  Built by hand with nvcc into a shared library with a plain C
// interface and loaded with ctypes (qrack_tpu_torch/ops/window_kernel.py,
// which also holds the plain PyTorch version and the launch counts).
//
// Replaces the JAX package's Pallas window kernel,
// qrack_tpu/ops/pallas_kernels.py::_segment_program: its in-tile body
// (`kernel`, :294) is qtt_window_in_tile and its cross-tile pair body
// (`kernel`, :315) is qtt_window_pair.  Same operands: the packed float
// vector fv and int32 vector iv of pack_operands, plus an int32 op table
// (kind, target, has_ctrl, float offset, int offset per op) that carries
// the window's structure at run time, so this one compiled kernel serves
// every window structure (the JAX package compiles one program per
// structure).
//
// Ket layout: planes[0 .. 2^n) = Re, planes[2^n .. 2^(n+1)) = Im, in the
// planes' dtype T: float32, float64, float16 or bfloat16 (the Pallas
// kernel is generic in it, pallas_kernels.py:301, :357, :383).  fv is in
// T too.  Arithmetic runs in C = Amp<T>::C: double for float64 planes,
// float for the others.  16-bit planes are read into float registers,
// the whole segment runs in float, and each amplitude is rounded to T
// once, at the store (round to nearest even); the Pallas kernel rounds
// after every op, so this kernel's 16-bit results are a few roundings
// closer to exact.
// A tile is 2^bp consecutive amplitudes of both planes.
//
// Both sweeps write in place and read and write every amplitude once:
// 2 * 2 * 2^n * sizeof(T) bytes, 17.2 GB at n = 30 in float32 (about
// 5.1 ms at the H100 SXM's 3.35 TB/s), twice that in float64, half in
// 16 bits.  Masks and tile ids are int32, as in the JAX kernel (n <= 30);
// global offsets are 64-bit (2^31 amplitudes at n = 30).
//
// K1, window_in_tile (pallas_kernels.py:294): one block per tile.  The
// block loads its tile into shared memory (in C: 32 KB at bp = 12 for
// float and 16-bit planes, 64 KB for double), applies the segment's ops
// in order with a barrier after each (tile_op passes over the whole
// tile), and writes the tile back.
//
// K2, window_pair (pallas_kernels.py:315): one block per tile PAIR i,
// j = i | (1 << h), h = target - bp of the segment's leading inv/gen.  One
// block owns both tiles, since the sweep writes in place.  What bounds
// it: the bytes above for short segments; for long ones (RunFused of a
// QFT puts about 294 ops in its last segment) the instructions the CUDA
// cores issue per op.  A design that passes over a tile in shared memory
// once per op, as K1 does, is bound instead by shared-memory bandwidth
// (2^13 amplitudes * 16 B per pair and op), far above both.  So the pair
// lives in registers:
//  * Layout (pair_layout in ops/window_kernel.py mirrors it).  A thread
//    holds NR = 2^(RIN + 1) amplitudes, RIN = min(R, bp) with R = 4 for
//    float and 16-bit planes and R = 3 for double (a double takes two
//    registers: 16 of them a plane keep the data at 64 registers, as 32
//    floats do): both tiles of the pair (register bit RIN) times RIN
//    in-tile "register bits", the two lowest in-tile bits and the RIN - 2
//    highest.  The other in-tile bits index the thread: its low five are
//    the lane, the rest the warp.  Neighbouring threads hold neighbouring
//    groups of four amplitudes, so every load and store is one vector
//    access a thread per group and plane (16 B for float, two of 16 B for
//    double, 8 B for 16-bit planes), coalesced.  At bp = 12 a block is
//    256 threads of 32 amplitudes (512 threads of 16 for double).
//  * Decode.  Each op's masks are split once per block into a tile part
//    (tested against tile i; a failing op is skipped by the whole
//    block), a thread part and a register part, and written with its
//    route and payload to a descriptor in shared memory, CHUNK ops at a
//    time.  So an op costs each thread a few shared-memory broadcasts
//    and a test, not a test per element.
//  * Diagonal ops (cphase, diag; any target, any controls) run in
//    registers with no barrier: the register part picks the registers a
//    cphase touches through a switch over compile-time subsets, so a
//    cphase costs about its touched amplitudes.
//  * inv/gen.  The leading cross-tile op and in-tile targets on a
//    register bit mix registers; a lane-bit target exchanges with
//    __shfl_xor_sync; a warp-bit target takes one round through shared
//    memory (store, barrier, load the partner thread's values, barrier).
//    Only that route pays barriers.
//  * Occupancy: at most 128 registers a thread (launch bounds 512).
//    Shared memory at bp = 12: about 68 KB for float and 16-bit planes
//    (two blocks an SM, so one block's loads overlap the other's ops),
//    134 KB for double (one block an SM).  A double pair at bp = 13
//    would need 262 KB, past the 227 KB a block may take, so double
//    planes take bp <= 12 (window_kernel.MAX_BLOCK_POW).

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

namespace {

enum { K_CPHASE = 0, K_DIAG = 1, K_INV = 2, K_GEN = 3 };
constexpr int ROW = 5;        // op-table columns
constexpr int THREADS = 512;

// dtype codes of the C entry points (window_kernel.DTYPE_CODE)
enum { DT_F32 = 0, DT_F64 = 1, DT_F16 = 2, DT_BF16 = 3 };

template <typename C>
struct Quad {
  C x, y, z, w;
};

// Amplitude storage type T: its compute type C, one-value conversions,
// and the four-value vector accesses of the pair kernel's groups.
template <typename T>
struct Amp;

template <>
struct Amp<float> {
  using C = float;
  static constexpr int PAIR_REG_BITS = 4;
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ Quad<float> load4(const float* p) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    return {a.x, a.y, a.z, a.w};
  }
  static __device__ __forceinline__ void store4(float* p, Quad<float> q) {
    *reinterpret_cast<float4*>(p) = make_float4(q.x, q.y, q.z, q.w);
  }
};

template <>
struct Amp<double> {
  using C = double;
  static constexpr int PAIR_REG_BITS = 3;
  static __device__ __forceinline__ double load(double x) { return x; }
  static __device__ __forceinline__ double store(double x) { return x; }
  static __device__ __forceinline__ Quad<double> load4(const double* p) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    return {a.x, a.y, b.x, b.y};
  }
  static __device__ __forceinline__ void store4(double* p, Quad<double> q) {
    *reinterpret_cast<double2*>(p) = make_double2(q.x, q.y);
    *reinterpret_cast<double2*>(p + 2) = make_double2(q.z, q.w);
  }
};

struct __align__(8) Half4 {
  __half2 a, b;
};
struct __align__(8) Bf4 {
  __nv_bfloat162 a, b;
};

template <>
struct Amp<__half> {
  using C = float;
  static constexpr int PAIR_REG_BITS = 4;
  static __device__ __forceinline__ float load(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half store(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ Quad<float> load4(const __half* p) {
    const Half4 v = *reinterpret_cast<const Half4*>(p);
    const float2 a = __half22float2(v.a), b = __half22float2(v.b);
    return {a.x, a.y, b.x, b.y};
  }
  static __device__ __forceinline__ void store4(__half* p, Quad<float> q) {
    Half4 v;
    v.a = __floats2half2_rn(q.x, q.y);
    v.b = __floats2half2_rn(q.z, q.w);
    *reinterpret_cast<Half4*>(p) = v;
  }
};

template <>
struct Amp<__nv_bfloat16> {
  using C = float;
  static constexpr int PAIR_REG_BITS = 4;
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ Quad<float> load4(const __nv_bfloat16* p) {
    const Bf4 v = *reinterpret_cast<const Bf4*>(p);
    const float2 a = __bfloat1622float2(v.a), b = __bfloat1622float2(v.b);
    return {a.x, a.y, b.x, b.y};
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p,
                                                Quad<float> q) {
    Bf4 v;
    v.a = __floats2bfloat162_rn(q.x, q.y);
    v.b = __floats2bfloat162_rn(q.z, q.w);
    *reinterpret_cast<Bf4*>(p) = v;
  }
};

// One in-tile op on one resident tile (re, im: 2^bp values each) whose
// tile id is blk.  Every thread of the block calls it; the caller puts a
// barrier after it.  A tile that fails the high part of the control mask
// keeps its values exactly, as the JAX kernel's select does.
template <typename T, typename C>
__device__ __forceinline__ void tile_op(C* re, C* im, int bp, int blk,
                                        const int* __restrict__ row,
                                        const T* __restrict__ fv,
                                        const int* __restrict__ iv) {
  const int kind = row[0], t = row[1], has_ctrl = row[2];
  const T* f = fv + row[3];
  const int cm = has_ctrl ? iv[row[4]] : 0;
  const int cv = has_ctrl ? iv[row[4] + 1] : 0;
  const int block = 1 << bp;
  const int lbits = block - 1;

  if (kind == K_CPHASE) {
    // combined mask (1 << t) | cm, split at bp
    const int comb = (1 << t) | cm;
    const int clo = comb & lbits, chi = comb >> bp;
    if ((blk & chi) != chi) return;
    const C fr = Amp<T>::load(f[0]), fi = Amp<T>::load(f[1]);
    for (int e = threadIdx.x; e < block; e += blockDim.x) {
      if ((e & clo) == clo) {
        const C a = re[e], b = im[e];
        re[e] = a * fr - b * fi;
        im[e] = a * fi + b * fr;
      }
    }
    return;
  }

  const int lm = cm & lbits, lv = cv & lbits, gm = cm >> bp, gv = cv >> bp;
  if ((blk & gm) != gv) return;

  if (kind == K_DIAG) {
    // target below bp: per element; at or above bp: per tile
    const int tlo = t < bp ? (1 << t) : 0;
    const bool hib = t >= bp && ((blk >> (t - bp)) & 1);
    const C d0r = Amp<T>::load(f[0]), d0i = Amp<T>::load(f[1]);
    const C d1r = Amp<T>::load(f[2]), d1i = Amp<T>::load(f[3]);
    for (int e = threadIdx.x; e < block; e += blockDim.x) {
      if ((e & lm) == lv) {
        const bool bit = hib || (e & tlo) != 0;
        const C fr = bit ? d1r : d0r, fi = bit ? d1i : d0i;
        const C a = re[e], b = im[e];
        re[e] = a * fr - b * fi;
        im[e] = a * fi + b * fr;
      }
    }
    return;
  }

  // inv / gen with t < bp: pair (i0, i1) at distance 2^t inside the tile
  // an inv op has 4 values in fv, a gen op 8: read no further
  const int nf = kind == K_GEN ? 8 : 4;
  C m[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = k < nf ? Amp<T>::load(f[k]) : C(0);
  const int half = block >> 1, low = (1 << t) - 1;
  for (int p = threadIdx.x; p < half; p += blockDim.x) {
    const int i0 = ((p >> t) << (t + 1)) | (p & low);
    const int i1 = i0 | (1 << t);
    const C a0r = re[i0], a0i = im[i0], a1r = re[i1], a1i = im[i1];
    C n0r, n0i, n1r, n1i;
    if (kind == K_INV) {  // [tr.re, tr.im, bl.re, bl.im]
      n0r = m[0] * a1r - m[1] * a1i;
      n0i = m[0] * a1i + m[1] * a1r;
      n1r = m[2] * a0r - m[3] * a0i;
      n1i = m[2] * a0i + m[3] * a0r;
    } else {  // [re00, re01, re10, re11, im00, im01, im10, im11]
      n0r = m[0] * a0r - m[4] * a0i + m[1] * a1r - m[5] * a1i;
      n0i = m[0] * a0i + m[4] * a0r + m[1] * a1i + m[5] * a1r;
      n1r = m[2] * a0r - m[6] * a0i + m[3] * a1r - m[7] * a1i;
      n1i = m[2] * a0i + m[6] * a0r + m[3] * a1i + m[7] * a1r;
    }
    if ((i0 & lm) == lv) { re[i0] = n0r; im[i0] = n0i; }
    if ((i1 & lm) == lv) { re[i1] = n1r; im[i1] = n1i; }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_in_tile(T* __restrict__ planes, int n, int bp,
               const int* __restrict__ table, int first, int count,
               const T* __restrict__ fv, const int* __restrict__ iv) {
  using C = typename Amp<T>::C;
  extern __shared__ float4 smem4[];
  const int block = 1 << bp;
  C* re = reinterpret_cast<C*>(smem4);
  C* im = re + block;
  const int blk = blockIdx.x;
  T* gre = planes + ((long long)blk << bp);
  T* gim = gre + (1LL << n);
  for (int e = threadIdx.x; e < block; e += blockDim.x) {
    re[e] = Amp<T>::load(gre[e]);
    im[e] = Amp<T>::load(gim[e]);
  }
  __syncthreads();
  for (int k = 0; k < count; ++k) {
    tile_op<T, C>(re, im, bp, blk, table + (first + k) * ROW, fv, iv);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < block; e += blockDim.x) {
    gre[e] = Amp<T>::store(re[e]);
    gim[e] = Amp<T>::store(im[e]);
  }
}

// ---------------------------------------------------------------------------
// K2: the pair sweep in registers
// ---------------------------------------------------------------------------

constexpr int LANE_BITS = 5;
constexpr int PAIR_THREADS = 512; // the most a pair block has
constexpr int CHUNK = 64;         // op descriptors decoded per round

// descriptor routes
enum { D_SKIP = 0, D_CPHASE = 1, D_DIAG = 2, D_REG = 3, D_LANE = 4,
       D_SMEM = 5 };

// One decoded op.  An op's index test (idx & cm) == cv splits into three
// parts that together are the whole test: tile (decided at decode),
// thread ((tid & tm) == tv) and register ((k & rm) == rv).  A cphase
// keeps its combined mask in rm/tm with rv = rm, tv = tm.
template <typename C>
struct __align__(16) Desc {
  int type;  // D_*
  int idx;   // register bit (diag, D_REG) or thread bit (D_LANE, D_SMEM)
  int rm, rv, tm, tv;
  int tt;    // diag: one-hot thread bit of the target, else 0
  int ub;    // diag: the target's bit when it is a tile bit, else 0
  C f[8];    // cphase [re, im]; diag [d0, d1]; 2x2 [re00 re01 re10 re11 im..]
};

template <int RIN>
struct PairLayout {
  static constexpr int LO = RIN < 2 ? RIN : 2;  // low in-tile register bits
  static constexpr int HI = RIN - LO;           // high in-tile register bits
  int bp, h, hs, tbits, tile;  // hs = bp - HI; tile i (bit h clear)

  // register part: bits 0..LO-1, then bits hs..bp-1, then the pair bit
  __device__ __forceinline__ int rpart(int m) const {
    return (m & ((1 << LO) - 1)) | (((m >> hs) & ((1 << HI) - 1)) << LO) |
           (((m >> (bp + h)) & 1) << RIN);
  }
  __device__ __forceinline__ int tpart(int m) const {
    return (m >> LO) & tbits;
  }
  __device__ __forceinline__ int gpart(int m) const {
    return (m >> bp) & ~(1 << h);
  }
  // register bit of an in-tile bit, or -1 for a thread bit
  __device__ __forceinline__ int regbit(int t) const {
    return t < LO ? t : (t >= hs ? LO + t - hs : -1);
  }
};

template <typename T, int RIN>
__device__ Desc<typename Amp<T>::C> decode(const int* __restrict__ row,
                                           const T* __restrict__ fv,
                                           const int* __restrict__ iv,
                                           const PairLayout<RIN>& L) {
  using C = typename Amp<T>::C;
  Desc<C> d;
  const int kind = row[0], t = row[1], has_ctrl = row[2];
  const T* f = fv + row[3];
  const int cm = has_ctrl ? iv[row[4]] : 0;
  const int cv = has_ctrl ? iv[row[4] + 1] : 0;
  d.idx = 0;
  d.tt = 0;
  d.ub = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) d.f[k] = C(0);
  if (kind == K_CPHASE) {
    const int comb = cm | (1 << t);
    const int g = L.gpart(comb);
    d.type = (L.tile & g) == g ? D_CPHASE : D_SKIP;
    d.rm = d.rv = L.rpart(comb);
    d.tm = d.tv = L.tpart(comb);
    d.f[0] = Amp<T>::load(f[0]);
    d.f[1] = Amp<T>::load(f[1]);
    return d;
  }
  d.rm = L.rpart(cm);
  d.rv = L.rpart(cv);
  d.tm = L.tpart(cm);
  d.tv = L.tpart(cv);
  const bool on = (L.tile & L.gpart(cm)) == L.gpart(cv);
  if (kind == K_DIAG) {
    d.type = on ? D_DIAG : D_SKIP;
#pragma unroll
    for (int k = 0; k < 4; ++k) d.f[k] = Amp<T>::load(f[k]);
    d.idx = -1;  // not a register bit: diag_op takes its default
    if (t < L.bp) {
      const int r = L.regbit(t);
      if (r >= 0) d.idx = r;
      else d.tt = 1 << (t - L.LO);
    } else if (t == L.bp + L.h) {
      d.idx = RIN;
    } else {
      d.ub = (L.tile >> (t - L.bp)) & 1;
    }
    return d;
  }
  if (kind == K_GEN) {
#pragma unroll
    for (int k = 0; k < 8; ++k) d.f[k] = Amp<T>::load(f[k]);
  } else {  // inv [tr.re, tr.im, bl.re, bl.im] as a 2x2
    d.f[1] = Amp<T>::load(f[0]);
    d.f[5] = Amp<T>::load(f[1]);
    d.f[2] = Amp<T>::load(f[2]);
    d.f[6] = Amp<T>::load(f[3]);
  }
  if (t >= L.bp) {  // the leading cross-tile op: the pair bit
    d.type = D_REG;
    d.idx = RIN;
  } else if (L.regbit(t) >= 0) {
    d.type = D_REG;
    d.idx = L.regbit(t);
  } else {
    d.idx = t - L.LO;
    d.type = d.idx < LANE_BITS ? D_LANE : D_SMEM;
  }
  if (!on) d.type = D_SKIP;
  return d;
}

// (a, b) *= (fr, fi).  Both products of b are taken first, so each result
// can go straight to its own register: no temporary and no move.
template <typename C>
__device__ __forceinline__ void cmul(C& a, C& b, C fr, C fi) {
  const C yi = b * fi, yr = b * fr;
  b = a * fi + yr;
  a = a * fr - yi;
}

// cphase: multiply the registers whose index holds every bit of RM
template <typename C, int NR, int RM>
__device__ __forceinline__ void cmul_subset(C (&re)[NR], C (&im)[NR], C fr,
                                            C fi) {
#pragma unroll
  for (int k = 0; k < NR; ++k)
    if ((k & RM) == RM) cmul(re[k], im[k], fr, fi);
}

#define QTT_CPHASE_CASE(R) \
  case R:                  \
    if constexpr (R < NR) cmul_subset<C, NR, R>(re, im, fr, fi); \
    break;

template <typename C, int NR>
__device__ __forceinline__ void cphase_regs(int rm, C (&re)[NR], C (&im)[NR],
                                            C fr, C fi) {
  switch (rm) {
    QTT_CPHASE_CASE(0) QTT_CPHASE_CASE(1) QTT_CPHASE_CASE(2)
    QTT_CPHASE_CASE(3) QTT_CPHASE_CASE(4) QTT_CPHASE_CASE(5)
    QTT_CPHASE_CASE(6) QTT_CPHASE_CASE(7) QTT_CPHASE_CASE(8)
    QTT_CPHASE_CASE(9) QTT_CPHASE_CASE(10) QTT_CPHASE_CASE(11)
    QTT_CPHASE_CASE(12) QTT_CPHASE_CASE(13) QTT_CPHASE_CASE(14)
    QTT_CPHASE_CASE(15) QTT_CPHASE_CASE(16) QTT_CPHASE_CASE(17)
    QTT_CPHASE_CASE(18) QTT_CPHASE_CASE(19) QTT_CPHASE_CASE(20)
    QTT_CPHASE_CASE(21) QTT_CPHASE_CASE(22) QTT_CPHASE_CASE(23)
    QTT_CPHASE_CASE(24) QTT_CPHASE_CASE(25) QTT_CPHASE_CASE(26)
    QTT_CPHASE_CASE(27) QTT_CPHASE_CASE(28) QTT_CPHASE_CASE(29)
    QTT_CPHASE_CASE(30) QTT_CPHASE_CASE(31)
    default: break;
  }
}

// diag: d0 where the target bit is 0, d1 where it is 1, on the
// registers that pass the control test.  IDX is the target's register
// bit, or -1 when the target bit is the same for all of a thread's
// registers (tbit).
template <typename C, int NR, int IDX>
__device__ __forceinline__ void diag_regs(int rm, int rv, C (&re)[NR],
                                          C (&im)[NR], const C* d, bool tbit) {
  const C ur = tbit ? d[2] : d[0], ui = tbit ? d[3] : d[1];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    if ((k & rm) != rv) continue;
    if constexpr (IDX < 0) {
      cmul(re[k], im[k], ur, ui);
    } else if ((k >> IDX) & 1) {
      cmul(re[k], im[k], d[2], d[3]);
    } else {
      cmul(re[k], im[k], d[0], d[1]);
    }
  }
}

// 2x2 on register pairs (k, k | 1 << IDX) that pass the control test
template <typename C, int NR, int IDX>
__device__ __forceinline__ void mix_regs(int rm, int rv, C (&re)[NR],
                                         C (&im)[NR], const C* m) {
#pragma unroll
  for (int k0 = 0; k0 < NR; ++k0) {
    if (k0 & (1 << IDX)) continue;
    if ((k0 & rm) != rv) continue;
    const int k1 = k0 | (1 << IDX);
    const C a0r = re[k0], a0i = im[k0], a1r = re[k1], a1i = im[k1];
    re[k0] = m[0] * a0r - m[4] * a0i + m[1] * a1r - m[5] * a1i;
    im[k0] = m[0] * a0i + m[4] * a0r + m[1] * a1i + m[5] * a1r;
    re[k1] = m[2] * a0r - m[6] * a0i + m[3] * a1r - m[7] * a1i;
    im[k1] = m[2] * a0i + m[6] * a0r + m[3] * a1i + m[7] * a1r;
  }
}

#define QTT_BIT_CASE(I, CALL) \
  case I:                     \
    if constexpr (I <= RIN) CALL; \
    break;

template <typename C, int RIN>
__device__ __forceinline__ void diag_op(const Desc<C>& d, bool tbit,
                                        C (&re)[2 << RIN], C (&im)[2 << RIN]) {
  constexpr int NR = 2 << RIN;
  switch (d.idx) {
    QTT_BIT_CASE(0, (diag_regs<C, NR, 0>(d.rm, d.rv, re, im, d.f, tbit)))
    QTT_BIT_CASE(1, (diag_regs<C, NR, 1>(d.rm, d.rv, re, im, d.f, tbit)))
    QTT_BIT_CASE(2, (diag_regs<C, NR, 2>(d.rm, d.rv, re, im, d.f, tbit)))
    QTT_BIT_CASE(3, (diag_regs<C, NR, 3>(d.rm, d.rv, re, im, d.f, tbit)))
    QTT_BIT_CASE(4, (diag_regs<C, NR, 4>(d.rm, d.rv, re, im, d.f, tbit)))
    default:
      diag_regs<C, NR, -1>(d.rm, d.rv, re, im, d.f, tbit);
  }
}

template <typename C, int RIN>
__device__ __forceinline__ void reg_op(const Desc<C>& d, C (&re)[2 << RIN],
                                       C (&im)[2 << RIN]) {
  constexpr int NR = 2 << RIN;
  switch (d.idx) {
    QTT_BIT_CASE(0, (mix_regs<C, NR, 0>(d.rm, d.rv, re, im, d.f)))
    QTT_BIT_CASE(1, (mix_regs<C, NR, 1>(d.rm, d.rv, re, im, d.f)))
    QTT_BIT_CASE(2, (mix_regs<C, NR, 2>(d.rm, d.rv, re, im, d.f)))
    QTT_BIT_CASE(3, (mix_regs<C, NR, 3>(d.rm, d.rv, re, im, d.f)))
    QTT_BIT_CASE(4, (mix_regs<C, NR, 4>(d.rm, d.rv, re, im, d.f)))
    default: break;
  }
}

// A thread whose bit d.idx is s holds row s of the pair: its own
// amplitude weighs m[s][s], the partner thread's m[s][1 - s].
template <typename C>
__device__ __forceinline__ void own_row(const Desc<C>& d, int tid, C& cor,
                                        C& coi, C& cpr, C& cpi) {
  const bool s = (tid >> d.idx) & 1;
  cor = s ? d.f[3] : d.f[0];
  coi = s ? d.f[7] : d.f[4];
  cpr = s ? d.f[2] : d.f[1];
  cpi = s ? d.f[6] : d.f[5];
}

template <typename C>
__device__ __forceinline__ void mix_own(C& ar, C& ai, C pr, C pi, C cor,
                                        C coi, C cpr, C cpi) {
  const C xr = ar, xi = ai;
  ar = cor * xr - coi * xi + cpr * pr - cpi * pi;
  ai = cor * xi + coi * xr + cpr * pi + cpi * pr;
}

// 2x2 on a lane bit: the partner is lane ^ (1 << idx) of the same warp
template <typename C, int NR>
__device__ __forceinline__ void lane_op(const Desc<C>& d, bool ok, int tid,
                                        unsigned warp_mask, C (&re)[NR],
                                        C (&im)[NR]) {
  C cor, coi, cpr, cpi;
  own_row(d, tid, cor, coi, cpr, cpi);
  const int lane_bit = 1 << d.idx;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    if ((k & d.rm) != d.rv) continue;  // the same for every thread
    const C pr = __shfl_xor_sync(warp_mask, re[k], lane_bit);
    const C pi = __shfl_xor_sync(warp_mask, im[k], lane_bit);
    if (ok) mix_own(re[k], im[k], pr, pi, cor, coi, cpr, cpi);
  }
}

// Global or shared offset of a thread's register group g (four
// consecutive registers when LO = 2) within one tile plane.
template <int RIN>
__device__ __forceinline__ int group_offset(const PairLayout<RIN>& L, int tid,
                                            int khi) {
  return (khi << L.hs) | (tid << L.LO);
}

// A thread's registers <-> a pair laid out as [tile][plane][2^bp], in
// groups of 2^LO consecutive values (one vector access a plane when
// LO = 2).  P is the storage type there (the planes' type in device
// memory, C in shared memory); a store to 16-bit planes rounds.
template <int RIN, bool LOAD, typename P, typename C>
__device__ __forceinline__ void move_pair(const PairLayout<RIN>& L, int tid,
                                          P* t0, P* t1, long long plane,
                                          C (&re)[2 << RIN],
                                          C (&im)[2 << RIN]) {
  constexpr int LO = PairLayout<RIN>::LO, HI = PairLayout<RIN>::HI;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int khi = 0; khi < (1 << HI); ++khi) {
      P* r = (p ? t1 : t0) + group_offset(L, tid, khi);
      P* i = r + plane;
      const int k = (p << RIN) | (khi << LO);
      if constexpr (LO == 2) {
        if constexpr (LOAD) {
          const Quad<C> a = Amp<P>::load4(r);
          const Quad<C> b = Amp<P>::load4(i);
          re[k] = a.x; re[k + 1] = a.y; re[k + 2] = a.z; re[k + 3] = a.w;
          im[k] = b.x; im[k + 1] = b.y; im[k + 2] = b.z; im[k + 3] = b.w;
        } else {
          Amp<P>::store4(r, Quad<C>{re[k], re[k + 1], re[k + 2], re[k + 3]});
          Amp<P>::store4(i, Quad<C>{im[k], im[k + 1], im[k + 2], im[k + 3]});
        }
      } else {
#pragma unroll
        for (int e = 0; e < (1 << LO); ++e) {
          if constexpr (LOAD) {
            re[k + e] = Amp<P>::load(r[e]);
            im[k + e] = Amp<P>::load(i[e]);
          } else {
            r[e] = Amp<P>::store(re[k + e]);
            i[e] = Amp<P>::store(im[k + e]);
          }
        }
      }
    }
  }
}

// 2x2 on a warp bit: one round through shared memory (the pair at its
// in-tile positions, [tile][plane][2^bp], in C), two barriers.  The
// partner's values are read group by group, so they need few registers.
template <typename C, int RIN>
__device__ __forceinline__ void smem_op(const Desc<C>& d, bool ok, int tid,
                                        const PairLayout<RIN>& L, C* xbuf,
                                        C (&re)[2 << RIN], C (&im)[2 << RIN]) {
  constexpr int LO = PairLayout<RIN>::LO, HI = PairLayout<RIN>::HI;
  const int block = 1 << L.bp;
  C* x0 = xbuf;              // tile i: re, then im
  C* x1 = xbuf + 2 * block;  // tile j
  move_pair<RIN, false>(L, tid, x0, x1, block, re, im);
  __syncthreads();
  C cor, coi, cpr, cpi;
  own_row(d, tid, cor, coi, cpr, cpi);
  const int partner = tid ^ (1 << d.idx);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int khi = 0; khi < (1 << HI); ++khi) {
      const C* r = (p ? x1 : x0) + group_offset(L, partner, khi);
      const int k = (p << RIN) | (khi << LO);
#pragma unroll
      for (int e = 0; e < (1 << LO); ++e)
        if (ok && ((k + e) & d.rm) == d.rv)
          mix_own(re[k + e], im[k + e], r[e], r[e + block], cor, coi, cpr,
                  cpi);
    }
  }
  __syncthreads();
}

template <typename T, int RIN>
__global__ void __launch_bounds__(PAIR_THREADS)
window_pair(T* __restrict__ planes, int n, int bp,
            const int* __restrict__ table, int xop, int first, int count,
            const T* __restrict__ fv, const int* __restrict__ iv) {
  using C = typename Amp<T>::C;
  constexpr int NR = 2 << RIN;
  extern __shared__ float4 smem4[];
  Desc<C>* descs = reinterpret_cast<Desc<C>*>(smem4);
  C* xbuf = reinterpret_cast<C*>(descs + CHUNK);

  PairLayout<RIN> L;
  L.bp = bp;
  L.h = table[xop * ROW + 1] - bp;
  L.hs = bp - PairLayout<RIN>::HI;
  L.tbits = (1 << (bp - RIN)) - 1;
  const int q = blockIdx.x;
  L.tile = ((q >> L.h) << (L.h + 1)) | (q & ((1 << L.h) - 1));
  const int tid = threadIdx.x;
  const unsigned warp_mask =
      blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;

  C re[NR], im[NR];
  const long long amps = 1LL << n;
  T* t0 = planes + ((long long)L.tile << bp);
  T* t1 = planes + ((long long)(L.tile | (1 << L.h)) << bp);
  move_pair<RIN, true>(L, tid, t0, t1, amps, re, im);

  // the leading cross-tile op: every thread holds both rows
  {
    const Desc<C> x = decode<T, RIN>(table + xop * ROW, fv, iv, L);
    if (x.type != D_SKIP && (tid & x.tm) == x.tv)
      mix_regs<C, NR, RIN>(x.rm, x.rv, re, im, x.f);
  }

  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int cn = min(CHUNK, count - c0);
    if (c0) __syncthreads();  // every thread is done with the last chunk
    for (int o = tid; o < cn; o += blockDim.x)
      descs[o] = decode<T, RIN>(table + (first + c0 + o) * ROW, fv, iv, L);
    __syncthreads();
    for (int o = 0; o < cn; ++o) {
      const Desc<C> d = descs[o];
      const bool ok = (tid & d.tm) == d.tv;
      switch (d.type) {
        case D_CPHASE:
          if (ok) cphase_regs<C, NR>(d.rm, re, im, d.f[0], d.f[1]);
          break;
        case D_DIAG:
          if (ok) diag_op<C, RIN>(d, ((tid & d.tt) != 0) || d.ub, re, im);
          break;
        case D_REG:
          if (ok) reg_op<C, RIN>(d, re, im);
          break;
        case D_LANE:
          lane_op<C, NR>(d, ok, tid, warp_mask, re, im);
          break;
        case D_SMEM:
          smem_op<C, RIN>(d, ok, tid, L, xbuf, re, im);
          break;
        default:
          break;
      }
    }
  }

  move_pair<RIN, false>(L, tid, t0, t1, amps, re, im);
}

template <typename T, int RIN>
int launch_pair(void* planes, int n, int bp, const int* table, int xop,
                int first, int count, const void* fv, const int* iv,
                cudaStream_t stream) {
  using C = typename Amp<T>::C;
  // CHUNK descriptors, then the pair (2 tiles x 2 planes x 2^bp values)
  const size_t smem = CHUNK * sizeof(Desc<C>) + (sizeof(C) << (bp + 2));
  cudaError_t err = cudaFuncSetAttribute(
      window_pair<T, RIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = 1u << (n - bp - 1);
  const unsigned threads = 1u << (bp - RIN);
  window_pair<T, RIN><<<grid, threads, smem, stream>>>(
      static_cast<T*>(planes), n, bp, table, xop, first, count,
      static_cast<const T*>(fv), iv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pair_for(void* planes, int n, int bp, const int* table, int xop,
                    int first, int count, const void* fv, const int* iv,
                    cudaStream_t st) {
  constexpr int R = Amp<T>::PAIR_REG_BITS;
  switch (bp < R ? bp : R) {
    case 1:
      return launch_pair<T, 1>(planes, n, bp, table, xop, first, count, fv,
                               iv, st);
    case 2:
      return launch_pair<T, 2>(planes, n, bp, table, xop, first, count, fv,
                               iv, st);
    case 3:
      return launch_pair<T, 3>(planes, n, bp, table, xop, first, count, fv,
                               iv, st);
    default:
      if constexpr (R >= 4)
        return launch_pair<T, 4>(planes, n, bp, table, xop, first, count, fv,
                                 iv, st);
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_in_tile(void* planes, int n, int bp, const int* table, int first,
                   int count, const void* fv, const int* iv,
                   cudaStream_t stream) {
  using C = typename Amp<T>::C;
  const size_t smem = 2 * sizeof(C) * (size_t(1) << bp);
  cudaError_t err = cudaFuncSetAttribute(
      window_in_tile<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = 1u << (n - bp);
  window_in_tile<T><<<grid, THREADS, smem, stream>>>(
      static_cast<T*>(planes), n, bp, table, first, count,
      static_cast<const T*>(fv), iv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, allocate nothing, and return
// cudaGetLastError() (0 on success).  `dtype` is the planes' and fv's
// type (DT_*).  The caller checks shapes and dtypes
// (ops/window_kernel.py).

int qtt_window_in_tile(void* planes, int dtype, int n, int bp,
                       const int* table, int first, int count, const void* fv,
                       const int* iv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch_in_tile<float>(planes, n, bp, table, first, count, fv,
                                   iv, st);
    case DT_F64:
      return launch_in_tile<double>(planes, n, bp, table, first, count, fv,
                                    iv, st);
    case DT_F16:
      return launch_in_tile<__half>(planes, n, bp, table, first, count, fv,
                                    iv, st);
    case DT_BF16:
      return launch_in_tile<__nv_bfloat16>(planes, n, bp, table, first, count,
                                           fv, iv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int qtt_window_pair(void* planes, int dtype, int n, int bp, const int* table,
                    int xop, int first, int count, const void* fv,
                    const int* iv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch_pair_for<float>(planes, n, bp, table, xop, first, count,
                                    fv, iv, st);
    case DT_F64:
      return launch_pair_for<double>(planes, n, bp, table, xop, first, count,
                                     fv, iv, st);
    case DT_F16:
      return launch_pair_for<__half>(planes, n, bp, table, xop, first, count,
                                     fv, iv, st);
    case DT_BF16:
      return launch_pair_for<__nv_bfloat16>(planes, n, bp, table, xop, first,
                                            count, fv, iv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
