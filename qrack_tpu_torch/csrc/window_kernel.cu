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
// Both sweeps run on one register engine, window_tiles<T, RB, PAIR>: K1
// with PAIR = false on one tile, K2 with PAIR = true on a tile pair.
//
// K1, the in-tile sweep (pallas_kernels.py:294): one block per tile, the
// tile in registers.  A design that keeps the tile in shared memory and
// passes over it once per op with a barrier after each (K1's first
// design) moves one element per load and instruction and keeps few
// bytes in flight a thread: on an H100 SXM at 700 W it read 27.5% of
// its byte bound at 16 bits, 50% in float32 and 69% in float64, the
// share following the width of an access, whatever the op count.  So
// the tile moves by vector accesses, all of a thread's loads issued
// before its first op, as K2's pair does; it then reads about 86% of
// its byte bound in float32 and float64 on the same card, and about 70%
// at 16 bits, whose byte time is half (PERF.md times a launch with its
// ops and without them).
//
// K2, the pair sweep (pallas_kernels.py:315): one block per tile PAIR i,
// j = i | (1 << h), h = target - bp of the segment's leading inv/gen.  One
// block owns both tiles, since the sweep writes in place.  What bounds
// it: the bytes above for short segments; for long ones (RunFused of a
// QFT puts about 294 ops in its last segment) the instructions the CUDA
// cores issue per op.  A pass over the pair in shared memory per op would
// be bound instead by shared-memory bandwidth (2^13 amplitudes * 16 B per
// pair and op), far above both.
//
// The engine:
//  * Layout (tile_layout in ops/window_kernel.py mirrors it).  A thread
//    holds NR = 2^NB amplitudes a plane: RB = min(R, bp) in-tile
//    "register bits", the two lowest in-tile bits and the RB - 2 highest,
//    and for K2 the pair bit (NB = RB + 1).  R is 5 for K1 in float
//    planes and 4 in double and 16-bit planes, and for K2 4 in float and
//    16-bit planes and 3 in double (a double takes two registers: 32
//    floats or 16 doubles a plane keep the data at 64 registers; 16-bit
//    K1 read best with 4 bits, float32 with 5, on an H100: PERF.md).  The other in-tile bits index the thread: its low five
//    are the lane, the rest the warp.  Neighbouring threads hold
//    neighbouring groups of four amplitudes, so every load and store is
//    one vector access a thread per group and plane (16 B for float, two
//    of 16 B for double, 8 B for 16-bit planes), coalesced.  At bp = 12 a
//    K1 block is 128 threads of 32 amplitudes (256 of 16 for double and
//    16-bit planes), a K2 block 256 threads of 32 (512 of 16 for
//    double).
//  * Decode.  Each op's masks are split once per block into a tile part
//    (m >> bp, tested against the block's tile, and for K2 without the
//    pair bit; a failing op is skipped by the whole block, and its tile
//    keeps its values exactly), a thread part and a register part, and
//    written with its route and payload to a descriptor in shared
//    memory, CHUNK ops at a time.  So an op costs each thread a few
//    shared-memory broadcasts and a test, not a test per element.
//  * Diagonal ops (cphase, diag; any target, any controls) run in
//    registers with no barrier: the register part picks the registers a
//    cphase touches through a switch over compile-time subsets, so a
//    cphase costs about its touched amplitudes.
//  * inv/gen.  K2's leading cross-tile op and in-tile targets on a
//    register bit mix registers; a lane-bit target exchanges with
//    __shfl_xor_sync; a warp-bit target takes one round through a
//    shared-memory exchange buffer the size of the block's tiles (store,
//    barrier, load the partner thread's values, barrier).  Only that
//    route pays barriers.
//  * Occupancy: at most 128 registers a thread (launch bounds 512).
//    Shared memory at bp = 12: K1 about 36 KB for float and 16-bit planes
//    and 70 KB for double; K2 about 68 KB and 134 KB.  A double pair at
//    bp = 13 would need 262 KB, past the 227 KB a block may take, so
//    double planes take bp <= 12 (window_kernel.MAX_BLOCK_POW).

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

namespace {

enum { K_CPHASE = 0, K_DIAG = 1, K_INV = 2, K_GEN = 3 };
constexpr int ROW = 5;        // op-table columns

// dtype codes of the C entry points (window_kernel.DTYPE_CODE)
enum { DT_F32 = 0, DT_F64 = 1, DT_F16 = 2, DT_BF16 = 3 };

template <typename C>
struct Quad {
  C x, y, z, w;
};

// Amplitude storage type T: its compute type C, the register bits of a
// thread (R of the header note, for K1 and K2; window_kernel.reg_bits
// mirrors them), one-value conversions, and the four-value vector
// accesses of a thread's groups.
template <typename T>
struct Amp;

template <>
struct Amp<float> {
  using C = float;
  static constexpr int TILE_REG_BITS = 5;
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
  static constexpr int TILE_REG_BITS = 4;
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
  static constexpr int TILE_REG_BITS = 4;
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
  static constexpr int TILE_REG_BITS = 4;
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

// ---------------------------------------------------------------------------
// the register engine of K1 and K2
// ---------------------------------------------------------------------------

constexpr int LANE_BITS = 5;
constexpr int MAX_THREADS = 512;  // the most a block has (K2 at bp = 13)
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

// Where a block keeps the in-tile bits of its tile (PAIR = false, K1) or
// tile pair (PAIR = true, K2): RB in-tile register bits, then the pair
// bit for K2.
template <int RB, bool PAIR>
struct TileLayout {
  static constexpr int LO = RB < 2 ? RB : 2;  // low in-tile register bits
  static constexpr int HI = RB - LO;          // high in-tile register bits
  static constexpr int NB = RB + (PAIR ? 1 : 0);  // register index bits
  static constexpr int NR = 1 << NB;          // amplitudes a thread, a plane
  static constexpr int TILES = PAIR ? 2 : 1;
  static constexpr bool IS_PAIR = PAIR;
  // the register switches (cphase_regs, diag_op, reg_op) cover register
  // masks 0-31 and register bits 0-4
  static_assert(NB >= 1 && NB <= 5, "register index bits outside 1-5");
  int bp, h, hs, tbits, tile;  // hs = bp - HI; K2: tile i (bit h clear)

  // register part: bits 0..LO-1, then bits hs..bp-1, then the pair bit
  __device__ __forceinline__ int rpart(int m) const {
    int r = (m & ((1 << LO) - 1)) | (((m >> hs) & ((1 << HI) - 1)) << LO);
    if constexpr (PAIR) r |= ((m >> (bp + h)) & 1) << RB;
    return r;
  }
  __device__ __forceinline__ int tpart(int m) const {
    return (m >> LO) & tbits;
  }
  // tile part, tested against the block's tile id
  __device__ __forceinline__ int gpart(int m) const {
    if constexpr (PAIR) return (m >> bp) & ~(1 << h);
    return m >> bp;
  }
  // register bit of an in-tile bit, or -1 for a thread bit
  __device__ __forceinline__ int regbit(int t) const {
    return t < LO ? t : (t >= hs ? LO + t - hs : -1);
  }
};

template <typename T, typename Lay>
__device__ Desc<typename Amp<T>::C> decode(const int* __restrict__ row,
                                           const T* __restrict__ fv,
                                           const int* __restrict__ iv,
                                           const Lay& L) {
  using C = typename Amp<T>::C;
  constexpr int RB = Lay::LO + Lay::HI;
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
      else d.tt = 1 << (t - Lay::LO);
    } else if (Lay::IS_PAIR && t == L.bp + L.h) {
      d.idx = RB;
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
  if (t >= L.bp) {
    // K2's leading cross-tile op: the pair bit.  An in-tile segment never
    // holds one (the planner leads a pair sweep with it).
    d.type = Lay::IS_PAIR ? D_REG : D_SKIP;
    d.idx = RB;
  } else if (L.regbit(t) >= 0) {
    d.type = D_REG;
    d.idx = L.regbit(t);
  } else {
    d.idx = t - Lay::LO;
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

// NR <= 32 (TileLayout's static_assert), so rm < 32 and a case covers it
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

// register bits 0-4 (NB <= 5, TileLayout's static_assert)
#define QTT_BIT_CASE(I, CALL) \
  case I:                     \
    if constexpr (I < NB) CALL; \
    break;

template <typename C, int NB>
__device__ __forceinline__ void diag_op(const Desc<C>& d, bool tbit,
                                        C (&re)[1 << NB], C (&im)[1 << NB]) {
  constexpr int NR = 1 << NB;
  switch (d.idx) {
    QTT_BIT_CASE(0, (diag_regs<C, NR, 0>(d.rm, d.rv, re, im, d.f, tbit)))
    QTT_BIT_CASE(1, (diag_regs<C, NR, 1>(d.rm, d.rv, re, im, d.f, tbit)))
    QTT_BIT_CASE(2, (diag_regs<C, NR, 2>(d.rm, d.rv, re, im, d.f, tbit)))
    QTT_BIT_CASE(3, (diag_regs<C, NR, 3>(d.rm, d.rv, re, im, d.f, tbit)))
    QTT_BIT_CASE(4, (diag_regs<C, NR, 4>(d.rm, d.rv, re, im, d.f, tbit)))
    default:  // idx -1: the target is a thread or tile bit
      diag_regs<C, NR, -1>(d.rm, d.rv, re, im, d.f, tbit);
  }
}

template <typename C, int NB>
__device__ __forceinline__ void reg_op(const Desc<C>& d, C (&re)[1 << NB],
                                       C (&im)[1 << NB]) {
  constexpr int NR = 1 << NB;
  switch (d.idx) {
    QTT_BIT_CASE(0, (mix_regs<C, NR, 0>(d.rm, d.rv, re, im, d.f)))
    QTT_BIT_CASE(1, (mix_regs<C, NR, 1>(d.rm, d.rv, re, im, d.f)))
    QTT_BIT_CASE(2, (mix_regs<C, NR, 2>(d.rm, d.rv, re, im, d.f)))
    QTT_BIT_CASE(3, (mix_regs<C, NR, 3>(d.rm, d.rv, re, im, d.f)))
    QTT_BIT_CASE(4, (mix_regs<C, NR, 4>(d.rm, d.rv, re, im, d.f)))
    default: break;  // decode gives a D_REG op a register bit < NB
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
template <typename Lay>
__device__ __forceinline__ int group_offset(const Lay& L, int tid, int khi) {
  return (khi << L.hs) | (tid << Lay::LO);
}

// A thread's registers <-> the block's tiles laid out as
// [tile][plane][2^bp] (t1 is read only for a pair), in groups of 2^LO
// consecutive values (one vector access a plane when LO = 2).  P is the
// storage type there (the planes' type in device memory, C in shared
// memory); a store to 16-bit planes rounds.
template <bool LOAD, typename Lay, typename P, typename C, int NR>
__device__ __forceinline__ void move_tiles(const Lay& L, int tid, P* t0,
                                           P* t1, long long plane,
                                           C (&re)[NR], C (&im)[NR]) {
  static_assert(NR == Lay::NR, "a thread holds Lay::NR values a plane");
  constexpr int LO = Lay::LO, HI = Lay::HI, RB = LO + HI;
#pragma unroll
  for (int p = 0; p < Lay::TILES; ++p) {
#pragma unroll
    for (int khi = 0; khi < (1 << HI); ++khi) {
      P* r = (p ? t1 : t0) + group_offset(L, tid, khi);
      P* i = r + plane;
      const int k = (p << RB) | (khi << LO);
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

// 2x2 on a warp bit: one round through shared memory (the block's tiles
// at their in-tile positions, [tile][plane][2^bp], in C), two barriers.
// The partner's values are read group by group, so they need few
// registers.
template <typename C, typename Lay, int NR>
__device__ __forceinline__ void smem_op(const Desc<C>& d, bool ok, int tid,
                                        const Lay& L, C* xbuf, C (&re)[NR],
                                        C (&im)[NR]) {
  constexpr int LO = Lay::LO, HI = Lay::HI, RB = LO + HI;
  const int block = 1 << L.bp;
  C* x0 = xbuf;              // the tile (K2: tile i): re, then im
  C* x1 = xbuf + 2 * block;  // K2: tile j
  move_tiles<false>(L, tid, x0, x1, block, re, im);
  __syncthreads();
  C cor, coi, cpr, cpi;
  own_row(d, tid, cor, coi, cpr, cpi);
  const int partner = tid ^ (1 << d.idx);
#pragma unroll
  for (int p = 0; p < Lay::TILES; ++p) {
#pragma unroll
    for (int khi = 0; khi < (1 << HI); ++khi) {
      const C* r = (p ? x1 : x0) + group_offset(L, partner, khi);
      const int k = (p << RB) | (khi << LO);
#pragma unroll
      for (int e = 0; e < (1 << LO); ++e)
        if (ok && ((k + e) & d.rm) == d.rv)
          mix_own(re[k + e], im[k + e], r[e], r[e + block], cor, coi, cpr,
                  cpi);
    }
  }
  __syncthreads();
}

// K1 (PAIR = false): rows [first, first + count) on tile blockIdx.x.
// K2 (PAIR = true): the cross-tile op at row xop on tile pair blockIdx.x,
// then rows [first, first + count) on both tiles.
template <typename T, int RB, bool PAIR>
__global__ void __launch_bounds__(MAX_THREADS)
window_tiles(T* __restrict__ planes, int n, int bp,
             const int* __restrict__ table, int xop, int first, int count,
             const T* __restrict__ fv, const int* __restrict__ iv) {
  using C = typename Amp<T>::C;
  using Lay = TileLayout<RB, PAIR>;
  constexpr int NR = Lay::NR;
  extern __shared__ float4 smem4[];
  Desc<C>* descs = reinterpret_cast<Desc<C>*>(smem4);
  C* xbuf = reinterpret_cast<C*>(descs + CHUNK);

  Lay L;
  L.bp = bp;
  L.hs = bp - Lay::HI;
  L.tbits = (1 << (bp - RB)) - 1;
  if constexpr (PAIR) {
    L.h = table[xop * ROW + 1] - bp;
    const int q = blockIdx.x;
    L.tile = ((q >> L.h) << (L.h + 1)) | (q & ((1 << L.h) - 1));
  } else {
    L.h = 0;
    L.tile = blockIdx.x;
  }
  const int tid = threadIdx.x;
  const unsigned warp_mask =
      blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;

  C re[NR], im[NR];
  const long long amps = 1LL << n;
  T* t0 = planes + ((long long)L.tile << bp);
  T* t1 = t0;
  if constexpr (PAIR) t1 = planes + ((long long)(L.tile | (1 << L.h)) << bp);
  move_tiles<true>(L, tid, t0, t1, amps, re, im);

  if constexpr (PAIR) {
    // the leading cross-tile op: every thread holds both rows
    const Desc<C> x = decode<T>(table + xop * ROW, fv, iv, L);
    if (x.type != D_SKIP && (tid & x.tm) == x.tv)
      mix_regs<C, NR, RB>(x.rm, x.rv, re, im, x.f);
  }

  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int cn = min(CHUNK, count - c0);
    if (c0) __syncthreads();  // every thread is done with the last chunk
    for (int o = tid; o < cn; o += blockDim.x)
      descs[o] = decode<T>(table + (first + c0 + o) * ROW, fv, iv, L);
    __syncthreads();
    for (int o = 0; o < cn; ++o) {
      const Desc<C> d = descs[o];
      const bool ok = (tid & d.tm) == d.tv;
      switch (d.type) {
        case D_CPHASE:
          if (ok) cphase_regs<C, NR>(d.rm, re, im, d.f[0], d.f[1]);
          break;
        case D_DIAG:
          if (ok) diag_op<C, Lay::NB>(d, ((tid & d.tt) != 0) || d.ub, re, im);
          break;
        case D_REG:
          if (ok) reg_op<C, Lay::NB>(d, re, im);
          break;
        case D_LANE:
          lane_op<C, NR>(d, ok, tid, warp_mask, re, im);
          break;
        case D_SMEM:
          smem_op<C>(d, ok, tid, L, xbuf, re, im);
          break;
        default:
          break;
      }
    }
  }

  move_tiles<false>(L, tid, t0, t1, amps, re, im);
}

template <typename T, int RB, bool PAIR>
int launch_tiles(void* planes, int n, int bp, const int* table, int xop,
                 int first, int count, const void* fv, const int* iv,
                 cudaStream_t stream) {
  using C = typename Amp<T>::C;
  // CHUNK descriptors, then the exchange buffer: the block's tiles, both
  // planes, 2^bp values each
  const size_t smem = CHUNK * sizeof(Desc<C>) +
                      (sizeof(C) << (bp + 1 + (PAIR ? 1 : 0)));
  cudaError_t err = cudaFuncSetAttribute(
      window_tiles<T, RB, PAIR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = 1u << (n - bp - (PAIR ? 1 : 0));
  const unsigned threads = 1u << (bp - RB);
  window_tiles<T, RB, PAIR><<<grid, threads, smem, stream>>>(
      static_cast<T*>(planes), n, bp, table, xop, first, count,
      static_cast<const T*>(fv), iv);
  return (int)cudaGetLastError();
}

// The instance with RB = rb register bits, rb in 1..RB
template <typename T, bool PAIR, int RB>
int launch_rb(int rb, void* planes, int n, int bp, const int* table, int xop,
              int first, int count, const void* fv, const int* iv,
              cudaStream_t st) {
  if (rb == RB)
    return launch_tiles<T, RB, PAIR>(planes, n, bp, table, xop, first, count,
                                     fv, iv, st);
  if constexpr (RB > 1)
    return launch_rb<T, PAIR, RB - 1>(rb, planes, n, bp, table, xop, first,
                                      count, fv, iv, st);
  return (int)cudaErrorInvalidValue;
}

// RB = min(R, bp): a tile narrower than R bits lives in registers whole
template <typename T, bool PAIR>
int launch_for(void* planes, int n, int bp, const int* table, int xop,
               int first, int count, const void* fv, const int* iv,
               cudaStream_t st) {
  constexpr int R = PAIR ? Amp<T>::PAIR_REG_BITS : Amp<T>::TILE_REG_BITS;
  return launch_rb<T, PAIR, R>(bp < R ? bp : R, planes, n, bp, table, xop,
                               first, count, fv, iv, st);
}

template <bool PAIR>
int launch_dtype(void* planes, int dtype, int n, int bp, const int* table,
                 int xop, int first, int count, const void* fv,
                 const int* iv, cudaStream_t st) {
  switch (dtype) {
    case DT_F32:
      return launch_for<float, PAIR>(planes, n, bp, table, xop, first, count,
                                     fv, iv, st);
    case DT_F64:
      return launch_for<double, PAIR>(planes, n, bp, table, xop, first,
                                      count, fv, iv, st);
    case DT_F16:
      return launch_for<__half, PAIR>(planes, n, bp, table, xop, first,
                                      count, fv, iv, st);
    case DT_BF16:
      return launch_for<__nv_bfloat16, PAIR>(planes, n, bp, table, xop,
                                             first, count, fv, iv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  return launch_dtype<false>(planes, dtype, n, bp, table, 0, first, count,
                             fv, iv, (cudaStream_t)stream);
}

int qtt_window_pair(void* planes, int dtype, int n, int bp, const int* table,
                    int xop, int first, int count, const void* fv,
                    const int* iv, void* stream) {
  return launch_dtype<true>(planes, dtype, n, bp, table, xop, first, count,
                            fv, iv, (cudaStream_t)stream);
}

}  // extern "C"
