// Native CHP tableau kernels.
//
// Host code beside the CUDA kernels: the dense amplitude math runs on
// the GPU, the host-side combinatorial hot loops — the CHP
// measurement's rowsum cascade and canonical Gaussian elimination
// (reference: src/qstabilizer.cpp:1999 ForceM; gaussianCached
// include/qstabilizer.hpp:55) — are native C++ here, driven through
// ctypes over the engine's uint8 row matrices (zero copy).
//
// Layout contract (matches qrack_tpu_torch.layers.stabilizer.QStabilizer):
//   x, z: uint8[2n+1][n] row-major; r: uint8[2n+1]
//   rows 0..n-1 destabilizers, n..2n-1 stabilizers, 2n scratch.

#include <cstdint>
#include <cstring>

namespace {

// Aaronson–Gottesman g-exponent summed over a row pair.
inline long g_sum(const uint8_t* x1, const uint8_t* z1,
                  const uint8_t* x2, const uint8_t* z2, long n) {
    long acc = 0;
    for (long j = 0; j < n; ++j) {
        const int a = x1[j], b = z1[j], c = x2[j], d = z2[j];
        if (a && b) {
            acc += d - c;
        } else if (a) {
            acc += d * (2 * c - 1);
        } else if (b) {
            acc += c * (1 - 2 * d);
        }
    }
    return acc;
}

inline void rowsum(uint8_t* x, uint8_t* z, uint8_t* r, long n, long h, long i) {
    uint8_t* xh = x + h * n;
    uint8_t* zh = z + h * n;
    const uint8_t* xi = x + i * n;
    const uint8_t* zi = z + i * n;
    const long phase = 2L * r[h] + 2L * r[i] + g_sum(xi, zi, xh, zh, n);
    r[h] = ((phase % 4 + 4) % 4) == 2 ? 1 : 0;
    for (long j = 0; j < n; ++j) {
        xh[j] ^= xi[j];
        zh[j] ^= zi[j];
    }
}

} // namespace

extern "C" {

// Measure qubit q. Returns 0/1 outcome, -1 = forced outcome impossible.
// rand_bit supplies the random result for the indeterminate branch.
int tb_force_m(uint8_t* x, uint8_t* z, uint8_t* r, long n,
               long q, int forced_val, int do_force, int do_apply,
               int rand_bit) {
    // random case: any stabilizer row with x[p][q]
    long p = -1;
    for (long i = n; i < 2 * n; ++i) {
        if (x[i * n + q]) { p = i; break; }
    }
    if (p < 0) {
        // deterministic: accumulate into scratch row 2n
        const long h = 2 * n;
        std::memset(x + h * n, 0, n);
        std::memset(z + h * n, 0, n);
        r[h] = 0;
        for (long i = 0; i < n; ++i) {
            if (x[i * n + q]) rowsum(x, z, r, n, h, i + n);
        }
        const int out = r[h];
        if (do_force && forced_val != out) return -1;
        return out;
    }
    const int out = do_force ? (forced_val ? 1 : 0) : (rand_bit ? 1 : 0);
    if (!do_apply) return out;
    for (long i = 0; i < 2 * n; ++i) {
        if (i != p && x[i * n + q]) rowsum(x, z, r, n, i, p);
    }
    std::memcpy(x + (p - n) * n, x + p * n, n);
    std::memcpy(z + (p - n) * n, z + p * n, n);
    r[p - n] = r[p];
    std::memset(x + p * n, 0, n);
    std::memset(z + p * n, 0, n);
    z[p * n + q] = 1;
    r[p] = out;
    return out;
}

// 1 if measurement of q is deterministic (Z eigenstate), else 0.
int tb_is_separable_z(const uint8_t* x, long n, long q) {
    for (long i = n; i < 2 * n; ++i) {
        if (x[i * n + q]) return 0;
    }
    return 1;
}

// In-place canonical Gaussian elimination of the stabilizer block
// handed over as standalone (n x n) matrices. Returns the X-rank.
long tb_canonical(uint8_t* x, uint8_t* z, uint8_t* r, long n) {
    auto mul_into = [&](long h, long i) {
        const long phase = 2L * r[h] + 2L * r[i]
            + g_sum(x + i * n, z + i * n, x + h * n, z + h * n, n);
        r[h] = ((phase % 4 + 4) % 4) == 2 ? 1 : 0;
        for (long j = 0; j < n; ++j) {
            x[h * n + j] ^= x[i * n + j];
            z[h * n + j] ^= z[i * n + j];
        }
    };
    auto swap_rows = [&](long a, long b) {
        if (a == b) return;
        for (long j = 0; j < n; ++j) {
            uint8_t t = x[a * n + j]; x[a * n + j] = x[b * n + j]; x[b * n + j] = t;
            t = z[a * n + j]; z[a * n + j] = z[b * n + j]; z[b * n + j] = t;
        }
        const uint8_t t = r[a]; r[a] = r[b]; r[b] = t;
    };
    long row = 0;
    for (long col = 0; col < n; ++col) {
        long piv = -1;
        for (long i = row; i < n; ++i) {
            if (x[i * n + col]) { piv = i; break; }
        }
        if (piv < 0) continue;
        swap_rows(row, piv);
        for (long i = 0; i < n; ++i) {
            if (i != row && x[i * n + col]) mul_into(i, row);
        }
        ++row;
    }
    const long x_rank = row;
    for (long col = 0; col < n; ++col) {
        long piv = -1;
        for (long i = row; i < n; ++i) {
            if (z[i * n + col]) { piv = i; break; }
        }
        if (piv < 0) continue;
        swap_rows(row, piv);
        for (long i = row; i < n; ++i) {
            if (i != row && z[i * n + col]) mul_into(i, row);
        }
        ++row;
    }
    return x_rank;
}

} // extern "C"
