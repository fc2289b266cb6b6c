/* Hardware entropy: RDRAND/RDSEED instruction wrappers.
 *
 * Native counterpart of the reference's rdrandwrapper
 * (reference: include/common/rdrandwrapper.hpp:30-90 — RdRandom::
 * SupportsRDRAND/SupportsRDSEED via cpuid, NextRaw with bounded
 * retries).  Built as a plain shared library at first use
 * (qrack_tpu_torch/native/__init__.py) and loaded with ctypes from
 * qrack_tpu_torch.utils.rng; every function is
 * safe to call on CPUs without the instructions (support is probed
 * with cpuid first, and the fill routine reports failure instead of
 * spinning).
 */

#include <stddef.h>
#include <stdint.h>

#if defined(__x86_64__) || defined(__i386__)
#include <cpuid.h>
#include <immintrin.h>

#define QRACK_RETRIES 16

int qrack_hw_rdrand_supported(void) {
    unsigned int eax, ebx, ecx, edx;
    if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return 0;
    return (ecx >> 30) & 1; /* CPUID.01H:ECX.RDRAND[bit 30] */
}

int qrack_hw_rdseed_supported(void) {
    unsigned int eax, ebx, ecx, edx;
    if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) return 0;
    return (ebx >> 18) & 1; /* CPUID.07H.0:EBX.RDSEED[bit 18] */
}

/* 1 on success (out filled), 0 on exhausted retries / unsupported. */
int qrack_rdrand64(uint64_t *out) {
    if (!qrack_hw_rdrand_supported()) return 0;
    for (int i = 0; i < QRACK_RETRIES; ++i) {
        unsigned long long v;
        if (_rdrand64_step(&v)) {
            *out = (uint64_t)v;
            return 1;
        }
    }
    return 0;
}

int qrack_rdseed64(uint64_t *out) {
    if (!qrack_hw_rdseed_supported()) return 0;
    for (int i = 0; i < QRACK_RETRIES; ++i) {
        unsigned long long v;
        if (_rdseed64_step(&v)) {
            *out = (uint64_t)v;
            return 1;
        }
    }
    return 0;
}

/* Fill len bytes from RDRAND; 1 on success, 0 if any word failed. */
int qrack_rdrand_fill(uint8_t *buf, size_t len) {
    size_t i = 0;
    while (i < len) {
        uint64_t v;
        if (!qrack_rdrand64(&v)) return 0;
        for (int b = 0; b < 8 && i < len; ++b, ++i)
            buf[i] = (uint8_t)(v >> (8 * b));
    }
    return 1;
}

#else /* non-x86: no instruction path; callers fall back to os.urandom */

int qrack_hw_rdrand_supported(void) { return 0; }
int qrack_hw_rdseed_supported(void) { return 0; }
int qrack_rdrand64(uint64_t *out) { (void)out; return 0; }
int qrack_rdseed64(uint64_t *out) { (void)out; return 0; }
int qrack_rdrand_fill(uint8_t *buf, size_t len) {
    (void)buf; (void)len; return 0;
}

#endif
