// Threefry-2x32 — the counter hash behind the port's random numbers
// (core/random.py), as jax.random computes it in its partitionable mode:
// 20 rounds, rotations (13, 15, 26, 6) and (17, 29, 16, 24), a key
// injection every 4 rounds with the third word k0 ^ k1 ^ 0x1BD11BDA.
//
// Replaces no TPU kernel: the JAX package draws through jax.random, whose
// Threefry XLA compiles and fuses itself; there is no pallas_call to port.
// It was added because the plain version (core/random.py) holds every
// 32-bit word in int64 and masks after each add and shift, so one draw of
// [4096, 2048] made ~180 passes over a 67 MB tensor and ~350 torch ops.
//
// Two entries:
//   * fold: per key b, the hash of the counter (0, d_b) — fold_in and split;
//   * draw: per key b and element i < n, the hash of the 64-bit counter i
//     (high word, low word) under the key, or under the key first folded by
//     d_b, written as y0 ^ y1 (bits, int64) or as the float32 uniform
//     ((w >> 9) | 0x3F800000 reinterpreted) - 1.
// Both equal the plain version bit for bit.
//
// Bound on the H100: integer arithmetic, on one pipe. Each of a hash's 20
// rounds needs a rotate (one funnel shift, SHF) and a xor (LOP3), which only
// the SM's integer ALU pipe executes, at 64 results a clock an SM; its add
// can issue on the FMA pipe as an IMAD, and nvcc puts most adds there. So a
// uniform word needs ~42 ALU operations for 4 bytes stored: at [4096, 2048]
// 0.021 ms at 1.98 GHz, against 0.010 ms for the store at 3.35 TB/s. The
// design: the words live in 32-bit registers and each rotate is one funnel
// shift; each thread hashes kPer = 4 consecutive counters, four independent
// chains that hide the pipes' latency, and stores the four results as one
// 16-byte write (two for int64 bits); the key batch runs on blockIdx.y, and
// one thread of each block loads its key words (int32 or int64, as the
// caller holds them) and folds them once into shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr uint32_t kParity = 0x1BD11BDAu;

#define LUMIX_TF_ROUND(r)                  \
    x0 += x1;                              \
    x1 = __funnelshift_l(x1, x1, r) ^ x0;
#define LUMIX_TF_ROUNDS_A \
    LUMIX_TF_ROUND(13) LUMIX_TF_ROUND(15) LUMIX_TF_ROUND(26) LUMIX_TF_ROUND(6)
#define LUMIX_TF_ROUNDS_B \
    LUMIX_TF_ROUND(17) LUMIX_TF_ROUND(29) LUMIX_TF_ROUND(16) LUMIX_TF_ROUND(24)

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t k2,
                                             uint32_t& x0, uint32_t& x1) {
    x0 += k0;
    x1 += k1;
    LUMIX_TF_ROUNDS_A
    x0 += k1;
    x1 += k2 + 1u;
    LUMIX_TF_ROUNDS_B
    x0 += k2;
    x1 += k0 + 2u;
    LUMIX_TF_ROUNDS_A
    x0 += k0;
    x1 += k1 + 3u;
    LUMIX_TF_ROUNDS_B
    x0 += k1;
    x1 += k2 + 4u;
    LUMIX_TF_ROUNDS_A
    x0 += k2;
    x1 += k0 + 5u;
}

// The low 32 bits of element i of an integer operand of 4 or 8 bytes.
__device__ __forceinline__ uint32_t word(const void* p, int wide, int64_t i) {
    return wide ? (uint32_t)((const long long*)p)[i] : (uint32_t)((const int*)p)[i];
}

// An operand broadcast over the key batch: element b * step (step 0 or 1).
struct Operand {
    const void* p;
    int wide;
    int step;
};

// The key of batch entry b, folded by its datum when `fold` is set: the
// datum is data[b * step], or `scalar` where data.p is null.
__device__ __forceinline__ void key_of(Operand key, Operand data, uint32_t scalar, int fold,
                                       int64_t b, uint32_t& k0, uint32_t& k1) {
    const int64_t kb = b * key.step;
    k0 = word(key.p, key.wide, 2 * kb);
    k1 = word(key.p, key.wide, 2 * kb + 1);
    if (fold) {
        uint32_t x0 = 0u;
        uint32_t x1 = data.p ? word(data.p, data.wide, b * data.step) : scalar;
        threefry2x32(k0, k1, k0 ^ k1 ^ kParity, x0, x1);
        k0 = x0;
        k1 = x1;
    }
}

__global__ void fold_kernel(Operand key, Operand data, uint32_t scalar,
                            long long* __restrict__ out, int64_t batch) {
    for (int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x; b < batch;
         b += (int64_t)gridDim.x * kThreads) {
        uint32_t k0, k1;
        key_of(key, data, scalar, 1, b, k0, k1);
        out[2 * b] = k0;
        out[2 * b + 1] = k1;
    }
}

template <bool kUniform>
__global__ void __launch_bounds__(kThreads)
draw_kernel(Operand key, Operand data, uint32_t scalar, int fold, void* __restrict__ out,
            int64_t batch, int64_t n) {
    __shared__ uint32_t sk[2];
    const int64_t i0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kPer;
    // n % kPer == 0 keeps every row's start, and so each thread's kPer
    // outputs, on a 16-byte boundary (the output is freshly allocated)
    const bool vec = n % kPer == 0;
    for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
        if (threadIdx.x == 0) {
            uint32_t k0, k1;
            key_of(key, data, scalar, fold, b, k0, k1);
            sk[0] = k0;
            sk[1] = k1;
        }
        __syncthreads();
        const uint32_t k0 = sk[0], k1 = sk[1], k2 = k0 ^ k1 ^ kParity;
        __syncthreads();  // sk is rewritten for the block's next key
        if (i0 >= n) continue;
        // i0 is a multiple of kPer, so its kPer counters share a high word
        const uint32_t hi = (uint32_t)((uint64_t)i0 >> 32), lo = (uint32_t)i0;
        uint32_t y[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            uint32_t x0 = hi, x1 = lo + (uint32_t)j;
            threefry2x32(k0, k1, k2, x0, x1);
            y[j] = x0 ^ x1;
        }
        const int64_t at = b * n + i0;
        if (kUniform) {
            float v[kPer];
#pragma unroll
            for (int j = 0; j < kPer; ++j) v[j] = __uint_as_float((y[j] >> 9) | 0x3F800000u) - 1.0f;
            float* row = (float*)out + at;
            if (vec) {
                *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
                for (int j = 0; j < kPer; ++j)
                    if (i0 + j < n) row[j] = v[j];
            }
        } else {
            long long* row = (long long*)out + at;
            if (vec) {
                reinterpret_cast<longlong2*>(row)[0] = make_longlong2(y[0], y[1]);
                reinterpret_cast<longlong2*>(row)[1] = make_longlong2(y[2], y[3]);
            } else {
#pragma unroll
                for (int j = 0; j < kPer; ++j)
                    if (i0 + j < n) row[j] = y[j];
            }
        }
    }
}

}  // namespace

// out [batch, 2] int64: the keys folded by their data.
extern "C" int lumix_threefry_fold(const void* key, int key_wide, int key_step, const void* data,
                                   int data_wide, int data_step, uint32_t scalar, long long* out,
                                   long long batch, cudaStream_t stream) {
    if (batch <= 0) return 0;
    const long long blocks = (batch + kThreads - 1) / kThreads;
    fold_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), kThreads, 0, stream>>>(
        Operand{key, key_wide, key_step}, Operand{data, data_wide, data_step}, scalar, out, batch);
    return (int)cudaGetLastError();
}

// out [batch, n]: float32 uniforms if `uniform`, else int64 bits.
extern "C" int lumix_threefry_draw(const void* key, int key_wide, int key_step, const void* data,
                                   int data_wide, int data_step, uint32_t scalar, int fold,
                                   int uniform, void* out, long long batch, long long n,
                                   cudaStream_t stream) {
    if (batch <= 0 || n <= 0) return 0;
    const long long per_block = (long long)kThreads * kPer;
    const long long bx = (n + per_block - 1) / per_block;
    if (bx > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)bx, (unsigned)(batch < 65535 ? batch : 65535));
    const Operand k{key, key_wide, key_step}, d{data, data_wide, data_step};
    if (uniform)
        draw_kernel<true><<<grid, kThreads, 0, stream>>>(k, d, scalar, fold, out, batch, n);
    else
        draw_kernel<false><<<grid, kThreads, 0, stream>>>(k, d, scalar, fold, out, batch, n);
    return (int)cudaGetLastError();
}
