// K1 — sphere-vs-frustum visibility for a batch of worlds.
//
// Replaces the TPU kernel lumixengine_tpu/ops/culling.py::frustum_cull_pallas
// (body _cull_kernel): visible = min over planes 0..5 of
// (x*px + y*py + z*pz + pd) >= -r. Planes 6-7 are always-pass padding.
//
// Bound on the H100: device memory. Each sphere reads 16 bytes (x, y, z, r)
// and writes 1, against about 24 flops, so the pass runs at the bandwidth
// roof. The design: one thread per (world, sphere); the x/y/z/r rows are
// read by neighbouring threads at neighbouring addresses (coalesced), and the
// world's 6 planes sit in shared memory, loaded once per block.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn) in the
// reference's order ((x*px + y*py) + z*pz) + pd: nvcc would otherwise contract
// a*b+c into an FMA, and a sphere that sits exactly on a plane could flip.
// With explicit rounding the kernel equals its plain PyTorch version bit for
// bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void frustum_cull_kernel(const float* __restrict__ centers,  // [W,3,K]
                                    const float* __restrict__ radii,    // [W,K]
                                    const float* __restrict__ planes,   // [W,8,4]
                                    uint8_t* __restrict__ out,          // [W,K]
                                    int K) {
    const int w = blockIdx.y;
    __shared__ float pl[24];
    if (threadIdx.x < 24) pl[threadIdx.x] = planes[(size_t)w * 32 + threadIdx.x];
    __syncthreads();
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    const float* c = centers + (size_t)w * 3 * K;
    const float x = c[k];
    const float y = c[(size_t)K + k];
    const float z = c[(size_t)2 * K + k];
    const float r = radii[(size_t)w * K + k];
    float acc = INFINITY;
#pragma unroll
    for (int p = 0; p < 6; ++p) {
        const float d = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(x, pl[4 * p]), __fmul_rn(y, pl[4 * p + 1])),
                      __fmul_rn(z, pl[4 * p + 2])),
            pl[4 * p + 3]);
        acc = fminf(acc, d);
    }
    out[(size_t)w * K + k] = acc >= -r ? 1 : 0;
}

}  // namespace

extern "C" int lumix_frustum_cull(const float* centers, const float* radii, const float* planes,
                                  uint8_t* out, int W, int K, cudaStream_t stream) {
    if (W <= 0 || K <= 0) return 0;
    dim3 grid((K + kThreads - 1) / kThreads, W);
    frustum_cull_kernel<<<grid, kThreads, 0, stream>>>(centers, radii, planes, out, K);
    return (int)cudaGetLastError();
}
