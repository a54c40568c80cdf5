// K2 — fused projected-Jacobi contact solve with split-impulse projection.
//
// Replaces the TPU kernel lumixengine_tpu/ops/solver_pallas.py::
// solve_contacts_fused (kernel _make_kernel). Per world: apply the warm-start
// impulses, run `iterations` projected-Jacobi passes (normal impulse >= 0,
// box friction within +-mu*lambda_n on two tangents, degree-scaled
// relaxation), then `position_iterations` split-impulse passes that return
// dpos. The per-contact constants come from the PyTorch prologue.
//
// On the TPU the gathers and scatters were [NB, C] one-hot incidence matmuls.
// Here they are index reads and shared-memory atomics:
//   * one CTA per world; the world's bodies (v, w, inverse mass, world
//     inverse inertia, dpos) and a [6, NB] impulse accumulator live in
//     shared memory, so every gather and scatter stays on chip;
//   * threads stride over the contacts; each thread owns its contacts for
//     the whole launch, so the accumulated lambdas are read and written in
//     place with no race;
//   * __syncthreads() separates gather and update, which keeps the pass
//     Jacobi: every contact of an iteration reads the same v, w.
// A ground contact has body_b = -1: it gathers zeros on the b side and
// scatters nothing there.
//
// Bound on the H100: latency of the dependent iteration chain and the
// shared-memory atomics; each iteration re-reads the contact constants
// (about 80 bytes per contact) from L2/device memory. At NB = 64 the
// shared footprint is 19 floats per body (4.9 KB), so many CTAs fit on one
// SM and hide each other's barriers. Atomics reorder the sums from run to
// run, so the kernel is held to its plain version with a tolerance.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct SolveArgs {
    const int* body_a;         // [W,C]
    const int* body_b;         // [W,C], -1 = ground
    const float* inv_mass;     // [NB]
    const float* inv_inertia;  // [W,3,NB] world diagonal
    const float* vel;          // [W,3,NB]
    const float* angvel;       // [W,3,NB]
    const float* r_a;          // [W,3,C]
    const float* r_b;
    const float* n;
    const float* t1;
    const float* t2;
    const float* k_n;          // [W,C]
    const float* k_t1;
    const float* k_t2;
    const float* v_target;
    const float* mu;
    const float* act;
    const float* relax;
    const float* ln0;
    const float* lt10;
    const float* lt20;
    const float* e0_p;
    const float* relax_p;
    const float* k_lin;
    float* vel_out;            // [W,3,NB]
    float* ang_out;
    float* dpos_out;
    float* ln_out;             // [W,C]
    float* lt1_out;
    float* lt2_out;
    float* lam_p;              // [W,C] scratch: projection lambdas
    int nb;
    int c;
    int iterations;
    int position_iterations;
};

struct Vec3 {
    float x, y, z;
};

__device__ __forceinline__ Vec3 load3(const float* base, int C, int c) {
    return Vec3{base[c], base[C + c], base[2 * C + c]};
}

__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
    return Vec3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// acc[0:3] += sign * imp, acc[3:6] += sign * (r x imp) for body i
__device__ __forceinline__ void scatter6(float* acc, int NB, int i, Vec3 imp, Vec3 r, float sign) {
    const Vec3 t = cross(r, imp);
    atomicAdd(&acc[0 * NB + i], sign * imp.x);
    atomicAdd(&acc[1 * NB + i], sign * imp.y);
    atomicAdd(&acc[2 * NB + i], sign * imp.z);
    atomicAdd(&acc[3 * NB + i], sign * t.x);
    atomicAdd(&acc[4 * NB + i], sign * t.y);
    atomicAdd(&acc[5 * NB + i], sign * t.z);
}

// v += acc[0:3] * im, w += acc[3:6] * Iw; clears acc
__device__ __forceinline__ void apply_velocity(float* v, float* w, float* acc, const float* im,
                                               const float* Iw, int NB) {
    for (int i = threadIdx.x; i < NB; i += blockDim.x) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            v[k * NB + i] += acc[k * NB + i] * im[i];
            w[k * NB + i] += acc[(3 + k) * NB + i] * Iw[k * NB + i];
            acc[k * NB + i] = 0.f;
            acc[(3 + k) * NB + i] = 0.f;
        }
    }
}

__device__ __forceinline__ Vec3 point_velocity(const float* v, const float* w, int NB, int i,
                                               Vec3 r) {
    const Vec3 wi{w[i], w[NB + i], w[2 * NB + i]};
    const Vec3 wxr = cross(wi, r);
    return Vec3{v[i] + wxr.x, v[NB + i] + wxr.y, v[2 * NB + i] + wxr.z};
}

__global__ void __launch_bounds__(kThreads) solve_contacts_kernel(SolveArgs a) {
    extern __shared__ float sm[];
    const int NB = a.nb;
    const int C = a.c;
    float* v = sm;            // [3,NB]
    float* w = v + 3 * NB;    // [3,NB]
    float* acc = w + 3 * NB;  // [6,NB]
    float* im = acc + 6 * NB; // [NB]
    float* Iw = im + NB;      // [3,NB]
    float* dp = Iw + 3 * NB;  // [3,NB]

    const size_t world = blockIdx.x;
    const size_t bo = world * 3 * NB;
    const size_t ro = world * C;
    const size_t vo = world * 3 * C;
    for (int i = threadIdx.x; i < 3 * NB; i += blockDim.x) {
        v[i] = a.vel[bo + i];
        w[i] = a.angvel[bo + i];
        Iw[i] = a.inv_inertia[bo + i];
        dp[i] = 0.f;
    }
    for (int i = threadIdx.x; i < 6 * NB; i += blockDim.x) acc[i] = 0.f;
    for (int i = threadIdx.x; i < NB; i += blockDim.x) im[i] = a.inv_mass[i];
    __syncthreads();

    const int* ba = a.body_a + ro;
    const int* bb = a.body_b + ro;
    const float* ra_p = a.r_a + vo;
    const float* rb_p = a.r_b + vo;
    const float* n_p = a.n + vo;
    const float* t1_p = a.t1 + vo;
    const float* t2_p = a.t2 + vo;
    float* ln = a.ln_out + ro;
    float* lt1 = a.lt1_out + ro;
    float* lt2 = a.lt2_out + ro;

    // warm start: last frame's impulses up front (inactive slots masked)
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const float act = a.act[ro + c];
        const float wn = fmaxf(a.ln0[ro + c], 0.f) * act;
        const float w1 = a.lt10[ro + c] * act;
        const float w2 = a.lt20[ro + c] * act;
        ln[c] = wn;
        lt1[c] = w1;
        lt2[c] = w2;
        if (act > 0.f) {
            const Vec3 nn = load3(n_p, C, c), u1 = load3(t1_p, C, c), u2 = load3(t2_p, C, c);
            const Vec3 imp{nn.x * wn + u1.x * w1 + u2.x * w2, nn.y * wn + u1.y * w1 + u2.y * w2,
                           nn.z * wn + u1.z * w1 + u2.z * w2};
            scatter6(acc, NB, ba[c], imp, load3(ra_p, C, c), -1.f);
            if (bb[c] >= 0) scatter6(acc, NB, bb[c], imp, load3(rb_p, C, c), 1.f);
        }
    }
    __syncthreads();
    apply_velocity(v, w, acc, im, Iw, NB);
    __syncthreads();

    for (int it = 0; it < a.iterations; ++it) {
        for (int c = threadIdx.x; c < C; c += blockDim.x) {
            const int ia = ba[c];
            const int ib = bb[c];
            const float act = a.act[ro + c];
            const Vec3 ra = load3(ra_p, C, c), rb = load3(rb_p, C, c);
            const Vec3 nn = load3(n_p, C, c), u1 = load3(t1_p, C, c), u2 = load3(t2_p, C, c);
            const Vec3 va = point_velocity(v, w, NB, ia, ra);
            const Vec3 vb = ib >= 0 ? point_velocity(v, w, NB, ib, rb) : Vec3{0.f, 0.f, 0.f};
            const Vec3 vr{vb.x - va.x, vb.y - va.y, vb.z - va.z};
            const float rlx = a.relax[ro + c];
            const float l0 = ln[c], l1 = lt1[c], l2 = lt2[c];
            float dln = (a.v_target[ro + c] - dot(vr, nn)) / a.k_n[ro + c] * rlx;
            const float new_ln = fmaxf(l0 + dln, 0.f);
            dln = (new_ln - l0) * act;
            const float max_f = a.mu[ro + c] * (l0 + dln);
            const float n1 = fminf(fmaxf(l1 + (-dot(vr, u1) / a.k_t1[ro + c]) * rlx, -max_f), max_f);
            const float n2 = fminf(fmaxf(l2 + (-dot(vr, u2) / a.k_t2[ro + c]) * rlx, -max_f), max_f);
            const float d1 = (n1 - l1) * act;
            const float d2 = (n2 - l2) * act;
            ln[c] = l0 + dln;
            lt1[c] = l1 + d1;
            lt2[c] = l2 + d2;
            if (act != 0.f) {
                const Vec3 imp{nn.x * dln + u1.x * d1 + u2.x * d2, nn.y * dln + u1.y * d1 + u2.y * d2,
                               nn.z * dln + u1.z * d1 + u2.z * d2};
                scatter6(acc, NB, ia, imp, ra, -1.f);
                if (ib >= 0) scatter6(acc, NB, ib, imp, rb, 1.f);
            }
        }
        __syncthreads();
        apply_velocity(v, w, acc, im, Iw, NB);
        __syncthreads();
    }

    // split-impulse position projection from dpos = 0, lambda = 0
    float* lam = a.lam_p + ro;
    for (int c = threadIdx.x; c < C; c += blockDim.x) lam[c] = 0.f;
    for (int it = 0; it < a.position_iterations; ++it) {
        for (int c = threadIdx.x; c < C; c += blockDim.x) {
            const int ia = ba[c];
            const int ib = bb[c];
            const float act = a.act[ro + c];
            const Vec3 nn = load3(n_p, C, c);
            const Vec3 pa{dp[ia], dp[NB + ia], dp[2 * NB + ia]};
            const Vec3 pb = ib >= 0 ? Vec3{dp[ib], dp[NB + ib], dp[2 * NB + ib]} : Vec3{0.f, 0.f, 0.f};
            const Vec3 dd{pb.x - pa.x, pb.y - pa.y, pb.z - pa.z};
            float dlam = (a.e0_p[ro + c] - dot(dd, nn)) / a.k_lin[ro + c] * a.relax_p[ro + c];
            const float l0 = lam[c];
            const float new_lam = fmaxf(l0 + dlam, 0.f);
            dlam = (new_lam - l0) * act;
            lam[c] = new_lam;
            if (act != 0.f) {
                const Vec3 s{nn.x * dlam, nn.y * dlam, nn.z * dlam};
                atomicAdd(&acc[0 * NB + ia], -s.x);
                atomicAdd(&acc[1 * NB + ia], -s.y);
                atomicAdd(&acc[2 * NB + ia], -s.z);
                if (ib >= 0) {
                    atomicAdd(&acc[0 * NB + ib], s.x);
                    atomicAdd(&acc[1 * NB + ib], s.y);
                    atomicAdd(&acc[2 * NB + ib], s.z);
                }
            }
        }
        __syncthreads();
        for (int i = threadIdx.x; i < NB; i += blockDim.x) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                dp[k * NB + i] += acc[k * NB + i] * im[i];
                acc[k * NB + i] = 0.f;
            }
        }
        __syncthreads();
    }

    for (int i = threadIdx.x; i < 3 * NB; i += blockDim.x) {
        a.vel_out[bo + i] = v[i];
        a.ang_out[bo + i] = w[i];
        a.dpos_out[bo + i] = dp[i];
    }
}

}  // namespace

extern "C" size_t lumix_solve_contacts_smem(int nb) { return (size_t)19 * nb * sizeof(float); }

extern "C" int lumix_solve_contacts(
    const int* body_a, const int* body_b, const float* inv_mass, const float* inv_inertia,
    const float* vel, const float* angvel, const float* r_a, const float* r_b, const float* n,
    const float* t1, const float* t2, const float* k_n, const float* k_t1, const float* k_t2,
    const float* v_target, const float* mu, const float* act, const float* relax,
    const float* ln0, const float* lt10, const float* lt20, const float* e0_p,
    const float* relax_p, const float* k_lin, float* vel_out, float* ang_out, float* dpos_out,
    float* ln_out, float* lt1_out, float* lt2_out, float* lam_p, int W, int NB, int C,
    int iterations, int position_iterations, cudaStream_t stream) {
    if (W <= 0) return 0;
    SolveArgs a{body_a, body_b, inv_mass, inv_inertia, vel, angvel, r_a, r_b, n, t1, t2,
                k_n, k_t1, k_t2, v_target, mu, act, relax, ln0, lt10, lt20, e0_p, relax_p,
                k_lin, vel_out, ang_out, dpos_out, ln_out, lt1_out, lt2_out, lam_p,
                NB, C, iterations, position_iterations};
    const size_t smem = lumix_solve_contacts_smem(NB);
    solve_contacts_kernel<<<W, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}
