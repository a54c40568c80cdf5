// K2 — fused projected-Jacobi contact solve with split-impulse projection.
//
// Replaces the TPU kernel lumixengine_tpu/ops/solver_pallas.py::
// solve_contacts_fused (kernel _make_kernel). Per world: apply the warm-start
// impulses, run `iterations` projected-Jacobi passes (normal impulse >= 0,
// box friction within +-mu*lambda_n on two tangents, degree-scaled
// relaxation), then `position_iterations` split-impulse passes that return
// dpos. The per-contact constants come from the PyTorch prologue.
//
// Bound on the H100: device memory. Every slot needs act and its 3
// warm-start lambdas read and its 3 lambdas written (28 B); an active slot
// needs its other 26 operand words too (2 body indices, r_a, r_b, n, t1,
// t2, 9 scalar rows: 104 B more); a world needs 18 body words per body. With
// every slot active, at the main path's shape (W=1024, NB=64, C=1792), that
// is 246.9 MB, 73.7 us at 3.35 TB/s; the settled flagship problem (8.4% of
// its slots active) needs 72.2 MB, 21.6 us. The arithmetic takes an eighth
// of that time at the card's fp32 rate (2.7 us): the passes run over the
// active contacts only.
//
// The design reads each operand from device memory once and keeps every
// active contact on chip, in shared memory, from the warm start through the
// last pass:
//   * asynchronous copies bring the operands in: bulk copies (cp.async.bulk,
//     TMA) issued by one thread, each completing on an mbarrier, for whole
//     rows (the act row, and every row of the in-place kernel), and 4-byte
//     cp.async copies for the compact kernel's active slots, which read
//     only the 32-byte sectors that hold an active slot;
//   * a block prefix sum over `act` lists the active slots once; every pass
//     runs over that list only. An inactive slot moves no body, and its
//     lambdas are the warm start times act, written when it is loaded;
//   * the relaxation folds into the effective masses once (relax / k), so a
//     pass multiplies where the plain version divides and multiplies;
//   * a pass has two phases split by a barrier, which keeps it Jacobi (every
//     contact reads the same v, w). Each active contact computes its impulse
//     and leaves it in a scratch row. Then thread (axis, body) sums that
//     axis of the body's impulses and torques over the contacts that touch
//     it, listed once at load in ascending order, and applies them. The sums
//     run in a fixed order, so the kernel is deterministic run to run.
//     (Shared-memory float atomics compile to compare-and-swap loops on
//     sm_90; the first version of this design spent most of a pass in them.)
// Two kernels share that code:
//   * solve_kernel<true> (compact): one CTA of 256 threads per world reads
//     the act row by bulk copy and lists the active slots; then each thread
//     copies its active slots' 29 other words straight into their records
//     of capacity `cap` (134 B each) by asynchronous 4-byte copies
//     (cp.async), all in flight at once, and writes the inactive slots'
//     lambdas from the warm-start rows while they land. It runs twice: with
//     the capacity at which 4 CTAs share an SM (320 at the main shape, 56 KB
//     a CTA), then at 3 (472) on the worlds the first left.
//     Several worlds share an SM, so one's load overlaps another's passes.
//     (256 threads put 2 warps on each quarter of the SM's register file;
//     320 fit the file in sum but left 3 CTAs an SM only some of the time.)
//   * solve_kernel<false> (in place) takes the worlds left after that: its
//     rows stay where the bulk copies put them, split over a cluster of S
//     CTAs (1 to 8) where one block's 227 KB does not hold them (C = 7168 at
//     NB = 256). Each CTA keeps a replica of the bodies and leaves its
//     partial sums in shared memory; after a cluster barrier every CTA adds
//     the S partials in rank order through distributed shared memory, so
//     the replicas stay equal. Its velocity scratch is the position rows,
//     loaded after the velocity passes.
// A kernel that follows another takes the list of worlds it left (device
// memory, an atomic append) and runs one wave of CTAs that loop over it, so
// an empty list costs a launch and no more; the launch overlaps the kernel
// before it (programmatic dependent launch). A world that a compact kernel
// leaves has its act row read again by the next kernel.
//
// No tensor cores: the scatter has 2 non-zeros in each column of a [C, NB]
// incidence, so a dense product does NB/2 times the useful flops, and TF32
// rounding would break the 1e-4 limit against the plain version, which sums
// in another order (the kernel is held to it with a tolerance).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Built with -DLUMIX_K2_STAMPS (tools/time_k2.py does), thread 0 of every
// compact CTA reads the global timer (ns) at each of kStamps phase
// boundaries of its world into the buffer given to lumix_k2_set_stamps
// ([W, kStamps] uint64). Off in the library the package builds.
constexpr int kStamps = 9;
#ifdef LUMIX_K2_STAMPS
__device__ unsigned long long* g_k2_stamps;
extern "C" int lumix_k2_set_stamps(unsigned long long* p) {
    return (int)cudaMemcpyToSymbol(g_k2_stamps, &p, sizeof(p));
}
#define K2_STAMP(i)                                                              \
    do {                                                                         \
        if (kCompact && threadIdx.x == 0) {                                      \
            unsigned long long t;                                                \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                \
            g_k2_stamps[world * kStamps + (i)] = t;                              \
        }                                                                        \
    } while (0)
#else
#define K2_STAMP(i) \
    do {            \
    } while (0)
#endif

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;
constexpr size_t kMaxSmem = 232448;  // shared memory one block may use on sm_90
// 3 mbarriers, the active count, 32 warp totals
constexpr int kHeader = 256;
constexpr int kActiveAt = 64, kWarpSumsAt = 128;

// The operand rows, in load-group order: group 0 [0, 21) compaction and warm
// start, group 1 [21, 27) velocity passes, group 2 [27, 30) position passes.
enum Row {
    kBa = 0, kBb = 1, kRa = 2, kRb = 5, kN = 8, kT1 = 11, kT2 = 14, kAct = 17,
    kLn = 18, kLt1 = 19, kLt2 = 20,
    kKn = 21, kKt1 = 22, kKt2 = 23, kVt = 24, kMu = 25, kRelax = 26,
    kE0 = 27, kRelaxP = 28, kKlin = 29,
    kRows = 30
};

__device__ __forceinline__ int group_end(int g) { return g == 0 ? kKn : g == 1 ? kE0 : kRows; }

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
    // the worlds to solve: todo_ids[0 .. *todo_n) (null: all W, one per CTA
    // or cluster); a compact kernel appends the worlds it cannot hold to left
    const int* todo_n;
    const int* todo_ids;
    int* left_n;
    int* left_ids;
    int worlds;
    int nb;
    int c;
    int stride;                // slots per row on chip: in place the CTA's share, compact `cap`
    int iterations;
    int position_iterations;
};

__host__ __device__ size_t up16(size_t x) { return (x + 15) / 16 * 16; }

// Shared memory, in bytes from the start: the header, then (compact only)
// the act row (C words), then the rows (stride slots each), then in place
// the active list, compact each record's slot, a bit per slot (active) and
// the velocity scratch,
// then v, w, Iw (dpos after the velocity passes), inverse mass, the start of
// each body's incidences (NB + 1) and two [6, NB] partial sums.
struct Layout {
    size_t act, rows, idx, orig, live, scratch, bodies, total;
};

__host__ __device__ Layout layout(bool compact, int nb, int c, int stride) {
    Layout L{};
    size_t o = kHeader;
    if (compact) {
        L.act = o;
        o += up16((size_t)c * sizeof(float));
    }
    L.rows = o;
    o += (size_t)kRows * stride * sizeof(float);
    if (!compact) {
        L.idx = o;
        o += up16((size_t)stride * sizeof(uint16_t));
    } else {
        L.orig = o;
        o += up16((size_t)stride * sizeof(uint16_t));
        L.live = o;
        o += up16((size_t)(c + 31) / 32 * sizeof(uint32_t));
        L.scratch = o;
        o += (size_t)3 * stride * sizeof(float);
    }
    L.bodies = o;
    o += ((size_t)23 * nb + 1) * sizeof(float);
    L.total = o;
    return L;
}

// where row r of `world` starts in device memory
__device__ __forceinline__ const void* row_source(const SolveArgs& a, int r, size_t world) {
    const size_t C = a.c;
    const size_t s = world * C, v = world * 3 * C;
    switch (r) {
        case kBa: return a.body_a + s;
        case kBb: return a.body_b + s;
        case kAct: return a.act + s;
        case kLn: return a.ln0 + s;
        case kLt1: return a.lt10 + s;
        case kLt2: return a.lt20 + s;
        case kKn: return a.k_n + s;
        case kKt1: return a.k_t1 + s;
        case kKt2: return a.k_t2 + s;
        case kVt: return a.v_target + s;
        case kMu: return a.mu + s;
        case kRelax: return a.relax + s;
        case kE0: return a.e0_p + s;
        case kRelaxP: return a.relax_p + s;
        case kKlin: return a.k_lin + s;
        default: break;
    }
    const float* base = r < kRb ? a.r_a : r < kN ? a.r_b : r < kT1 ? a.n : r < kT2 ? a.t1 : a.t2;
    const int first = r < kRb ? kRa : r < kN ? kRb : r < kT1 ? kN : r < kT2 ? kT1 : kT2;
    return base + v + (size_t)(r - first) * C;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_inval(uint64_t* bar) {
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// waits for phase `parity` of a barrier; a copy that never lands traps (a
// launch error) instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    for (long long tries = 0; !done; ++tries) {
        if (tries == (1LL << 26)) __trap();
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// one word from device memory into shared memory, asynchronously; the
// thread's copies land at async_wait
__device__ __forceinline__ void async_word(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void async_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

struct Vec3 {
    float x, y, z;
};

__device__ __forceinline__ Vec3 row3(const float* row0, int stride, int c) {
    return Vec3{row0[c], row0[stride + c], row0[2 * stride + c]};
}

__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
    return Vec3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ Vec3 point_velocity(const float* v, const float* w, int NB, int i,
                                               Vec3 r) {
    const Vec3 wi{w[i], w[NB + i], w[2 * NB + i]};
    const Vec3 wxr = cross(wi, r);
    return Vec3{v[i] + wxr.x, v[NB + i] + wxr.y, v[2 * NB + i] + wxr.z};
}

// body_a and body_b of a slot, packed into one word at load
__device__ __forceinline__ void bodies(uint32_t p, int& ia, int& ib) {
    ia = (int)(p & 0xffffu);
    ib = (int)(p >> 16) - 1;
}

// Block prefix sum of `cnt` over the threads (inclusive within a warp, then
// over warps): returns this thread's exclusive offset; *total gets the sum.
__device__ __forceinline__ int block_offset(int cnt, int* warp_sum, int* total) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int nw = blockDim.x >> 5;
        int x = lane < nw ? warp_sum[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x += y;
        }
        if (lane < nw) warp_sum[lane] = x;  // inclusive over warps
        if (lane == nw - 1) *total = x;
    }
    __syncthreads();
    return incl - cnt + (warp ? warp_sum[warp - 1] : 0);
}

// One world, by one CTA (compact) or a cluster of S (in place). `again`:
// this CTA solved another world before, in the same shared memory.
template <bool kCompact>
__device__ void solve_world(const SolveArgs& a, const size_t world, const bool again) {
    extern __shared__ __align__(16) unsigned char smem[];
    K2_STAMP(0);
    cg::cluster_group cluster = cg::this_cluster();
    const int S = kCompact ? 1 : (int)cluster.num_blocks();
    const int rank = kCompact ? 0 : (int)cluster.block_rank();
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int NB = a.nb, C = a.c;
    const int stride = a.stride;
    // in place: the CTA's slots [off, off + n); compact: every slot
    const int off = kCompact ? 0 : rank * stride;
    const int n = kCompact ? C : max(0, min(stride, C - off));

    const Layout L = layout(kCompact, NB, C, stride);
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    int* n_active = reinterpret_cast<int*>(smem + kActiveAt);
    int* warp_sum = reinterpret_cast<int*>(smem + kWarpSumsAt);
    float* rows = reinterpret_cast<float*>(smem + L.rows);
    uint16_t* idx = reinterpret_cast<uint16_t*>(smem + L.idx);
    float* v = reinterpret_cast<float*>(smem + L.bodies);  // [3,NB]
    float* w = v + 3 * NB;     // [3,NB]
    float* Iw = w + 3 * NB;    // [3,NB], dpos after the velocity passes
    float* im = Iw + 3 * NB;   // [NB]
    int* first = reinterpret_cast<int*>(im + NB);  // [NB+1] each body's run of incidences
    float* acc = reinterpret_cast<float*>(first + NB + 1);  // [2][6,NB] partial sums (S > 1)
    auto R = [&](int r) { return rows + (size_t)r * stride; };
    // the slot (in place) or record (compact: the records are the active
    // slots, in order) of active slot j
    auto at = [&](int j) { return kCompact ? j : (int)idx[j]; };

    __syncthreads();  // the last world's threads are done with the shared memory
    if (tid == 0) {
        // every copy of the last world has landed: it waited on each
        for (int g = 0; g < (kCompact ? 1 : 3); ++g) {
            if (again) bar_inval(&bar[g]);
            bar_init(&bar[g]);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        // the bulk copies below rewrite what the last world's threads wrote
        if (again) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    const uint32_t row_bytes = (uint32_t)n * sizeof(float);
    // in place: group g of the rows (groups 0 and 1 now; group 2 after the
    // velocity passes, into the rows that served them as scratch)
    auto load_group = [&](int g) {
        if (tid != 0 || n == 0) return;
        const int r0 = g == 0 ? 0 : g == 1 ? kKn : kE0;
        bar_expect(&bar[g], row_bytes * (group_end(g) - r0));
        for (int r = r0; r < group_end(g); ++r)
            bulk_load(R(r), static_cast<const char*>(row_source(a, r, world)) + off * 4,
                      row_bytes, &bar[g]);
    };
    // compact: the act row, whole, into its own buffer
    const float* act_in = kCompact ? reinterpret_cast<const float*>(smem + L.act) : R(kAct);
    if (kCompact) {
        if (tid == 0 && n > 0) {
            bar_expect(&bar[0], row_bytes);
            bulk_load(smem + L.act, a.act + world * C, row_bytes, &bar[0]);
        }
    } else {
        load_group(0);
        load_group(1);
    }
    // the bodies (a replica in every CTA of the cluster) while the rows arrive
    const size_t bo = world * 3 * NB;
    for (int i = tid; i < 3 * NB; i += T) {
        v[i] = a.vel[bo + i];
        w[i] = a.angvel[bo + i];
        Iw[i] = a.inv_inertia[bo + i];
    }
    for (int i = tid; i < NB; i += T) im[i] = a.inv_mass[i];
    for (int i = tid; i <= NB; i += T) first[i] = 0;
    if (n > 0) bar_wait(&bar[0], 0);
    K2_STAMP(1);

    // Compaction: each thread takes a run of `per` slots; a block prefix sum
    // of the active counts places them in slot order.
    const int per = (n + T - 1) / T;
    const int lo = min(tid * per, n), hi = min(lo + per, n);
    int cnt = 0;
    for (int c = lo; c < hi; ++c) cnt += act_in[c] != 0.f;
    int pos = block_offset(cnt, warp_sum, n_active);
    const int na = *n_active;
    K2_STAMP(2);
    // too many active slots: left to the next kernel (no copy is in flight:
    // the act row has landed)
    if (kCompact && na > stride) {
        if (tid == 0) a.left_ids[atomicAdd(a.left_n, 1)] = (int)world;
        return;
    }
    uint32_t* pk = reinterpret_cast<uint32_t*>(R(kBa));
    float* act = R(kAct);
    float* ln = R(kLn);
    float* lt1 = R(kLt1);
    float* lt2 = R(kLt2);
    const int* bb_in = reinterpret_cast<const int*>(R(kBb));
    if (kCompact) {
        // the active slots become records 0 .. na-1, in slot order
        uint16_t* orig = reinterpret_cast<uint16_t*>(smem + L.orig);
        uint32_t* live = reinterpret_cast<uint32_t*>(smem + L.live);
        for (int i = tid; i < (C + 31) / 32; i += T) live[i] = 0u;
        __syncthreads();
        for (int c = lo; c < hi; ++c) {
            const float ac = act_in[c];
            if (ac != 0.f) {
                act[pos] = ac;
                orig[pos] = (uint16_t)c;
                atomicOr(&live[c >> 5], 1u << (c & 31));
                ++pos;
            }
        }
        __syncthreads();
        // each thread copies the other 29 words of its records (j = tid mod
        // T) from device memory, all in flight at once (row by row, so that
        // one row's address is live at a time) ...
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (r == kAct) continue;
            const char* src = static_cast<const char*>(row_source(a, r, world));
            for (int j = tid; j < na; j += T) async_word(R(r) + j, src + orig[j] * 4);
        }
        // ... and meanwhile writes each inactive slot's lambdas: the warm
        // start times 0 (an active slot's are written after the passes),
        // kBatch slots' loads in flight before their stores
        const size_t o = world * (size_t)C;
        constexpr int kBatch = 4;
        for (int c0 = tid; c0 < C; c0 += kBatch * T) {
            bool dead[kBatch];
            float x[3][kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                const int c = c0 + k * T;
                dead[k] = c < C && !(live[c >> 5] >> (c & 31) & 1u);
                x[0][k] = dead[k] ? a.ln0[o + c] : 0.f;
                x[1][k] = dead[k] ? a.lt10[o + c] : 0.f;
                x[2][k] = dead[k] ? a.lt20[o + c] : 0.f;
            }
#pragma unroll
            for (int k = 0; k < kBatch; ++k)
                if (dead[k]) {
                    const int c = c0 + k * T;
                    a.ln_out[o + c] = fmaxf(x[0][k], 0.f) * 0.f;
                    a.lt1_out[o + c] = x[1][k] * 0.f;
                    a.lt2_out[o + c] = x[2][k] * 0.f;
                }
        }
        async_wait();
        // its own records have landed: warm-start lambdas times act, and
        // body_a, body_b packed
        for (int j = tid; j < na; j += T) {
            const float ac = act[j];
            ln[j] = fmaxf(ln[j], 0.f) * ac;
            lt1[j] *= ac;
            lt2[j] *= ac;
            pk[j] = pk[j] | (uint32_t)(bb_in[j] + 1) << 16;
        }
        K2_STAMP(3);
    } else {
        // in place: the warm-start lambdas of every slot become lambdas times
        // act (an inactive slot's output), and body_a, body_b are packed
        for (int c = lo; c < hi; ++c) {
            const float ac = act[c];
            if (ac != 0.f) idx[pos++] = (uint16_t)c;
            ln[c] = fmaxf(ln[c], 0.f) * ac;
            lt1[c] *= ac;
            lt2[c] *= ac;
            pk[c] = pk[c] | (uint32_t)(bb_in[c] + 1) << 16;
        }
    }
    __syncthreads();

    // The incidences of the active slots, grouped by body: entry m = 2j + side
    // (side 1 = body_b) of active slot j, in the body_b row's place. Counts
    // first, a prefix sum, then one warp places the entries in ascending m,
    // so every body sums its contacts in a fixed order.
    uint16_t* ent = reinterpret_cast<uint16_t*>(R(kBb));
    for (int j = tid; j < na; j += T) {
        int ia, ib;
        bodies(pk[at(j)], ia, ib);
        atomicAdd(&first[ia + 1], 1);
        if (ib >= 0) atomicAdd(&first[ib + 1], 1);
    }
    __syncthreads();
    if (warp == 0) {
        int carry = 0;
        for (int b0 = 1; b0 <= NB; b0 += 32) {
            int x = b0 + lane <= NB ? first[b0 + lane] : 0;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, x, d);
                if (lane >= d) x += y;
            }
            if (b0 + lane <= NB) first[b0 + lane] = x + carry;
            carry += __shfl_sync(0xffffffffu, x, 31);
        }
        __syncwarp();
        int* cursor = reinterpret_cast<int*>(acc);  // free until the first pass
        for (int b = lane; b < NB; b += 32) cursor[b] = first[b];
        __syncwarp();
        for (int m0 = 0; m0 < 2 * na; m0 += 32) {
            const int m = m0 + lane;
            int body = -1;
            if (m < 2 * na) {
                int ia, ib;
                bodies(pk[at(m >> 1)], ia, ib);
                body = m & 1 ? ib : ia;
            }
            const uint32_t same = __match_any_sync(0xffffffffu, body);
            const int at = body >= 0 ? cursor[body] + __popc(same & ((1u << lane) - 1)) : 0;
            __syncwarp();
            if (body >= 0) {
                ent[at] = (uint16_t)m;
                if (lane == __ffs(same) - 1) cursor[body] += __popc(same);
            }
            __syncwarp();
        }
    }
    __syncthreads();
    K2_STAMP(4);

    const float* ra_r = R(kRa);
    const float* rb_r = R(kRb);
    const float* n_r = R(kN);
    const float* t1_r = R(kT1);
    const float* t2_r = R(kT2);
    int buf = 0;

    // The end of a pass. The active slots have left their impulses in the
    // scratch rows sx, sy, sz (indexed by j). Thread (a, b) sums axis a of
    // body b's impulses and (velocity passes) of its torques r x imp over
    // the body's incidences, in order, and applies them. With S > 1 each CTA
    // leaves its partial sums in acc[buf]; after a cluster barrier every CTA
    // adds the S partials in rank order (so the replicas stay equal) and
    // applies them. The two buffers alternate: a CTA rewrites acc[buf] two
    // passes later, after every CTA has read it.
    auto finish_pass = [&](const float* sx, const float* sy, const float* sz, bool position) {
        __syncthreads();
        float* part = acc + buf * 6 * NB;
        for (int i = tid; i < 3 * NB; i += T) {
            const int ax = i / NB, b = i - ax * NB;
            const int p = ax == 2 ? 0 : ax + 1, q = ax == 0 ? 2 : ax - 1;
            const float* ia = ax == 0 ? sx : ax == 1 ? sy : sz;
            const float* ip = p == 0 ? sx : p == 1 ? sy : sz;
            const float* iq = q == 0 ? sx : q == 1 ? sy : sz;
            const int e1 = first[b + 1];
            float lin = 0.f, ang = 0.f;
#pragma unroll 4
            for (int e = first[b]; e < e1; ++e) {
                const int m = ent[e];
                const int j = m >> 1;
                const float x = ia[j];
                lin += m & 1 ? x : -x;
                if (!position) {  // (r x imp)_ax = r[p] imp[q] - r[q] imp[p]
                    const int c = at(j);
                    const float* r = m & 1 ? rb_r : ra_r;
                    const float t = r[p * stride + c] * iq[j] - r[q * stride + c] * ip[j];
                    ang += m & 1 ? t : -t;
                }
            }
            if (S > 1) {
                part[i] = lin;
                part[i + 3 * NB] = ang;
            } else if (position) {
                Iw[i] += lin * im[b];
            } else {
                v[i] += lin * im[b];
                w[i] += ang * Iw[i];
            }
        }
        if (S > 1) {
            cluster.sync();
            for (int i = tid; i < (position ? 3 : 6) * NB; i += T) {
                float s = 0.f;
                for (int r = 0; r < S; ++r) s += cluster.map_shared_rank(part, r)[i];
                const int k = i / NB, b = i - k * NB;
                if (position) Iw[i] += s * im[b];
                else if (k < 3) v[i] += s * im[b];
                else w[i - 3 * NB] += s * Iw[i - 3 * NB];
            }
            buf ^= 1;
        }
        __syncthreads();
    };

    // velocity-pass scratch: compact, its own rows; in place, the position
    // rows, loaded after the velocity passes
    float* scratch = kCompact ? reinterpret_cast<float*>(smem + L.scratch) : R(kE0);
    float* sx = scratch;
    float* sy = scratch + stride;
    float* sz = scratch + 2 * stride;

    // warm start: last frame's impulses up front
    for (int j = tid; j < na; j += T) {
        const int c = at(j);
        Vec3 imp{0.f, 0.f, 0.f};
        if (act[c] > 0.f) {
            const float wn = ln[c], w1 = lt1[c], w2 = lt2[c];
            const Vec3 nn = row3(n_r, stride, c), u1 = row3(t1_r, stride, c),
                       u2 = row3(t2_r, stride, c);
            imp = Vec3{nn.x * wn + u1.x * w1 + u2.x * w2, nn.y * wn + u1.y * w1 + u2.y * w2,
                       nn.z * wn + u1.z * w1 + u2.z * w2};
        }
        sx[j] = imp.x;
        sy[j] = imp.y;
        sz[j] = imp.z;
    }
    finish_pass(sx, sy, sz, false);
    K2_STAMP(5);

    // The relaxation folds into the effective masses once, so that a pass
    // multiplies where the plain version divides and multiplies (each
    // result moves by an ulp or so): k_n becomes relax / k_n, and so on.
    if (!kCompact && n > 0) bar_wait(&bar[1], 0);
    float* kn = R(kKn);
    float* kt1 = R(kKt1);
    float* kt2 = R(kKt2);
    const float* vt = R(kVt);
    const float* mu = R(kMu);
    const float* rlx_r = R(kRelax);
    for (int j = tid; j < na; j += T) {  // the thread that solves slot j later
        const int c = at(j);
        const float rlx = rlx_r[c];
        kn[c] = rlx / kn[c];
        kt1[c] = rlx / kt1[c];
        kt2[c] = rlx / kt2[c];
    }
    for (int it = 0; it < a.iterations; ++it) {
        for (int j = tid; j < na; j += T) {
            const int c = at(j);
            int ia, ib;
            bodies(pk[c], ia, ib);
            const float ac = act[c];
            const Vec3 ra = row3(ra_r, stride, c), rb = row3(rb_r, stride, c);
            const Vec3 nn = row3(n_r, stride, c), u1 = row3(t1_r, stride, c),
                       u2 = row3(t2_r, stride, c);
            const Vec3 va = point_velocity(v, w, NB, ia, ra);
            const Vec3 vb = ib >= 0 ? point_velocity(v, w, NB, ib, rb) : Vec3{0.f, 0.f, 0.f};
            const Vec3 vr{vb.x - va.x, vb.y - va.y, vb.z - va.z};
            const float l0 = ln[c], l1 = lt1[c], l2 = lt2[c];
            float dln = (vt[c] - dot(vr, nn)) * kn[c];
            const float new_ln = fmaxf(l0 + dln, 0.f);
            dln = (new_ln - l0) * ac;
            const float max_f = mu[c] * (l0 + dln);
            const float n1 = fminf(fmaxf(l1 - dot(vr, u1) * kt1[c], -max_f), max_f);
            const float n2 = fminf(fmaxf(l2 - dot(vr, u2) * kt2[c], -max_f), max_f);
            const float d1 = (n1 - l1) * ac;
            const float d2 = (n2 - l2) * ac;
            ln[c] = l0 + dln;
            lt1[c] = l1 + d1;
            lt2[c] = l2 + d2;
            sx[j] = nn.x * dln + u1.x * d1 + u2.x * d2;
            sy[j] = nn.y * dln + u1.y * d1 + u2.y * d2;
            sz[j] = nn.z * dln + u1.z * d1 + u2.z * d2;
        }
        finish_pass(sx, sy, sz, false);
    }

    K2_STAMP(6);
    const size_t o = world * (size_t)C + off;
    if (!kCompact) {
        // the position rows replace the scratch (the bulk copy is ordered
        // after the threads' last use of it); meanwhile the lambdas, now
        // final, are written once, 16 bytes a thread
        if (tid == 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_group(2);
        const int q = n / 4;
        for (int i = tid; i < 3 * q; i += T) {
            const int r = i / q, k = i - r * q;
            float* out = (r == 0 ? a.ln_out : r == 1 ? a.lt1_out : a.lt2_out) + o;
            reinterpret_cast<float4*>(out)[k] = reinterpret_cast<const float4*>(R(kLn + r))[k];
        }
    } else {
        const uint16_t* orig = reinterpret_cast<const uint16_t*>(smem + L.orig);
        for (int j = tid; j < na; j += T) {
            a.ln_out[o + orig[j]] = ln[j];
            a.lt1_out[o + orig[j]] = lt1[j];
            a.lt2_out[o + orig[j]] = lt2[j];
        }
    }

    // split-impulse position projection from dpos = 0, lambda = 0: dpos
    // takes Iw's place, the projection lambda the k_n row, the scratch the
    // k_t1, k_t2 and v_target rows
    float* dp = Iw;
    for (int i = tid; i < 3 * NB; i += T) dp[i] = 0.f;
    if (!kCompact && n > 0) bar_wait(&bar[2], 0);
    __syncthreads();
    const float* e0 = R(kE0);
    const float* rlxp = R(kRelaxP);
    float* klin = R(kKlin);
    float* lam = R(kKn);
    for (int j = tid; j < na; j += T) {  // k_lin becomes relax_p / k_lin
        const int c = at(j);
        klin[c] = rlxp[c] / klin[c];
    }
    float* px = R(kKt1);
    float* py = R(kKt2);
    float* pz = R(kVt);
    for (int it = 0; it < a.position_iterations; ++it) {
        for (int j = tid; j < na; j += T) {
            const int c = at(j);
            int ia, ib;
            bodies(pk[c], ia, ib);
            const Vec3 nn = row3(n_r, stride, c);
            const Vec3 pa{dp[ia], dp[NB + ia], dp[2 * NB + ia]};
            const Vec3 pb = ib >= 0 ? Vec3{dp[ib], dp[NB + ib], dp[2 * NB + ib]} : Vec3{0.f, 0.f, 0.f};
            const Vec3 dd{pb.x - pa.x, pb.y - pa.y, pb.z - pa.z};
            float dlam = (e0[c] - dot(dd, nn)) * klin[c];
            const float l0 = it ? lam[c] : 0.f;
            const float new_lam = fmaxf(l0 + dlam, 0.f);
            dlam = (new_lam - l0) * act[c];
            lam[c] = new_lam;
            px[j] = nn.x * dlam;
            py[j] = nn.y * dlam;
            pz[j] = nn.z * dlam;
        }
        finish_pass(px, py, pz, true);
    }

    K2_STAMP(7);
    if (rank == 0) {
        for (int i = tid; i < 3 * NB; i += T) {
            a.vel_out[bo + i] = v[i];
            a.ang_out[bo + i] = w[i];
            a.dpos_out[bo + i] = dp[i];
        }
    }
    K2_STAMP(8);
    // no CTA moves on while another may still read its partial sums
    if (S > 1) cluster.sync();
}

template <bool kCompact>
__global__ void __launch_bounds__(kMaxThreads, 1) solve_kernel(SolveArgs a) {
    // The kernel after this one may be scheduled once every CTA of this one
    // has started; a kernel that takes a list waits for the one before it to
    // finish (and its writes to show) before it reads the list.
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    if (a.todo_n) asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const int S = kCompact ? 1 : (int)cg::this_cluster().num_blocks();
    const int count = a.todo_n ? *a.todo_n : a.worlds;
    for (int i = blockIdx.x / S; i < count; i += gridDim.x / S)
        solve_world<kCompact>(a, a.todo_n ? (size_t)a.todo_ids[i] : (size_t)i,
                              i != (int)(blockIdx.x / S));
}

constexpr int kMaxDevices = 64;

// the largest carveout, so that several CTAs share an SM where they fit, and
// at least `smem` bytes of dynamic shared memory a block; set on a device
// once, and again when a launch needs more
template <bool kCompact>
cudaError_t configure(size_t smem) {
    static size_t done[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < kMaxDevices && done[dev] >= smem)) return err;
    err = cudaFuncSetAttribute(solve_kernel<kCompact>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(solve_kernel<kCompact>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err == cudaSuccess && dev < kMaxDevices) done[dev] = kMaxSmem;
    return err;
}

// the SMs of the current device (cached)
cudaError_t sm_count(int* nsm) {
    static int known[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices && known[dev] > 0) {
        *nsm = known[dev];
        return cudaSuccess;
    }
    err = cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && dev < kMaxDevices) known[dev] = *nsm;
    return err;
}

template <bool kCompact>
cudaError_t launch(const SolveArgs& a, int W, int cluster, int threads, size_t smem,
                   cudaStream_t stream) {
    cudaError_t err = configure<kCompact>(smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(W * cluster));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    // a kernel that takes a list overlaps its launch with the kernel before
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = a.todo_n ? 1 : 0;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
    err = cudaLaunchKernelEx(&cfg, solve_kernel<kCompact>, a);
    return err != cudaSuccess ? err : cudaGetLastError();
}

bool threads_ok(int t) { return t >= 32 && t <= kMaxThreads && t % 32 == 0; }

}  // namespace

// Shared memory of one CTA: compact != 0 for the compact kernel (stride =
// cap), else the in-place one (stride = share).
extern "C" size_t lumix_solve_contacts_smem(int compact, int nb, int c, int stride) {
    return layout(compact != 0, nb, c, stride).total;
}

// One K2 launch: the compact kernel with capacity cap_a (4 CTAs an SM), then
// with capacity cap_b (3 an SM) on the worlds the first left, then the
// in-place kernel on the worlds left after that (a capacity of 0 skips its
// kernel; with neither, the in-place kernel solves every world). `lists`
// ([2 + 2W] int32) holds the two lists of worlds left: counts, then ids. A
// kernel that takes a list runs one wave of CTAs, each looping over it.
extern "C" int lumix_solve_contacts(
    const int* body_a, const int* body_b, const float* inv_mass, const float* inv_inertia,
    const float* vel, const float* angvel, const float* r_a, const float* r_b, const float* n,
    const float* t1, const float* t2, const float* k_n, const float* k_t1, const float* k_t2,
    const float* v_target, const float* mu, const float* act, const float* relax,
    const float* ln0, const float* lt10, const float* lt20, const float* e0_p,
    const float* relax_p, const float* k_lin, float* vel_out, float* ang_out, float* dpos_out,
    float* ln_out, float* lt1_out, float* lt2_out, int* lists, int W, int NB, int C,
    int iterations, int position_iterations, int cluster, int share, int threads, int cap_a,
    int cap_b, int cap_threads, cudaStream_t stream) {
    if (W <= 0) return 0;
    const size_t smem = layout(false, NB, C, share).total;
    if (NB <= 0 || NB > 65534 || C < 0 || C % 4 || share % 4 || share <= 0 || share > 32764 ||
        cluster < 1 || cluster > kMaxCluster || (size_t)cluster * share < (size_t)C ||
        !threads_ok(threads) || smem > kMaxSmem || (long long)W * cluster > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const int caps[2] = {cap_a, cap_b};
    for (int cap : caps)
        if (cap < 0 || (cap > 0 && (cap > 32764 || C > 65535 || lists == nullptr || !threads_ok(cap_threads) ||
                                    layout(true, NB, C, cap).total > kMaxSmem)))
            return (int)cudaErrorInvalidValue;
    int nsm = 0;
    cudaError_t err = sm_count(&nsm);
    if (err == cudaSuccess && (cap_a > 0 || cap_b > 0))
        err = cudaMemsetAsync(lists, 0, 2 * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
    SolveArgs a{body_a, body_b, inv_mass, inv_inertia, vel, angvel, r_a, r_b, n, t1, t2,
                k_n, k_t1, k_t2, v_target, mu, act, relax, ln0, lt10, lt20, e0_p, relax_p,
                k_lin, vel_out, ang_out, dpos_out, ln_out, lt1_out, lt2_out, nullptr, nullptr,
                nullptr, nullptr, W, NB, C, share, iterations, position_iterations};
    for (int t = 0; t < 2; ++t) {
        if (caps[t] == 0) continue;
        SolveArgs c = a;
        c.stride = caps[t];
        c.left_n = lists + t;
        c.left_ids = lists + 2 + (size_t)t * W;
        err = launch<true>(c, a.todo_n ? std::min(W, 4 * nsm) : W, 1, cap_threads,
                           layout(true, NB, C, caps[t]).total, stream);
        if (err != cudaSuccess) return (int)err;
        a.todo_n = c.left_n;
        a.todo_ids = c.left_ids;
    }
    return (int)launch<false>(a, a.todo_n ? std::min(W, std::max(1, nsm / cluster)) : W, cluster,
                              threads, smem, stream);
}
