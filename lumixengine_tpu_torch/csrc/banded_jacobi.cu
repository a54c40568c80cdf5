// BJ — the banded multi-sweep projected-Jacobi contact solve
// (ops/physics_banded.py::solve_contacts_banded_multi) as a short stream of
// launches over the active contacts only.
//
// Replaces no TPU kernel: the JAX package's banded solve
// (lumixengine_tpu/ops/physics_banded.py::solve_contacts_banded_multi) is
// jnp, which XLA fuses itself; there is no pallas_call to port. It was added
// because the plain version runs each of its iterations x sweeps passes as
// eager torch ops over whole [W, 3, k, K, NB] slot grids, writing every
// intermediate to device memory, while under 1% of the slots hold a contact
// on the 10k-box drop (4 sweeps, k = 4, K = 40, NB = 10,240).
//
// The solve: per sweep s, slot (a, d-1, i) of its grids joins rank i (the
// owner, body order[i]) to rank i+d (body order[i+d]); ground slots (g, i)
// join rank i to the ground. Per-slot constants (arms, tangents, effective
// masses, the degree-scaled relaxation, the restitution target from the
// pre-solve velocities) are fixed; then the warm-start impulses are applied
// sweep by sweep, and `iterations` rounds of one Jacobi pass per sweep run:
// within a pass every slot reads the same velocities, and each body sums
// the impulses of its slots.
//
// Bound on the H100: device memory. A solve must read each slot's active
// flag (1 B), the data of the active slots (point, normal, depth, friction,
// restitution, warm-start lambdas: 48 B), the bodies, and write the three
// lambda grids whole (12 B a slot, 0 where inactive): at the 10k-box drop's
// W=4, 26.2 M slots and ~246 k active contacts, ~0.36 GB, ~0.11 ms at
// 3.35 TB/s (physics_banded.banded_jacobi_bytes). The passes themselves
// touch only the active contacts, a few MB that stay in the 50 MB L2.
//
// The design keeps the work on the active contacts and keeps every
// intermediate of a pass in registers:
//   * masks (one launch a sweep): thread (w, i) packs the active flags of
//     the slots it owns (a side, bit a*K + d-1) and of the slots that name
//     it as partner (b side, slot (a, d-1, i-d)) into bit words, reading the
//     bool grid coalesced (NB innermost), and adds its contact count to its
//     body's degree with an integer atomic (exact, so order-free);
//   * a block scan a (sweep, world) gives each owner the index of its first
//     contact in a compact list (its pairs in bit order, then its ground
//     slots);
//   * consts (one launch a sweep): each owner computes its contacts'
//     constants once into 96-byte records (the first `cap` of each list;
//     a contact past the capacity has its constants recomputed from the
//     grids where it is used, with the same arithmetic) and writes its
//     starting lambdas (the warm start, or 0);
//   * a pass (one launch a sweep pass, iterations x S of them, and one a
//     sweep for the warm start): thread (w, i) reads its body's velocity
//     and, for each contact it owns and each that names it as b, the
//     partner's velocity, the record and the pass's old lambdas, computes
//     the projected update, and sums the impulses in a fixed order: ground,
//     owned pairs, b side. A pair is thus computed twice, by its owner
//     (who alone writes its lambdas) and by its b body, with the same
//     arithmetic, so no impulse goes through memory and no sum through a
//     float atomic: the same inputs give the same bits on every run. The
//     lambdas of pairs ping-pong between two buffers so that the b side
//     reads the old ones; velocities (body order, 32 bytes a body)
//     ping-pong too; ground lambdas are read and written by their owner
//     only, in place;
//   * an epilogue writes the velocities back in the caller's layout.
// Everything runs on the caller's stream; nothing synchronises or
// allocates (the wrapper hands in the outputs and one workspace).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kScanThreads = 1024;
constexpr int kRec = 24;          // floats a record (21 used)
constexpr int kMaxWorlds = 65535;   // a launch's grid.y

// A strided operand: element (w, c, a, d, i) at p + w*w_ + c*c_ + a*a_ + d*d_ + i*i_
// (strides in elements; an axis the operand lacks has stride 0).
struct View {
    const void* p;
    long long w, c, a, d, i;
};

// One sweep's operands (physics_banded.solve_contacts_banded_multi's dict).
struct Sweep {
    View order;                                   // int64 [W, NB]: rank -> body
    View point, normal, depth, active, fric, rest;          // [W, (3,) k, K, NB]
    View g_point, g_normal, g_depth, g_active, g_fric, g_rest;  // [W, (3,) G, NB]
    View warm_p[3];                               // [W, k, K, NB]
    View warm_g[3];                               // [W, G, NB]
    int ground, warm_pairs, warm_ground, pad;
};

// The call, filled by the wrapper (physics_banded._BJCall mirrors it).
struct Call {
    int W, NB, S, k, K, G, iterations, cap;
    int dt_per_world;                                 // 1: dt_view per world; 0: the scalars
    float bias_scale, baumgarte, slop, relaxation;    // bias_scale: baumgarte / dt as float32
    int bias_live;                                    // scalar dt > 0
    View vel, angvel, inv_mass, iiw, pos, dt_view;    // [W, 3, NB] / [W, NB] / [W]
    const Sweep* sweeps;                              // host array of S
    float* vel_out;                                   // [W, 3, NB]
    float* angvel_out;                                // [W, 3, NB]
    float* lam_p[2];                                  // [S, W, k, K, NB, 3] each
    float* lam_g;                                     // [S, W, G, NB, 3]
    void* work;
    long long work_bytes;
    int launches, pad2;
};

// Byte offsets of the workspace's parts.
struct Layout {
    size_t deg, amask, bmask, gmask, off, rec, body, v0, va, vb, total;
};

size_t up256(size_t x) { return (x + 255) & ~(size_t)255; }

Layout layout(int W, int NB, int S, int k, int K, int G, int cap) {
    const size_t wn = (size_t)W * NB, aw = ((size_t)k * K + 31) / 32, gw = ((size_t)G + 31) / 32;
    Layout l;
    size_t at = 0;
    l.deg = at;   at = up256(at + wn * 4);
    l.amask = at; at = up256(at + (size_t)S * wn * aw * 4);
    l.bmask = at; at = up256(at + (size_t)S * wn * aw * 4);
    l.gmask = at; at = up256(at + (size_t)S * wn * gw * 4);
    l.off = at;   at = up256(at + (size_t)S * wn * 4);
    l.rec = at;   at = up256(at + (size_t)S * W * cap * kRec * 4);
    l.body = at;  at = up256(at + wn * 8 * 4);
    l.v0 = at;    at = up256(at + wn * 8 * 4);
    l.va = at;    at = up256(at + wn * 8 * 4);
    l.vb = at;    at = up256(at + wn * 8 * 4);
    l.total = at;
    return l;
}

// What every kernel reads: sizes, scalars and the workspace's parts.
struct Ctx {
    int W, NB, k, K, G, AW, GW, cap;
    int dt_per_world, dt_live;
    float dt_scale, baumgarte, slop, relaxation;
    View dt_view;
    int* deg;            // [W, NB] contacts a body over every sweep
    uint32_t* amask;     // [S, W, AW, NB] owned pair slots (bit a*K + d-1)
    uint32_t* bmask;     // [S, W, AW, NB] pair slots naming the rank as b
    uint32_t* gmask;     // [S, W, GW, NB] active ground slots
    int* off;            // [S, W, NB] first compact index an owner's contacts take
    float* rec;          // [S, W, cap, kRec] contact constants
    float* body;         // [W, NB, 8] pos xyz, inv mass, iiw xyz, degree
    float* v0;           // [W, NB, 8] pre-solve velocity xyz, 0, angular xyz, 0
    float* lam_g;        // [S, W, G, NB, 3]
};

__device__ __forceinline__ long long at(const View& v, long long w, long long c, long long a,
                                        long long d, long long i) {
    return w * v.w + c * v.c + a * v.a + d * v.d + i * v.i;
}
__device__ __forceinline__ float ldf(const View& v, int w, int c, int a, int d, int i) {
    return static_cast<const float*>(v.p)[at(v, w, c, a, d, i)];
}
__device__ __forceinline__ bool ldb(const View& v, int w, int a, int d, int i) {
    return static_cast<const unsigned char*>(v.p)[at(v, w, 0, a, d, i)] != 0;
}
__device__ __forceinline__ int rank_body(const View& order, int w, int i) {
    return (int)static_cast<const long long*>(order.p)[at(order, w, 0, 0, 0, i)];
}
__device__ __forceinline__ float3 ld3(const View& v, int w, int a, int d, int i) {
    return make_float3(ldf(v, w, 0, a, d, i), ldf(v, w, 1, a, d, i), ldf(v, w, 2, a, d, i));
}

__device__ __forceinline__ float3 add3(float3 a, float3 b) {
    return make_float3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ float3 sub3(float3 a, float3 b) {
    return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ float3 scl3(float3 a, float s) {
    return make_float3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float3 mul3(float3 a, float3 b) {
    return make_float3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ float dot3(float3 a, float3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
    return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

struct Body {
    float3 pos;
    float im;
    float3 iiw;
    float deg;
};
struct Vel {
    float3 v, w;
};

// Body b of world w (b < 0: the zero body a pair past the last rank meets).
__device__ __forceinline__ Body load_body(const Ctx& c, int w, int b) {
    if (b < 0) return Body{make_float3(0.f, 0.f, 0.f), 0.f, make_float3(0.f, 0.f, 0.f), 0.f};
    const float4* p = reinterpret_cast<const float4*>(c.body + ((long long)w * c.NB + b) * 8);
    const float4 x = p[0], y = p[1];
    return Body{make_float3(x.x, x.y, x.z), x.w, make_float3(y.x, y.y, y.z), y.w};
}
__device__ __forceinline__ Vel load_vel(const float* V, int NB, int w, int b) {
    if (b < 0) return Vel{make_float3(0.f, 0.f, 0.f), make_float3(0.f, 0.f, 0.f)};
    const float4* p = reinterpret_cast<const float4*>(V + ((long long)w * NB + b) * 8);
    const float4 x = p[0], y = p[1];
    return Vel{make_float3(x.x, x.y, x.z), make_float3(y.x, y.y, y.z)};
}
__device__ __forceinline__ void store_vel(float* V, int NB, int w, int b, float3 v, float3 a) {
    float4* p = reinterpret_cast<float4*>(V + ((long long)w * NB + b) * 8);
    p[0] = make_float4(v.x, v.y, v.z, 0.f);
    p[1] = make_float4(a.x, a.y, a.z, 0.f);
}

// A contact's constants (a ground contact leaves rb at 0).
struct Rec {
    float3 ra, rb, n, t1, t2;
    float kn, kt1, kt2, relax, target, fric;
};

__device__ __forceinline__ void store_rec(float* p, const Rec& r) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(r.ra.x, r.ra.y, r.ra.z, r.rb.x);
    q[1] = make_float4(r.rb.y, r.rb.z, r.n.x, r.n.y);
    q[2] = make_float4(r.n.z, r.t1.x, r.t1.y, r.t1.z);
    q[3] = make_float4(r.t2.x, r.t2.y, r.t2.z, r.kn);
    q[4] = make_float4(r.kt1, r.kt2, r.relax, r.target);
    q[5] = make_float4(r.fric, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ Rec load_rec(const float* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 a = q[0], b = q[1], e = q[2], f = q[3], g = q[4], h = q[5];
    Rec r;
    r.ra = make_float3(a.x, a.y, a.z);
    r.rb = make_float3(a.w, b.x, b.y);
    r.n = make_float3(b.z, b.w, e.x);
    r.t1 = make_float3(e.y, e.z, e.w);
    r.t2 = make_float3(f.x, f.y, f.z);
    r.kn = f.w;
    r.kt1 = g.x;
    r.kt2 = g.y;
    r.relax = g.z;
    r.target = g.w;
    r.fric = h.x;
    return r;
}

// physics_banded._tangents0
__device__ __forceinline__ void tangents(float3 n, float3& t1, float3& t2) {
    const bool use_x = fabsf(n.x) < 0.9f;
    const float3 h = make_float3(use_x ? 1.f : 0.f, use_x ? 0.f : 1.f, 0.f);
    t1 = cross3(n, h);
    t1 = scl3(t1, rsqrtf(fmaxf(dot3(t1, t1), 1e-12f)));
    t2 = cross3(n, t1);
}

// physics_banded._ang0: d . ((I^-1 (r x d)) x r)
__device__ __forceinline__ float ang(float3 r, float3 d, float3 ii) {
    return dot3(cross3(mul3(ii, cross3(r, d)), r), d);
}

// physics_ops.baumgarte_bias, then the restitution target.
__device__ __forceinline__ float target(const Ctx& c, int w, float depth, float rest, float vn0) {
    float scale = c.dt_scale;
    bool live = c.dt_live != 0;
    if (c.dt_per_world) {
        const float dt = ldf(c.dt_view, w, 0, 0, 0, 0);
        live = dt > 0.f;
        scale = c.baumgarte / (live ? dt : 1.f);
    }
    const float bias = live ? scale * fmaxf(depth - c.slop, 0.f) : 0.f;
    return fmaxf(bias, vn0 < -0.5f ? -rest * vn0 : 0.f);
}

// The constants of pair slot (a, d-1, i) of a sweep (world w).
__device__ __forceinline__ Rec pair_rec(const Ctx& c, const Sweep& sw, int w, int a, int d, int i) {
    const int ia = rank_body(sw.order, w, i);
    const int ib = i + d < c.NB ? rank_body(sw.order, w, i + d) : -1;
    const Body A = load_body(c, w, ia), B = load_body(c, w, ib);
    const float3 point = ld3(sw.point, w, a, d - 1, i);
    Rec r;
    r.n = ld3(sw.normal, w, a, d - 1, i);
    r.ra = sub3(point, A.pos);
    r.rb = sub3(point, B.pos);
    tangents(r.n, r.t1, r.t2);
    const float imab = A.im + B.im;
    r.kn = fmaxf(imab + ang(r.ra, r.n, A.iiw) + ang(r.rb, r.n, B.iiw), 1e-9f);
    r.kt1 = fmaxf(imab + ang(r.ra, r.t1, A.iiw) + ang(r.rb, r.t1, B.iiw), 1e-9f);
    r.kt2 = fmaxf(imab + ang(r.ra, r.t2, A.iiw) + ang(r.rb, r.t2, B.iiw), 1e-9f);
    r.relax = fminf(1.6f / fmaxf(fmaxf(A.deg, B.deg), 1.f), c.relaxation);
    r.fric = ldf(sw.fric, w, 0, a, d - 1, i);
    const Vel VA = load_vel(c.v0, c.NB, w, ia), VB = load_vel(c.v0, c.NB, w, ib);
    const float3 vr0 = sub3(add3(VB.v, cross3(VB.w, r.rb)), add3(VA.v, cross3(VA.w, r.ra)));
    r.target = target(c, w, ldf(sw.depth, w, 0, a, d - 1, i), ldf(sw.rest, w, 0, a, d - 1, i),
                      dot3(vr0, r.n));
    return r;
}

// The constants of ground slot (g, i) of a sweep (world w).
__device__ __forceinline__ Rec ground_rec(const Ctx& c, const Sweep& sw, int w, int g, int i) {
    const int ia = rank_body(sw.order, w, i);
    const Body A = load_body(c, w, ia);
    const float3 point = make_float3(ldf(sw.g_point, w, 0, g, 0, i), ldf(sw.g_point, w, 1, g, 0, i),
                                     ldf(sw.g_point, w, 2, g, 0, i));
    Rec r;
    r.n = make_float3(ldf(sw.g_normal, w, 0, g, 0, i), ldf(sw.g_normal, w, 1, g, 0, i),
                      ldf(sw.g_normal, w, 2, g, 0, i));
    r.ra = sub3(point, A.pos);
    r.rb = make_float3(0.f, 0.f, 0.f);
    tangents(r.n, r.t1, r.t2);
    r.kn = fmaxf(A.im + ang(r.ra, r.n, A.iiw), 1e-9f);
    r.kt1 = fmaxf(A.im + ang(r.ra, r.t1, A.iiw), 1e-9f);
    r.kt2 = fmaxf(A.im + ang(r.ra, r.t2, A.iiw), 1e-9f);
    r.relax = fminf(1.6f / fmaxf(A.deg, 1.f), c.relaxation);
    r.fric = ldf(sw.g_fric, w, 0, g, 0, i);
    const Vel VA = load_vel(c.v0, c.NB, w, ia);
    const float3 vr0 = scl3(add3(VA.v, cross3(VA.w, r.ra)), -1.f);
    r.target = target(c, w, ldf(sw.g_depth, w, 0, g, 0, i), ldf(sw.g_rest, w, 0, g, 0, i),
                      dot3(vr0, r.n));
    return r;
}

// One projected-Jacobi update of a contact (physics_banded's pgs): the
// lambda increments for relative velocity vr and old lambdas l.
__device__ __forceinline__ float3 pgs(const Rec& r, float3 vr, float3 l) {
    const float vn = dot3(vr, r.n);
    float dln = (r.target - vn) / r.kn * r.relax;
    dln = fmaxf(l.x + dln, 0.f) - l.x;
    const float max_f = r.fric * (l.x + dln);
    const float n1 = fminf(fmaxf(l.y + (-dot3(vr, r.t1) / r.kt1) * r.relax, -max_f), max_f);
    const float n2 = fminf(fmaxf(l.z + (-dot3(vr, r.t2) / r.kt2) * r.relax, -max_f), max_f);
    return make_float3(dln, n1 - l.y, n2 - l.z);
}
__device__ __forceinline__ float3 impulse(const Rec& r, float3 dl) {
    return add3(add3(scl3(r.n, dl.x), scl3(r.t1, dl.y)), scl3(r.t2, dl.z));
}
__device__ __forceinline__ float3 ld_lam(const float* p) { return make_float3(p[0], p[1], p[2]); }
__device__ __forceinline__ void st_lam(float* p, float3 l) {
    p[0] = l.x;
    p[1] = l.y;
    p[2] = l.z;
}

// Thread (w, i) of a sweep: pack the rank's slot masks, count its contacts.
__global__ void __launch_bounds__(kThreads) mask_kernel(Ctx c, Sweep sw, int s) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= c.NB) return;
    const int NB = c.NB, K = c.K, q_end = c.k * c.K;
    const int w = blockIdx.y;
    const long long seg = (long long)s * c.W + w;
    uint32_t* am = c.amask + seg * c.AW * NB + i;
    uint32_t* bm = c.bmask + seg * c.AW * NB + i;
    int n_own = 0, n_b = 0;
    for (int wd = 0; wd < c.AW; ++wd) {
        uint32_t ma = 0, mb = 0;
        for (int bit = 0; bit < 32; ++bit) {
            const int q = wd * 32 + bit;
            if (q >= q_end) break;
            const int a = q / K, d = q - a * K + 1;
            if (ldb(sw.active, w, a, d - 1, i)) ma |= 1u << bit;
            if (i >= d && ldb(sw.active, w, a, d - 1, i - d)) mb |= 1u << bit;
        }
        am[(long long)wd * NB] = ma;
        bm[(long long)wd * NB] = mb;
        n_own += __popc(ma);
        n_b += __popc(mb);
    }
    if (sw.ground) {
        uint32_t* gm = c.gmask + seg * c.GW * NB + i;
        for (int wd = 0; wd < c.GW; ++wd) {
            uint32_t m = 0;
            for (int bit = 0; bit < 32 && wd * 32 + bit < c.G; ++bit)
                if (ldb(sw.g_active, w, wd * 32 + bit, 0, i)) m |= 1u << bit;
            gm[(long long)wd * NB] = m;
            n_own += __popc(m);
        }
    }
    c.off[seg * NB + i] = n_own;
    atomicAdd(&c.deg[(long long)w * NB + rank_body(sw.order, w, i)], n_own + n_b);
}

// Block per (sweep, world): the owners' contact counts -> exclusive offsets.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(int* off, int NB) {
    __shared__ int sums[kScanThreads / 32];
    int* o = off + (long long)blockIdx.x * NB;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int carry = 0;
    for (int base = 0; base < NB; base += kScanThreads) {
        const int i = base + threadIdx.x;
        const int v = i < NB ? o[i] : 0;
        int x = v;
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) sums[warp] = x;
        __syncthreads();
        if (warp == 0) {
            int t = sums[lane];
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(0xFFFFFFFFu, t, d);
                if (lane >= d) t += y;
            }
            sums[lane] = t;
        }
        __syncthreads();
        if (i < NB) o[i] = carry + x - v + (warp ? sums[warp - 1] : 0);
        carry += sums[kScanThreads / 32 - 1];
        __syncthreads();
    }
}

// Thread (w, b): the body table and the pre-solve velocities, body order.
__global__ void __launch_bounds__(kThreads) body_kernel(Ctx c, View vel, View ang_, View im,
                                                        View iiw, View pos) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b >= c.NB) return;
    const int w = blockIdx.y;
    float4* p = reinterpret_cast<float4*>(c.body + ((long long)w * c.NB + b) * 8);
    p[0] = make_float4(ldf(pos, w, 0, 0, 0, b), ldf(pos, w, 1, 0, 0, b), ldf(pos, w, 2, 0, 0, b),
                       ldf(im, w, 0, 0, 0, b));
    p[1] = make_float4(ldf(iiw, w, 0, 0, 0, b), ldf(iiw, w, 1, 0, 0, b), ldf(iiw, w, 2, 0, 0, b),
                       (float)c.deg[(long long)w * c.NB + b]);
    store_vel(c.v0, c.NB, w, b,
              make_float3(ldf(vel, w, 0, 0, 0, b), ldf(vel, w, 1, 0, 0, b), ldf(vel, w, 2, 0, 0, b)),
              make_float3(ldf(ang_, w, 0, 0, 0, b), ldf(ang_, w, 1, 0, 0, b),
                          ldf(ang_, w, 2, 0, 0, b)));
}

// Thread (w, i) of a sweep: its contacts' records and starting lambdas.
__global__ void __launch_bounds__(kThreads) consts_kernel(Ctx c, Sweep sw, int s, float* lam0) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= c.NB) return;
    const int NB = c.NB, K = c.K;
    const int w = blockIdx.y;
    const long long seg = (long long)s * c.W + w;
    const uint32_t* am = c.amask + seg * c.AW * NB + i;
    float* rec = c.rec + seg * c.cap * kRec;
    float* lam = lam0 + seg * c.k * K * NB * 3;
    int idx = c.off[seg * NB + i];
    for (int wd = 0; wd < c.AW; ++wd) {
        for (uint32_t m = am[(long long)wd * NB]; m; m &= m - 1) {
            const int q = wd * 32 + __ffs(m) - 1;
            const int a = q / K, d = q - a * K + 1;
            if (idx < c.cap) store_rec(rec + (long long)idx * kRec, pair_rec(c, sw, w, a, d, i));
            ++idx;
            float3 l = make_float3(0.f, 0.f, 0.f);
            if (sw.warm_pairs)
                l = make_float3(ldf(sw.warm_p[0], w, 0, a, d - 1, i),
                                ldf(sw.warm_p[1], w, 0, a, d - 1, i),
                                ldf(sw.warm_p[2], w, 0, a, d - 1, i));
            st_lam(lam + ((long long)q * NB + i) * 3, l);
        }
    }
    if (!sw.ground) return;
    const uint32_t* gm = c.gmask + seg * c.GW * NB + i;
    float* lg = c.lam_g + seg * c.G * NB * 3;
    for (int wd = 0; wd < c.GW; ++wd) {
        for (uint32_t m = gm[(long long)wd * NB]; m; m &= m - 1) {
            const int g = wd * 32 + __ffs(m) - 1;
            if (idx < c.cap) store_rec(rec + (long long)idx * kRec, ground_rec(c, sw, w, g, i));
            ++idx;
            float3 l = make_float3(0.f, 0.f, 0.f);
            if (sw.warm_ground)
                l = make_float3(ldf(sw.warm_g[0], w, 0, g, 0, i), ldf(sw.warm_g[1], w, 0, g, 0, i),
                                ldf(sw.warm_g[2], w, 0, g, 0, i));
            st_lam(lg + ((long long)g * NB + i) * 3, l);
        }
    }
}

// Thread (w, i) of a sweep: one Jacobi pass (kWarm: the warm-start impulses
// of lam_cur instead), velocities vcur -> vnext in body order.
template <bool kWarm>
__global__ void __launch_bounds__(kThreads) pass_kernel(Ctx c, Sweep sw, int s, const float* vcur,
                                                        float* vnext, const float* lam_cur,
                                                        float* lam_next) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= c.NB) return;
    const int NB = c.NB, K = c.K;
    const int w = blockIdx.y;
    const long long seg = (long long)s * c.W + w;
    const uint32_t* am = c.amask + seg * c.AW * NB;
    const uint32_t* bm = c.bmask + seg * c.AW * NB + i;
    const int* off = c.off + seg * NB;
    const float* rec = c.rec + seg * c.cap * kRec;
    const long long lam_seg = seg * c.k * K * NB * 3;
    const int b = rank_body(sw.order, w, i);
    const Vel V = load_vel(vcur, NB, w, b);
    float3 av = make_float3(0.f, 0.f, 0.f), aw = make_float3(0.f, 0.f, 0.f);
    int idx = off[i];
    int own_pairs = 0;
    for (int wd = 0; wd < c.AW; ++wd) own_pairs += __popc(am[(long long)wd * NB + i]);
    // ground slots (owned; records after the pairs')
    if (sw.ground) {
        const uint32_t* gm = c.gmask + seg * c.GW * NB + i;
        float* lg = c.lam_g + seg * c.G * NB * 3;
        int gidx = idx + own_pairs;
        for (int wd = 0; wd < c.GW; ++wd) {
            for (uint32_t m = gm[(long long)wd * NB]; m; m &= m - 1) {
                const int g = wd * 32 + __ffs(m) - 1;
                const Rec r = gidx < c.cap ? load_rec(rec + (long long)gidx * kRec)
                                           : ground_rec(c, sw, w, g, i);
                ++gidx;
                float* lp = lg + ((long long)g * NB + i) * 3;
                const float3 l = ld_lam(lp);
                float3 imp;
                if (kWarm) {
                    imp = impulse(r, l);
                } else {
                    const float3 vr = scl3(add3(V.v, cross3(V.w, r.ra)), -1.f);
                    const float3 dl = pgs(r, vr, l);
                    st_lam(lp, add3(l, dl));
                    imp = impulse(r, dl);
                }
                av = sub3(av, imp);
                aw = sub3(aw, cross3(r.ra, imp));
            }
        }
    }
    // pairs this rank owns (a side)
    for (int wd = 0; wd < c.AW; ++wd) {
        for (uint32_t m = am[(long long)wd * NB + i]; m; m &= m - 1) {
            const int q = wd * 32 + __ffs(m) - 1;
            const int a = q / K, d = q - a * K + 1;
            const Rec r = idx < c.cap ? load_rec(rec + (long long)idx * kRec)
                                      : pair_rec(c, sw, w, a, d, i);
            ++idx;
            const long long sl = lam_seg + ((long long)q * NB + i) * 3;
            const float3 l = ld_lam(lam_cur + sl);
            float3 imp;
            if (kWarm) {
                imp = impulse(r, l);
            } else {
                const int pb = i + d < NB ? rank_body(sw.order, w, i + d) : -1;
                const Vel P = load_vel(vcur, NB, w, pb);
                const float3 vr = sub3(add3(P.v, cross3(P.w, r.rb)), add3(V.v, cross3(V.w, r.ra)));
                const float3 dl = pgs(r, vr, l);
                st_lam(lam_next + sl, add3(l, dl));
                imp = impulse(r, dl);
            }
            av = sub3(av, imp);
            aw = sub3(aw, cross3(r.ra, imp));
        }
    }
    // pairs that name this rank as b: the owner's update, recomputed
    for (int wd = 0; wd < c.AW; ++wd) {
        for (uint32_t m = bm[(long long)wd * NB]; m; m &= m - 1) {
            const int q = wd * 32 + __ffs(m) - 1;
            const int a = q / K, d = q - a * K + 1, io = i - d;
            int ridx = off[io];
            for (int x = 0; x < wd; ++x) ridx += __popc(am[(long long)x * NB + io]);
            ridx += __popc(am[(long long)wd * NB + io] & ((1u << (q & 31)) - 1u));
            const Rec r = ridx < c.cap ? load_rec(rec + (long long)ridx * kRec)
                                       : pair_rec(c, sw, w, a, d, io);
            const float3 l = ld_lam(lam_cur + lam_seg + ((long long)q * NB + io) * 3);
            float3 imp;
            if (kWarm) {
                imp = impulse(r, l);
            } else {
                const Vel O = load_vel(vcur, NB, w, rank_body(sw.order, w, io));
                const float3 vr = sub3(add3(V.v, cross3(V.w, r.rb)), add3(O.v, cross3(O.w, r.ra)));
                imp = impulse(r, pgs(r, vr, l));
            }
            av = add3(av, imp);
            aw = add3(aw, cross3(r.rb, imp));
        }
    }
    const Body me = load_body(c, w, b);
    store_vel(vnext, NB, w, b, add3(V.v, scl3(av, me.im)), add3(V.w, mul3(aw, me.iiw)));
}

// Thread (w, b): the final velocities in the caller's [W, 3, NB] layout.
__global__ void __launch_bounds__(kThreads) out_kernel(Ctx c, const float* V, float* vel,
                                                       float* ang_) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b >= c.NB) return;
    const int w = blockIdx.y;
    const Vel x = load_vel(V, c.NB, w, b);
    float* v = vel + (long long)w * 3 * c.NB + b;
    float* a = ang_ + (long long)w * 3 * c.NB + b;
    v[0] = x.v.x;
    v[c.NB] = x.v.y;
    v[2 * c.NB] = x.v.z;
    a[0] = x.w.x;
    a[c.NB] = x.w.y;
    a[2 * c.NB] = x.w.z;
}

}  // namespace

// Sizes the wrapper checks its mirror of the structures against:
// sizeof(View), sizeof(Sweep), sizeof(Call), offsetof(Call, launches).
extern "C" void lumix_banded_jacobi_abi(long long* out) {
    out[0] = (long long)sizeof(View);
    out[1] = (long long)sizeof(Sweep);
    out[2] = (long long)sizeof(Call);
    out[3] = (long long)offsetof(Call, launches);
}

extern "C" long long lumix_banded_jacobi_workspace(int W, int NB, int S, int k, int K, int G,
                                                   int cap) {
    return (long long)layout(W, NB, S, k, K, G, cap).total;
}

// The whole solve on `stream` (call_: a Call); call->launches gets the
// kernels launched.
extern "C" int lumix_banded_jacobi(void* call_, cudaStream_t stream) {
    Call* call = static_cast<Call*>(call_);
    call->launches = 0;
    const int W = call->W, NB = call->NB, S = call->S;
    if (W <= 0 || NB <= 0 || S <= 0) return 0;
    if (W > kMaxWorlds) return (int)cudaErrorInvalidValue;
    const Layout l = layout(W, NB, S, call->k, call->K, call->G, call->cap);
    if ((long long)l.total > call->work_bytes) return (int)cudaErrorInvalidValue;
    char* work = static_cast<char*>(call->work);
    Ctx c;
    c.W = W;
    c.NB = NB;
    c.k = call->k;
    c.K = call->K;
    c.G = call->G;
    c.AW = (call->k * call->K + 31) / 32;
    c.GW = (call->G + 31) / 32;
    c.cap = call->cap;
    c.dt_per_world = call->dt_per_world;
    c.dt_live = call->bias_live;
    c.dt_scale = call->bias_scale;
    c.baumgarte = call->baumgarte;
    c.slop = call->slop;
    c.relaxation = call->relaxation;
    c.dt_view = call->dt_view;
    c.deg = reinterpret_cast<int*>(work + l.deg);
    c.amask = reinterpret_cast<uint32_t*>(work + l.amask);
    c.bmask = reinterpret_cast<uint32_t*>(work + l.bmask);
    c.gmask = reinterpret_cast<uint32_t*>(work + l.gmask);
    c.off = reinterpret_cast<int*>(work + l.off);
    c.rec = reinterpret_cast<float*>(work + l.rec);
    c.body = reinterpret_cast<float*>(work + l.body);
    c.v0 = reinterpret_cast<float*>(work + l.v0);
    c.lam_g = call->lam_g;
    float* va = reinterpret_cast<float*>(work + l.va);
    float* vb = reinterpret_cast<float*>(work + l.vb);
    const dim3 grid((NB + kThreads - 1) / kThreads, W);
    const int its = call->iterations;
    cudaError_t err;
#define LUMIX_BJ_CHECK()                                  \
    do {                                                  \
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err; \
        ++call->launches;                                 \
    } while (0)

    // zero what is summed into, and the lambda buffer the last pass leaves
    // (its inactive slots are the result's zeros)
    const size_t lam_p_bytes = (size_t)S * W * call->k * call->K * NB * 3 * 4;
    if ((err = cudaMemsetAsync(c.deg, 0, (size_t)W * NB * 4, stream)) != cudaSuccess) return (int)err;
    if (lam_p_bytes &&
        (err = cudaMemsetAsync(call->lam_p[its & 1], 0, lam_p_bytes, stream)) != cudaSuccess)
        return (int)err;
    if (call->lam_g && (err = cudaMemsetAsync(call->lam_g, 0, (size_t)S * W * call->G * NB * 3 * 4,
                                              stream)) != cudaSuccess)
        return (int)err;

    for (int s = 0; s < S; ++s) {
        mask_kernel<<<grid, kThreads, 0, stream>>>(c, call->sweeps[s], s);
        LUMIX_BJ_CHECK();
    }
    scan_kernel<<<S * W, kScanThreads, 0, stream>>>(c.off, NB);
    LUMIX_BJ_CHECK();
    body_kernel<<<grid, kThreads, 0, stream>>>(c, call->vel, call->angvel, call->inv_mass, call->iiw,
                                              call->pos);
    LUMIX_BJ_CHECK();
    for (int s = 0; s < S; ++s) {
        consts_kernel<<<grid, kThreads, 0, stream>>>(c, call->sweeps[s], s, call->lam_p[0]);
        LUMIX_BJ_CHECK();
    }
    const float* cur = c.v0;
    float* nxt = va;
    for (int s = 0; s < S; ++s) {
        const Sweep& sw = call->sweeps[s];
        if (!sw.warm_pairs && !(sw.ground && sw.warm_ground)) continue;
        pass_kernel<true><<<grid, kThreads, 0, stream>>>(c, sw, s, cur, nxt, call->lam_p[0], nullptr);
        LUMIX_BJ_CHECK();
        cur = nxt;
        nxt = nxt == va ? vb : va;
    }
    for (int it = 0; it < its; ++it) {
        for (int s = 0; s < S; ++s) {
            pass_kernel<false><<<grid, kThreads, 0, stream>>>(c, call->sweeps[s], s, cur, nxt,
                                                              call->lam_p[it & 1],
                                                              call->lam_p[(it + 1) & 1]);
            LUMIX_BJ_CHECK();
            cur = nxt;
            nxt = nxt == va ? vb : va;
        }
    }
    out_kernel<<<grid, kThreads, 0, stream>>>(c, cur, call->vel_out, call->angvel_out);
    LUMIX_BJ_CHECK();
#undef LUMIX_BJ_CHECK
    return 0;
}
