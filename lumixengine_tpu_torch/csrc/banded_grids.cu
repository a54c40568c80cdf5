// BG — the banded contact stage (ops/physics_banded.py::banded_sweeps): every
// sweep's grids in one launch that runs the narrowphase only on the slots
// whose masks pass.
//
// Replaces no TPU kernel: the JAX package's stage
// (lumixengine_tpu/ops/physics_banded.py's sweeps in the banded branch) is
// jnp, which XLA fuses itself; there is no pallas_call to port. It was added
// because the plain version runs the whole analytic narrowphase
// (physics_ops.pair_contacts_from_data: both sphere-box mirrors, the box-box
// SAT over 6 axes with 8 corners a box, a stable sort of 8 corners a pair) as
// eager torch ops over every one of a sweep's W x K x NB banded slots, and only
// then ANDs the masks, while about 1% of the slots hold a contact on the
// 10k-box drop (4 sweeps, k = 4, K = 40, NB = 10,240).
//
// The stage: per sweep s, slot (a, d-1, i) joins rank i (body order[i]) to
// rank i+d. A slot is a candidate when i+d is a rank, the two AABBs overlap on
// all 3 axes, the layer matrix lets the two layers collide, one of the bodies
// is dynamic, both are occupied and, for s > 0, no earlier sweep's window
// holds the pair (|rank_e(a) - rank_e(b)| <= K). A candidate's point, normal,
// depth and raw flag are the narrowphase's (a pair that holds a hull takes
// the polytope grids the wrapper hands in); its flag is the raw flag. Every
// other slot is inactive with zeros. Per slot besides: friction
// sqrt(max(f_a f_b, 0)), restitution max(r_a, r_b) and, given last frame's
// carry, the warm-start match of physics_banded.match_warm_lams: gathers and
// compares, exact on every slot. Sweep 0 takes the ground stream into rank
// space. Per world: the window certificate and the active count.
//
// Bound on the H100: device memory. The stage must write its grids whole:
// per slot point and normal (24 B at k = 1), depth (4), flag (1), warm
// lambdas (12), and per (d, i) friction and restitution; it reads body tables
// that fit in L2. At the box drop's W=4 that is ~1.4 GB, ~0.42 ms at
// 3.35 TB/s (physics_banded.banded_grids_bytes).
//
// The design:
//   * one launch a sweep, blocks of kThreads ranks of one world, and one
//     memset a call for the per-world counters;
//   * a block gathers the rows of its ranks and of the K+1 ranks after them
//     through the sweep's order into shared memory (position, rotation, half
//     extents, radius, AABB, friction, restitution, shape and flags, layer,
//     the earlier sweeps' ranks, last frame's rank, the column key): no
//     rank-ordered copy goes through device memory;
//   * thread (w, i) keeps its own row in registers and walks d = 1..K over
//     the partner rows in shared memory: the candidate test first, and the
//     narrowphase only for a candidate, written in plain's order of
//     operations with no contraction to FMA (__fmul_rn, __fadd_rn), so that
//     its decisions are plain's; the k deepest of the incident box's 8
//     corners by a stable selection in registers (ties to the lower corner,
//     as physics_ops.top_k_stable). Every output is stored coalesced along NB;
//   * the counts are summed per warp and added with integer atomics: exact
//     and independent of order.
// Everything runs on the caller's stream; nothing synchronises or allocates
// (the wrapper hands in every output).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWorlds = 65535;   // a launch's grid.y
constexpr int kMaxSweeps = 5;
constexpr int kMaxPoints = 8;       // a box has 8 corners
constexpr int kRow = 27;            // words of a rank's row in the tile (odd: no bank conflict)

// a row's words
constexpr int R_POS = 0, R_ROT = 3, R_HE = 7, R_RAD = 10, R_MN = 11, R_MX = 14, R_FRIC = 17,
              R_REST = 18, R_FLAGS = 19, R_LAYER = 20, R_PREV = 21, R_RANK = 22, R_COL = 26;
// R_FLAGS: the shape in the low byte, then these bits
constexpr int F_DYN = 1 << 8, F_OCC = 1 << 9, F_CVX = 1 << 10;
constexpr int kBox = 1, kCapsule = 2;

// A strided operand: element (w, c, a, d, i) at p + w*w_ + c*c_ + a*a_ + d*d_ + i*i_
// (strides in elements; an axis the operand lacks has stride 0).
struct View {
    const void* p;
    long long w, c, a, d, i;
};

// One sweep's operands and outputs (physics_banded._BGSweep mirrors it).
struct Sweep {
    View order;                                     // int64 [W, NB]: rank -> body
    View col;                                       // int32 [W, NB] column key, body order (p null: none)
    View prev_lam;                                  // float [W, 3, k, K, NB]: last frame's lambdas
    View prev_rank;                                 // int32 [W, NB]: last frame's body -> rank
    View h_point, h_normal, h_depth, h_active;      // hull grids [W, (3,) k, K, NB], rank space
    float* point;                                   // [W, 3, k, K, NB]
    float* normal;                                  // [W, 3, k, K, NB]
    float* depth;                                   // [W, k, K, NB]
    unsigned char* active;                          // [W, k, K, NB]
    float* fric;                                    // [W, K, NB]
    float* rest;                                    // [W, K, NB]
    float* warm;                                    // [W, 3, k, K, NB]
    int window_miss;                                // 1: a lone classic sweep's x-window certificate
    int pad;
};

// The call (physics_banded._BGCall mirrors it).
struct Call {
    int W, NB, S, k, K, G, L;
    int any_caps, warm, ground, hulls, layers, g_rest_on;
    float g_fric, g_rest;                           // the ground's friction; its restitution floor
    int pad0;
    View pos, rot, mn, mx;                          // [W, 3|4, NB], body order
    View shape, radius, he, dyn, occ, fric, rest, layer, cvx;   // [W, (3,) NB], body order
    View matrix;                                    // bool [L * L]
    View rank[kMaxSweeps];                          // int32 [W, NB]: body -> rank of each sweep
    View gc_point, gc_normal, gc_depth, gc_active;  // the ground stream [W, (3,) G, NB], body order
    View carry_g;                                   // float [W, 3, G, NB]: last frame's ground lambdas
    float* g_point;                                 // [W, 3, G, NB]
    float* g_normal;                                // [W, 3, G, NB]
    float* g_depth;                                 // [W, G, NB]
    unsigned char* g_active;                        // [W, G, NB]
    float* g_fric_out;                              // [W, NB]
    float* g_rest_out;                              // [W, NB]
    float* g_warm;                                  // [W, 3, G, NB]
    int* counts;                                    // [2, W]: window certificate, active contacts
    int launches, pad1;
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
__device__ __forceinline__ int ldi(const View& v, int w, int i) {
    return static_cast<const int*>(v.p)[at(v, w, 0, 0, 0, i)];
}
__device__ __forceinline__ int ldl(const View& v, int w, int i) {
    return (int)static_cast<const long long*>(v.p)[at(v, w, 0, 0, 0, i)];
}

// float arithmetic rounded op by op, as the plain version's eager ops round it
__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }

struct V3 {
    float x, y, z;
};
__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(fa(a.x, b.x), fa(a.y, b.y), fa(a.z, b.z)); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(fs(a.x, b.x), fs(a.y, b.y), fs(a.z, b.z)); }
__device__ __forceinline__ V3 scl(V3 a, float s) { return v3(fm(a.x, s), fm(a.y, s), fm(a.z, s)); }
__device__ __forceinline__ V3 quo(V3 a, float s) {
    return v3(__fdiv_rn(a.x, s), __fdiv_rn(a.y, s), __fdiv_rn(a.z, s));
}
// torch.sum over a component axis of 3: (x + y) + z
__device__ __forceinline__ float dot(V3 a, V3 b) { return fa(fa(fm(a.x, b.x), fm(a.y, b.y)), fm(a.z, b.z)); }
__device__ __forceinline__ V3 clip(V3 x, V3 h) {
    return v3(fminf(fmaxf(x.x, -h.x), h.x), fminf(fmaxf(x.y, -h.y), h.y), fminf(fmaxf(x.z, -h.z), h.z));
}
__device__ __forceinline__ float safe_len(V3 d) { return __fsqrt_rn(fmaxf(dot(d, d), 1e-12f)); }

// core/math.quat_rotate: v + 2*(w*(q x v) + q x (q x v)), op by op
__device__ __forceinline__ V3 qrot(float4 q, V3 v) {
    const float tx = fm(2.f, fs(fm(q.y, v.z), fm(q.z, v.y)));
    const float ty = fm(2.f, fs(fm(q.z, v.x), fm(q.x, v.z)));
    const float tz = fm(2.f, fs(fm(q.x, v.y), fm(q.y, v.x)));
    return v3(fa(fa(v.x, fm(q.w, tx)), fs(fm(q.y, tz), fm(q.z, ty))),
              fa(fa(v.y, fm(q.w, ty)), fs(fm(q.z, tx), fm(q.x, tz))),
              fa(fa(v.z, fm(q.w, tz)), fs(fm(q.x, ty), fm(q.y, tx))));
}
__device__ __forceinline__ float4 conj(float4 q) { return make_float4(-q.x, -q.y, -q.z, q.w); }

// physics_ops.closest_point_on_segment
__device__ __forceinline__ V3 closest_on_segment(V3 p, V3 a, V3 b) {
    const V3 ab = sub(b, a);
    float t = __fdiv_rn(dot(sub(p, a), ab), fmaxf(dot(ab, ab), 1e-12f));
    t = fminf(fmaxf(t, 0.f), 1.f);
    return add(a, scl(ab, t));
}

struct Body {
    V3 p;
    float4 q;
    V3 he;
    float r;
    int shape;
};

__device__ __forceinline__ Body row_body(const float* row) {
    Body b;
    b.p = v3(row[R_POS], row[R_POS + 1], row[R_POS + 2]);
    b.q = make_float4(row[R_ROT], row[R_ROT + 1], row[R_ROT + 2], row[R_ROT + 3]);
    b.he = v3(row[R_HE], row[R_HE + 1], row[R_HE + 2]);
    b.r = row[R_RAD];
    b.shape = reinterpret_cast<const int*>(row)[R_FLAGS] & 0xFF;
    return b;
}

// physics_ops.box_corners: corner j of a box (signs -1/+1 of x, y, z from bits 2, 1, 0 of j)
__device__ __forceinline__ V3 corner(const Body& b, int j) {
    const V3 local = v3(fm(b.he.x, (j & 4) ? 1.f : -1.f), fm(b.he.y, (j & 2) ? 1.f : -1.f),
                        fm(b.he.z, (j & 1) ? 1.f : -1.f));
    return add(b.p, qrot(b.q, local));
}

// the box-box SAT's proj: sum over the box's axes of he_i |axis_i . u|, added in order
__device__ __forceinline__ float proj(const V3 ax[3], V3 he, V3 u) {
    return fa(fa(fm(he.x, fabsf(dot(ax[0], u))), fm(he.y, fabsf(dot(ax[1], u)))),
              fm(he.z, fabsf(dot(ax[2], u))));
}

// The narrowphase of one candidate pair (physics_ops.pair_contacts_from_data
// on one pair): a single contact (pt, n, dep in slot 0), or box-box (the face
// normal n, the k deepest corners of the incident box: sel[] their indexes
// and dsel[] their depths, deepest first).
struct Hit {
    V3 n, pt;
    float dep;
    bool bb, from_a;
    int sel[kMaxPoints];
    float dsel[kMaxPoints];
};

__device__ __forceinline__ void narrowphase(Body A, Body B, bool any_caps, int k, Hit& h) {
    if (any_caps) {
        const bool cap_a = A.shape == kCapsule, cap_b = B.shape == kCapsule;
        if (cap_a || cap_b) {
            // capsule_segment of both (each from its own half height), one refinement each way
            const V3 ua = qrot(A.q, v3(0.f, A.he.y, 0.f)), ub = qrot(B.q, v3(0.f, B.he.y, 0.f));
            const V3 a0 = add(A.p, ua), a1 = sub(A.p, ua), b0 = add(B.p, ub), b1 = sub(B.p, ub);
            const V3 pa = closest_on_segment(closest_on_segment(A.p, b0, b1), a0, a1);
            const V3 pb = closest_on_segment(closest_on_segment(B.p, a0, a1), b0, b1);
            if (cap_a) {
                A.p = pa;
                A.shape = 0;
            }
            if (cap_b) {
                B.p = pb;
                B.shape = 0;
            }
        }
    }
    const bool a_box = A.shape == kBox, b_box = B.shape == kBox;
    h.bb = a_box && b_box;
    h.from_a = false;
    if (!a_box && b_box) {            // sphere a vs box b
        const V3 c_in_b = qrot(conj(B.q), sub(A.p, B.p));
        const V3 closest = add(B.p, qrot(B.q, clip(c_in_b, B.he)));
        const V3 delta = sub(closest, A.p);
        const float dist = safe_len(delta);
        h.n = quo(delta, dist);
        h.dep = fs(A.r, dist);
        h.pt = closest;
        return;
    }
    if (a_box && !b_box) {            // box a vs sphere b
        const V3 c_in_a = qrot(conj(A.q), sub(B.p, A.p));
        const V3 closest = add(A.p, qrot(A.q, clip(c_in_a, A.he)));
        const V3 delta = sub(B.p, closest);
        const float dist = safe_len(delta);
        h.n = quo(delta, dist);
        h.dep = fs(B.r, dist);
        h.pt = closest;
        return;
    }
    if (!h.bb) {                      // sphere-sphere
        const V3 d = sub(B.p, A.p);
        const float dist = safe_len(d);
        h.n = quo(d, dist);
        h.dep = fs(fa(A.r, B.r), dist);
        h.pt = add(A.p, scl(h.n, A.r));
        return;
    }
    // box-box: SAT over the 6 face axes, a's first; ties keep the earlier axis
    V3 ax_a[3], ax_b[3];
    ax_a[0] = qrot(A.q, v3(1.f, 0.f, 0.f));
    ax_a[1] = qrot(A.q, v3(0.f, 1.f, 0.f));
    ax_a[2] = qrot(A.q, v3(0.f, 0.f, 1.f));
    ax_b[0] = qrot(B.q, v3(1.f, 0.f, 0.f));
    ax_b[1] = qrot(B.q, v3(0.f, 1.f, 0.f));
    ax_b[2] = qrot(B.q, v3(0.f, 0.f, 1.f));
    const V3 d_ab = sub(B.p, A.p);
    float best = 0.f;
    V3 n = v3(0.f, 0.f, 0.f);
    bool from_a = true;
#pragma unroll
    for (int x = 0; x < 6; ++x) {
        const V3 u = x < 3 ? ax_a[x] : ax_b[x - 3];
        const float du = dot(d_ab, u);
        const float overlap = fs(fa(proj(ax_a, A.he, u), proj(ax_b, B.he, u)), fabsf(du));
        const float sd = du == 0.f ? 1.f : du;
        const V3 n_u = scl(u, sd > 0.f ? 1.f : (sd < 0.f ? -1.f : 0.f));
        if (x == 0 || overlap < best) {
            best = overlap;
            n = n_u;
            from_a = x < 3;
        }
    }
    h.n = n;
    h.from_a = from_a;
    // the incident box's corner depths against the reference face
    const float sup = from_a ? fa(dot(A.p, n), proj(ax_a, A.he, n))
                             : fs(dot(B.p, n), proj(ax_b, B.he, n));
    const Body inc = from_a ? B : A;
    float dep[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float cn = dot(corner(inc, j), n);
        const float dj = fminf(from_a ? fs(sup, cn) : fs(cn, sup), best);
        dep[j] = best > 0.f ? dj : -1.f;
    }
    // the k deepest, ties to the lower corner (a stable descending sort's head)
    unsigned used = 0;
#pragma unroll
    for (int s = 0; s < kMaxPoints; ++s) {
        if (s >= k) break;
        int pick = -1;
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (!(used >> j & 1u) && (pick < 0 || dep[j] > v)) {
                pick = j;
                v = dep[j];
            }
        }
        used |= 1u << pick;
        h.sel[s] = pick;
        h.dsel[s] = v;
    }
}

// Thread (w, i) of sweep s: every slot (a, d-1, i), its ground slots on sweep
// 0, its share of the counts.
__global__ void __launch_bounds__(kThreads) grids_kernel(Call c, Sweep sw, int s) {
    extern __shared__ float tile[];
    int* itile = reinterpret_cast<int*>(tile);
    const int NB = c.NB, K = c.K, k = c.k;
    const int w = blockIdx.y, tid = threadIdx.x;
    const int i0 = blockIdx.x * kThreads, i = i0 + tid;
    // the block's rows: ranks i0 .. i0 + kThreads + K, gathered through the order
    for (int r = tid; r < kThreads + K + 1 && i0 + r < NB; r += kThreads) {
        const int b = ldl(sw.order, w, i0 + r);
        float* row = tile + r * kRow;
        int* irow = itile + r * kRow;
        for (int x = 0; x < 3; ++x) {
            row[R_POS + x] = ldf(c.pos, w, x, 0, 0, b);
            row[R_HE + x] = ldf(c.he, w, x, 0, 0, b);
            row[R_MN + x] = ldf(c.mn, w, x, 0, 0, b);
            row[R_MX + x] = ldf(c.mx, w, x, 0, 0, b);
        }
        for (int x = 0; x < 4; ++x) row[R_ROT + x] = ldf(c.rot, w, x, 0, 0, b);
        row[R_RAD] = ldf(c.radius, w, 0, 0, 0, b);
        row[R_FRIC] = ldf(c.fric, w, 0, 0, 0, b);
        row[R_REST] = ldf(c.rest, w, 0, 0, 0, b);
        irow[R_FLAGS] = (ldl(c.shape, w, b) & 0xFF) | (ldb(c.dyn, w, 0, 0, b) ? F_DYN : 0)
                        | (ldb(c.occ, w, 0, 0, b) ? F_OCC : 0)
                        | (c.hulls && ldb(c.cvx, w, 0, 0, b) ? F_CVX : 0);
        irow[R_LAYER] = c.layers ? ldl(c.layer, w, b) : 0;
        irow[R_PREV] = c.warm ? ldi(sw.prev_rank, w, b) : -1;
#pragma unroll
        for (int e = 0; e < kMaxSweeps - 1; ++e)
            irow[R_RANK + e] = e < s ? ldi(c.rank[e], w, b) : 0;
        irow[R_COL] = sw.col.p ? ldi(sw.col, w, b) : 0;
    }
    __syncthreads();

    int n_act = 0, n_miss = 0;
    if (i < NB) {
        const float* me = tile + tid * kRow;
        const int* ime = itile + tid * kRow;
        const int fl = ime[R_FLAGS], la = ime[R_LAYER];
        const float f_a = me[R_FRIC], r_a = me[R_REST];
        const V3 mn_a = v3(me[R_MN], me[R_MN + 1], me[R_MN + 2]);
        const V3 mx_a = v3(me[R_MX], me[R_MX + 1], me[R_MX + 2]);
        const long long plane = (long long)K * NB;
        const long long wk = (long long)w * k;

        if (s == 0 && c.ground) {
            // the ground stream in rank space; sweep 0's ground friction and restitution
            const int b = ldl(sw.order, w, i);
            const long long gw = (long long)w * c.G;
            for (int g = 0; g < c.G; ++g) {
                const bool act = ldb(c.gc_active, w, g, 0, b) && (fl & F_OCC);
                c.g_depth[(gw + g) * NB + i] = ldf(c.gc_depth, w, 0, g, 0, b);
                c.g_active[(gw + g) * NB + i] = act;
                n_act += act;
                for (int x = 0; x < 3; ++x) {
                    const long long o = (((long long)w * 3 + x) * c.G + g) * NB + i;
                    c.g_point[o] = ldf(c.gc_point, w, x, g, 0, b);
                    c.g_normal[o] = ldf(c.gc_normal, w, x, g, 0, b);
                    if (c.warm) c.g_warm[o] = ldf(c.carry_g, w, x, g, 0, b);
                }
            }
            c.g_fric_out[(long long)w * NB + i] = __fsqrt_rn(fmaxf(fm(f_a, c.g_fric), 0.f));
            c.g_rest_out[(long long)w * NB + i] = c.g_rest_on ? fmaxf(r_a, c.g_rest) : r_a;
        }

        // the window certificate: a column sweep's same-column reach past the
        // K-th successor in y, a lone classic sweep's in x
        if ((sw.col.p || sw.window_miss) && i + K + 1 < NB) {
            const float* o = tile + (tid + K + 1) * kRow;
            const bool m = sw.col.p ? (mx_a.y >= o[R_MN + 1] && ime[R_COL] == itile[(tid + K + 1) * kRow + R_COL])
                                    : mx_a.x >= o[R_MN];
            n_miss += m && (fl & F_OCC);
        }

        // match_warm_lams: this rank's rank last frame
        const int rp = ime[R_PREV];
        const int safe_i = rp < 0 ? -(1 << 20) : rp;

        for (int d = 1; d <= K; ++d) {
            const bool valid = i + d < NB;
            const float* o = tile + (tid + d) * kRow;
            const int* io = itile + (tid + d) * kRow;
            const long long dn = (long long)(d - 1) * NB + i;
            float f_b = 0.f, r_b = 0.f;
            int flb = 0;
            bool ok = false;
            if (valid) {
                f_b = o[R_FRIC];
                r_b = o[R_REST];
                flb = io[R_FLAGS];
                ok = mn_a.x <= o[R_MX] && o[R_MN] <= mx_a.x && mn_a.y <= o[R_MX + 1]
                     && o[R_MN + 1] <= mx_a.y && mn_a.z <= o[R_MX + 2] && o[R_MN + 2] <= mx_a.z
                     && ((fl | flb) & F_DYN) && (fl & flb & F_OCC);
                if (ok && c.layers)
                    ok = ldb(c.matrix, 0, 0, 0, (long long)la * c.L + io[R_LAYER]);
#pragma unroll
                for (int e = 0; e < kMaxSweeps - 1; ++e)
                    if (e < s && ok) ok = abs(io[R_RANK + e] - ime[R_RANK + e]) > K;
            }
            sw.fric[(long long)w * plane + dn] = __fsqrt_rn(fmaxf(fm(f_a, f_b), 0.f));
            sw.rest[(long long)w * plane + dn] = fmaxf(r_a, r_b);

            if (ok && c.hulls && ((fl | flb) & F_CVX)) {
                // a pair that holds a hull: the polytope SAT's grids
                for (int a = 0; a < k; ++a) {
                    const bool act = ldb(sw.h_active, w, a, d - 1, i);
                    for (int x = 0; x < 3; ++x) {
                        const long long q = ((wk * 3 + (long long)x * k) + a) * plane + dn;
                        sw.point[q] = ldf(sw.h_point, w, x, a, d - 1, i);
                        sw.normal[q] = ldf(sw.h_normal, w, x, a, d - 1, i);
                    }
                    sw.depth[(wk + a) * plane + dn] = ldf(sw.h_depth, w, 0, a, d - 1, i);
                    sw.active[(wk + a) * plane + dn] = act;
                    n_act += act;
                }
            } else if (ok) {
                Hit h;
                const Body A = row_body(me), B = row_body(o);
                narrowphase(A, B, c.any_caps != 0, k, h);
                const Body inc = h.from_a ? B : A;
#pragma unroll
                for (int a = 0; a < kMaxPoints; ++a) {
                    if (a >= k) break;
                    V3 pt = v3(0.f, 0.f, 0.f), n = v3(0.f, 0.f, 0.f);
                    float dep = -1.f;
                    if (h.bb) {
                        pt = corner(inc, h.sel[a]);
                        n = h.n;
                        dep = h.dsel[a];
                    } else if (a == 0) {
                        pt = h.pt;
                        n = h.n;
                        dep = h.dep;
                    }
                    const bool act = dep > 0.f && dot(n, n) > 1e-6f;
                    const long long q = (wk * 3 + a) * plane + dn, qs = (long long)k * plane;
                    sw.point[q] = pt.x;
                    sw.point[q + qs] = pt.y;
                    sw.point[q + 2 * qs] = pt.z;
                    sw.normal[q] = n.x;
                    sw.normal[q + qs] = n.y;
                    sw.normal[q + 2 * qs] = n.z;
                    sw.depth[(wk + a) * plane + dn] = dep;
                    sw.active[(wk + a) * plane + dn] = act;
                    n_act += act;
                }
            } else {
                for (int a = 0; a < k; ++a) {
                    const long long q = (wk * 3 + a) * plane + dn, qs = (long long)k * plane;
                    sw.point[q] = 0.f;
                    sw.point[q + qs] = 0.f;
                    sw.point[q + 2 * qs] = 0.f;
                    sw.normal[q] = 0.f;
                    sw.normal[q + qs] = 0.f;
                    sw.normal[q + 2 * qs] = 0.f;
                    sw.depth[(wk + a) * plane + dn] = 0.f;
                    sw.active[(wk + a) * plane + dn] = 0;
                }
            }

            if (c.warm) {
                // the pair's lambdas last frame, if it sat in last frame's window
                // either way round (the partner of a rank past the last reads 0,
                // as banded_pair_data pads); a crossed pair flips lambda t2
                const int pr = io[R_PREV];
                const int partner = valid ? (pr < 0 ? -(1 << 20) : pr) : 0;
                const int delta = partner - safe_i;
                const bool fwd = delta >= 1 && delta <= K, bwd = delta <= -1 && delta >= -K;
                const bool hit = (fwd || bwd) && rp >= 0 && partner >= 0;
                const int didx = (fwd ? delta : -delta) - 1, base = fwd ? safe_i : partner;
                for (int x = 0; x < 3; ++x) {
                    for (int a = 0; a < k; ++a) {
                        float l = hit ? ldf(sw.prev_lam, w, x, a, didx, base) : 0.f;
                        if (x == 2 && bwd) l = -l;
                        sw.warm[((wk * 3 + (long long)x * k) + a) * plane + dn] = l;
                    }
                }
            }
        }
    }
    n_act = __reduce_add_sync(0xFFFFFFFFu, n_act);
    n_miss = __reduce_add_sync(0xFFFFFFFFu, n_miss);
    if ((tid & 31) == 0) {
        if (n_miss) atomicAdd(&c.counts[w], n_miss);
        if (n_act) atomicAdd(&c.counts[c.W + w], n_act);
    }
}

}  // namespace

// Sizes the wrapper checks its mirror of the structures against:
// sizeof(View), sizeof(Sweep), sizeof(Call), offsetof(Call, launches).
extern "C" void lumix_banded_grids_abi(long long* out) {
    out[0] = (long long)sizeof(View);
    out[1] = (long long)sizeof(Sweep);
    out[2] = (long long)sizeof(Call);
    out[3] = (long long)offsetof(Call, launches);
}

// The whole stage on `stream` (call_: a Call, sweeps_: its S Sweeps);
// call->launches gets the kernels launched.
extern "C" int lumix_banded_grids(void* call_, const void* sweeps_, cudaStream_t stream) {
    Call* call = static_cast<Call*>(call_);
    const Sweep* sweeps = static_cast<const Sweep*>(sweeps_);
    call->launches = 0;
    const int W = call->W, NB = call->NB, S = call->S;
    if (W <= 0) return 0;
    if (W > kMaxWorlds || S > kMaxSweeps || call->k > kMaxPoints || call->k < 1 || call->K < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(call->counts, 0, (size_t)2 * W * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
    if (NB <= 0 || S <= 0) return 0;
    const size_t smem = (size_t)(kThreads + call->K + 1) * kRow * sizeof(float);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(grids_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((NB + kThreads - 1) / kThreads, W);
    for (int s = 0; s < S; ++s) {
        grids_kernel<<<grid, kThreads, smem, stream>>>(*call, sweeps[s], s);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        ++call->launches;
    }
    return 0;
}
