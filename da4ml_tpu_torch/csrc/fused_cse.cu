// K2: the whole greedy CSE loop of the device CMVM search, score cache
// included, one thread-block cluster per lane, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel da4ml_tpu/cmvm/fused_cse.py::_build_pallas_loop
// (pallas_call at fused_cse.py:460), which runs the same loop for a block of
// lanes with all state in VMEM and takes the score cache built outside it.
// Its plain version is da4ml_tpu_torch/cmvm/torch_search.py::rung_plain
// (init_cache, then greedy_plain); the wrapper is
// da4ml_tpu_torch/cmvm/fused_cse.py, which also computes the geometry
// (cluster_geometry) and the slice layout (slice_layout) this kernel reads
// from its Params.
//
// A lane is a cluster of C blocks ("CTAs"). CTA r owns the slots
// [r*PC, (r+1)*PC), PC = P/C, and holds in its slice the score cache of
// those rows (rank-major, so the rank-0 heads are contiguous), the dirty-row
// scores against its slots, and the candidate lists other CTAs send for the
// rows it owns. Every slot's metadata (lo, hi, step, latency) and every
// slot's digit row, packed as bit planes (+1 digits, then -1 digits; W words
// each, 32/B outputs a word), are replicated in every CTA, and every CTA
// applies the same commit and substitution to its copy: no CTA reads
// another's digits. The slice lives in shared memory when it fits, else in a
// global-memory scratch with the same layout (one kernel, two placements); a
// CTA reaches another's slice through distributed shared memory or that
// scratch.
//
// The cache build (the stage-entry top-K of every row, as init_cache): each
// CTA scores each of its rows against every slot, row first, and one warp
// per (sub, shift) takes the row's top-K; no other CTA is involved.
//
// An iteration, with two cluster barriers:
//   A. each CTA reduces its heads to a partial winner in the host scan order
//      (max score, then max id-major, then max minor key) and pushes it into
//      every CTA's slice;
//      -- cluster barrier --
//   C. every CTA reduces the C partial winners the same way, so all hold the
//      same pair (sub, s, i, j); it computes the match mask (the i == j bit
//      chain matched ascending) and the three new rows on its copy of the
//      bit planes, and commits the new slot's metadata into its copy (CTA 0
//      writes the op record);
//   D. it recounts the pairs of the dirty rows {i, j, cur} against its own
//      slots (each dirty row's nonzero digits against the slot at every
//      shift), rescores them, sends a partial top-K of each of the 3*2B dirty
//      (row, sub, shift) items over its slots to the item's merger (CTA
//      item % C), and merges the fresh columns into its own non-dirty rows'
//      caches (a rank count of K cached and <= 3 fresh entries, in
//      registers) while the lists travel;
//      -- cluster barrier (arrive before the merge, wait after it) --
//   E. each CTA merges the C partial lists of its items into the row's
//      cache in the owner's slice, and keeps the row's new head for its own
//      next argmax: the rebuild is spread over the cluster, not left to the
//      owners of the dirty rows.
// A lane stops when it has no valid candidate or its next slot reaches P
// (frozen, resumed at the next rung with a fresh cache); all CTAs of the
// cluster decide alike and leave after a last cluster barrier, so none
// leaves while another may still write into its slice. Each CTA then writes
// its own rows' digits and metadata back. A padding lane enters at cur == P
// and does nothing.
//
// Bound: a lane's iterations are a serial chain; an iteration's work is
// small (the flagship's largest class has 2B*P = 3072 cache heads and dirty
// rows of a few dozen digits), so the kernel is bound by the latency of that
// chain, not by bytes or operations. The cluster spreads an iteration over C
// SMs (PC = 16 slots per CTA up to P = 256), keeps the cache out of device
// memory, and builds it in the kernel.
//
// Numerics follow the plain version exactly: counts are integers; scores and
// metadata use the same float32 operations in the same order, each rounded
// on its own (built with -fmad=false, and written with __fmul_rn/__fadd_rn);
// ceil(log2 x) is taken exactly from the exponent (frexpf), 2^shift from the
// exponent bits; log2f only for a step that is not a power of two. Three
// total orders fix every result whatever the partition: the host scan order
// of the argmax, the cache order (score desc, column desc) of every top-K,
// and the merge's, which is the cache order over distinct columns.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;
constexpr float kInf = __builtin_huge_valf();
constexpr unsigned kFull = 0xffffffffu;
// the block size of an instantiation: K = 16 needs more than the 128
// registers a thread that 512 threads leave, so its blocks take 256
template <int K>
constexpr int kThreadsFor = K > 8 ? kMaxThreads / 2 : kMaxThreads;

// Byte offsets of the regions of a CTA's slice (fused_cse.py::slice_layout).
struct Layout {
    int tv;      // [K][2B][PC] f32: score cache of the CTA's rows, rank-major
    int tc;      // [K][2B][PC] i32: the cached columns
    int meta;    // [P] float4: lo, hi, step, latency of every slot (replicated)
    int planes;  // [P][2][W] u32: every slot's digit row as bit planes, +1 then -1 digits (replicated)
    int parts;   // [C][4] i32: the partial winners every CTA pushes (score, id-major, minor)
    int S;       // [2][3][2B][PC] f32: dirty-row scores (rowS) and fresh-column scores (colS)
    int cv;      // [3][2B][C][K] f32: partial top-K lists sent to this CTA for the dirty rows it merges
    int cc;      // [3][2B][C][K] i32
    int nov;     // [2][3][PC] f32: n_overlap and |dlat| of the dirty rows against its slots
    int bytes;   // slice size
};

struct Params {
    int8_t* E;             // [N][P][O*B] digits (in/out)
    float* qm;             // [N][P][3] lo, hi, step (in/out)
    float* lat;            // [N][P] latency (in/out)
    int32_t* rec;          // [N][n_iters][4] op records (out, zeroed)
    int32_t* cur;          // [N] next free slot (in/out)
    const int32_t* method; // [N]
    char* scratch;         // [N][C] slices in global memory; null when they live in shared memory
    long long* clocks;     // with FUSED_CSE_PHASES: clock cycles per phase of lane 0's CTA 0
    int P, O, B, n_iters, adder, carry, C, PC, W;
    Layout L;
};

__device__ __forceinline__ float ceil_log2(float x) {  // exact; -inf at 0
    if (x == 0.0f) return -kInf;
    int e;
    float m = frexpf(x, &e);
    return (float)(m == 0.5f ? e - 1 : e);
}

__device__ __forceinline__ float log2_step(float x) {  // exact at powers of two
    int e;
    float m = frexpf(x, &e);
    return m == 0.5f ? (float)(e - 1) : log2f(x);
}

__device__ __forceinline__ float iceil_log2(float x) { return x > 0.0f ? ceil_log2(fmaxf(x, 1e-37f)) : 0.0f; }

__device__ __forceinline__ float pow2f(int shift) { return __int_as_float((shift + 127) << 23); }

// _overlap_vec: the overlap weight of a pair
__device__ float overlap(float4 a, float4 b) {
    float max0 = __fadd_rn(a.y, a.z);
    float max1 = __fadd_rn(b.y, b.z);
    float f = -iceil_log2(fmaxf(a.z, b.z));
    float il = iceil_log2(fminf(fmaxf(fabsf(a.x), fabsf(max0)), fmaxf(fabsf(b.x), fabsf(max1))));
    float k = (a.x < 0.0f || b.x < 0.0f) ? 1.0f : 0.0f;
    return __fadd_rn(__fadd_rn(k, il), f);
}

// _cost_add_vec, the latency half
__device__ float cost_add_lat(float lo0, float hi0, float st0, float lo1, float hi1, float st1, float sp, bool sub,
                              int adder, int carry) {
    if (adder < 0 && carry < 0) return 1.0f;
    float c_sz = carry < 0 ? 65535.0f : (float)carry;
    float min1 = __fmul_rn(sub ? hi1 : lo1, sp);
    float max1 = __fmul_rn(sub ? lo1 : hi1, sp);
    float st1s = __fmul_rn(st1, sp);
    float max0 = __fadd_rn(hi0, st0);
    max1 = __fadd_rn(max1, st1s);
    float f = -log2_step(fmaxf(st0, st1s));
    float i = ceil_log2(fmaxf(fmaxf(fabsf(lo0), fabsf(min1)), fmaxf(fabsf(max0), fabsf(max1))));
    float k = (lo0 < 0.0f || lo1 < 0.0f) ? 1.0f : 0.0f;
    float n = __fadd_rn(__fadd_rn(k, i), f);
    return ceilf(__fdiv_rn(n, c_sz));
}

// The interval and latency of the sum of slots id0 and id1 << shift (qint_add
// and _cost_add_vec, as torch_search._dev_commit_pair)
__device__ __forceinline__ float4 commit_meta(const float4* meta, int id0, int id1, int sub, int shift, int adder,
                                              int carry) {
    const float sp = pow2f(shift);
    const float4 a = meta[id0], b = meta[id1];
    const bool is_sub = sub == 1;
    const float dl = cost_add_lat(a.x, a.y, a.z, b.x, b.y, b.z, sp, is_sub, adder, carry);
    return make_float4(__fadd_rn(a.x, __fmul_rn(is_sub ? -b.y : b.x, sp)),
                       __fadd_rn(a.y, __fmul_rn(is_sub ? -b.x : b.y, sp)),
                       fminf(a.z, __fmul_rn(b.z, sp)), __fadd_rn(fmaxf(a.w, b.w), dl));
}

// _score_cand
__device__ __forceinline__ float score_cand(int count, float nov, float dlat, int method, bool pair_ok) {
    float cnt = (float)count;
    float s;
    if (method == 0) {
        s = cnt;
    } else if (method == 1 || method == 2) {
        s = __fsub_rn(cnt, __fmul_rn(1e9f, dlat));
    } else if (method == 3) {
        s = __fmul_rn(cnt, nov);
    } else {
        s = __fsub_rn(__fmul_rn(cnt, nov), __fmul_rn(256.0f, dlat));
    }
    bool valid = cnt >= 2.0f && pair_ok;
    if (method == 1 || method == 3 || method == 4) valid = valid && s >= 0.0f;
    return valid ? s : -kInf;
}

// host scan order: (score, id-major, minor) lexicographic max
__device__ __forceinline__ bool key_better(float v1, int a1, int b1, float v2, int a2, int b2) {
    if (v1 != v2) return v1 > v2;
    if (a1 != a2) return a1 > a2;
    return b1 > b2;
}

// cache order: score desc, column desc
__device__ __forceinline__ bool cand_better(float v1, int c1, float v2, int c2) {
    return v1 > v2 || (v1 == v2 && c1 > c2);
}

// the warp's best key in the host scan order, in every lane
__device__ __forceinline__ void warp_key_max(float& bv, int& ba, int& bb) {
    for (int o = 16; o > 0; o >>= 1) {
        float v = __shfl_xor_sync(kFull, bv, o);
        int a = __shfl_xor_sync(kFull, ba, o), b = __shfl_xor_sync(kFull, bb, o);
        if (key_better(v, a, b, bv, ba, bb)) bv = v, ba = a, bb = b;
    }
}

// The two halves of a cluster barrier (cluster.sync() is both): arrive with
// release semantics, wait with acquire semantics; every thread calls both.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory"); }

// Bit planes of a digit row: output o's B digits at bits (o % F) * B + b of
// word o / F (F = 32 / B outputs per word), +1 digits in pos, -1 digits in
// neg. Word w of the row, for one thread.
__device__ __forceinline__ void pack_word(const int8_t* row, int w, int O, int B, uint32_t* pos, uint32_t* neg) {
    const int F = 32 / B;
    uint32_t p = 0, n = 0;
    for (int f = 0; f < F; ++f) {
        const int o = w * F + f;
        if (o >= O) break;
        for (int b = 0; b < B; ++b) {
            const int d = row[o * B + b];
            p |= (uint32_t)(d == 1) << (f * B + b);
            n |= (uint32_t)(d == -1) << (f * B + b);
        }
    }
    pos[w] = p, neg[w] = n;
}

// Pair counts of row R against slot q at shift s2, from their bit planes (W
// words each, +1 plane then -1 plane): (R first at bit b, q second at b + s2)
// into rs (add) / rd (sub), and with kCol (q first at b - s2, R second at b)
// into cs / cd. mR keeps the bits b < B - s2 of every output, mC the bits
// b >= s2. The cache build and the recount's row-first half are this function.
template <bool kCol>
__device__ __forceinline__ void count_pairs(const uint32_t* R, const uint32_t* Q, int W, int s2, uint32_t mR, uint32_t mC,
                                            int& rs, int& rd, int& cs, int& cd) {
    rs = rd = cs = cd = 0;
    for (int w = 0; w < W; ++w) {
        const uint32_t rp = R[w], rn = R[W + w], qp = Q[w], qn = Q[W + w];
        const uint32_t up = qp >> s2, un = qn >> s2;
        rs += __popc(((rp & up) | (rn & un)) & mR);
        rd += __popc(((rp & un) | (rn & up)) & mR);
        if (kCol) {
            const uint32_t dp = qp << s2, dn = qn << s2;
            cs += __popc(((rp & dp) | (rn & dn)) & mC);
            cd += __popc(((rp & dn) | (rn & dp)) & mC);
        }
    }
}

// One warp: the rank of each of n <= 32 * kE entries held in registers (kE
// per lane, entry u * 32 + lane; dead entries -inf), counted over the live
// entries only (a ballot mask walks them).
template <int K, int kE>
__device__ __forceinline__ void rank_topk(const float* v, const int* c, int col0, int n, float* ov, int* oc,
                                          int ostride, int lid, float& hv, int& hc) {
    float x[kE];
    int cx[kE], rank[kE];
    unsigned live[kE];
    int nlive = 0;
#pragma unroll
    for (int u = 0; u < kE; ++u) {
        const int e = u * 32 + lid;
        x[u] = e < n ? v[e] : -kInf;
        cx[u] = e < n ? (c ? c[e] : col0 + e) : -1;
        rank[u] = 0;
        live[u] = __ballot_sync(kFull, x[u] != -kInf);
        nlive += __popc(live[u]);
    }
#pragma unroll
    for (int u2 = 0; u2 < kE; ++u2) {
        for (unsigned m = live[u2]; m; m &= m - 1) {
            const int f = __ffs(m) - 1;
            const float y = __shfl_sync(kFull, x[u2], f);
            const int cy = __shfl_sync(kFull, cx[u2], f);
#pragma unroll
            for (int u = 0; u < kE; ++u) rank[u] += cand_better(y, cy, x[u], cx[u]);
        }
    }
    hv = -kInf, hc = -1;
#pragma unroll
    for (int u = 0; u < kE; ++u) {
        if (x[u] != -kInf && rank[u] < K) ov[rank[u] * ostride] = x[u], oc[rank[u] * ostride] = cx[u];
        const unsigned head = __ballot_sync(kFull, x[u] != -kInf && rank[u] == 0);
        if (head) hv = __shfl_sync(kFull, x[u], __ffs(head) - 1), hc = __shfl_sync(kFull, cx[u], __ffs(head) - 1);
    }
    for (int k = nlive + lid; k < K; k += 32) ov[k * ostride] = -kInf, oc[k * ostride] = -1;
}

// One warp, two lists of n <= 16 entries: lanes 0-15 rank the list of their
// own arguments, lanes 16-31 theirs (a half with `on` false has no list and
// writes nothing). As rank_topk; the rank-0 entry of a half's list in each
// of its lanes as (hv, hc).
template <int K>
__device__ __forceinline__ void pair_topk(const float* v, const int* c, int col0, int n, float* ov, int* oc,
                                          int ostride, bool on, int lid, float& hv, int& hc) {
    const int h = (lid >> 4) << 4, l = lid & 15;
    const float x = on && l < n ? v[l] : -kInf;
    const int cx = on && l < n ? (c ? c[l] : col0 + l) : -1;
    unsigned m = (__ballot_sync(kFull, x != -kInf) >> h) & 0xffffu;
    const int nlive = __popc(m);
    int rank = 0;
    while (__any_sync(kFull, m != 0)) {  // both halves step together, each over its own live entries
        const int f = m ? __ffs(m) - 1 : 0;
        const float y = __shfl_sync(kFull, x, h + f);
        const int cy = __shfl_sync(kFull, cx, h + f);
        if (m) {
            rank += cand_better(y, cy, x, cx);
            m &= m - 1;
        }
    }
    if (x != -kInf && rank < K) ov[rank * ostride] = x, oc[rank * ostride] = cx;
    if (on)
        for (int k = nlive + l; k < K; k += 16) ov[k * ostride] = -kInf, oc[k * ostride] = -1;
    const unsigned head = (__ballot_sync(kFull, x != -kInf && rank == 0) >> h) & 0xffffu;
    const int src = head ? h + __ffs(head) - 1 : lid;
    const float y = __shfl_sync(kFull, x, src);
    const int cy = __shfl_sync(kFull, cx, src);
    hv = head ? y : -kInf, hc = head ? cy : -1;
}

template <int K>
__device__ __forceinline__ void lane_clear(float (&lv)[K], int (&lc)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) lv[k] = -kInf, lc[k] = -1;
}

// Insert (x, cx) into one lane's sorted top-K list (cache order, columns
// distinct); a dead entry (-inf) is dropped.
template <int K>
__device__ __forceinline__ void lane_insert(float (&lv)[K], int (&lc)[K], float x, int cx) {
    if (x == -kInf) return;
#pragma unroll
    for (int k = K - 1; k > 0; --k) {  // from the tail
        const bool above = cand_better(x, cx, lv[k - 1], lc[k - 1]);
        const bool here = cand_better(x, cx, lv[k], lc[k]);
        lv[k] = above ? lv[k - 1] : here ? x : lv[k];
        lc[k] = above ? lc[k - 1] : here ? cx : lc[k];
    }
    if (cand_better(x, cx, lv[0], lc[0])) lv[0] = x, lc[0] = cx;
}

template <int K>
__device__ __forceinline__ void warp_merge_lanes(float (&lv)[K], int (&lc)[K], float* ov, int* oc, int ostride, int lid,
                                                 float& hv, int& hc);

// One warp: the top-K in cache order of n entries (scores v[e]; columns c[e],
// or col0 + e when c is null; -inf entries are dead), written to ov/oc at
// rank * ostride, dead ranks as (-inf, -1); the rank-0 entry in every lane
// as (hv, hc). Columns must be distinct. Up to 128 entries each entry's rank
// is counted in registers; above, each lane keeps a sorted top-K of its
// entries in registers and K rounds take the best head of the warp.
template <int K>
__device__ void warp_topk(const float* v, const int* c, int col0, int n, float* ov, int* oc, int ostride, int lid,
                          float& hv, int& hc) {
    if (n <= 32) return rank_topk<K, 1>(v, c, col0, n, ov, oc, ostride, lid, hv, hc);
    if (n <= 64) return rank_topk<K, 2>(v, c, col0, n, ov, oc, ostride, lid, hv, hc);
    if (n <= 128) return rank_topk<K, 4>(v, c, col0, n, ov, oc, ostride, lid, hv, hc);
    float lv[K];
    int lc[K];
    lane_clear(lv, lc);
    for (int e = lid; e < n; e += 32) lane_insert(lv, lc, v[e], c ? c[e] : col0 + e);
    warp_merge_lanes(lv, lc, ov, oc, ostride, lid, hv, hc);
}

// One warp: the top-K in cache order of the lanes' sorted lists (lv, lc; the
// lists are consumed), written to ov/oc at rank * ostride, dead ranks as
// (-inf, -1); the rank-0 entry in every lane as (hv, hc). K rounds take the
// best head of the warp; the lane that held it pops it.
template <int K>
__device__ __forceinline__ void warp_merge_lanes(float (&lv)[K], int (&lc)[K], float* ov, int* oc, int ostride, int lid,
                                                 float& hv, int& hc) {
    for (int k = 0; k < K; ++k) {
        float bv = lv[0];
        int bc = lc[0];
        for (int o = 16; o > 0; o >>= 1) {
            const float v2 = __shfl_xor_sync(kFull, bv, o);
            const int c2 = __shfl_xor_sync(kFull, bc, o);
            if (cand_better(v2, c2, bv, bc)) bv = v2, bc = c2;
        }
        if (k == 0) hv = bv, hc = bv == -kInf ? -1 : bc;
        if (bv == -kInf) {
            for (int k2 = k + lid; k2 < K; k2 += 32) ov[k2 * ostride] = -kInf, oc[k2 * ostride] = -1;
            return;
        }
        if (lid == 0) ov[k * ostride] = bv, oc[k * ostride] = bc;
        if (lc[0] == bc) {  // the lane that held it pops its head (columns are distinct)
#pragma unroll
            for (int k2 = 0; k2 + 1 < K; ++k2) lv[k2] = lv[k2 + 1], lc[k2] = lc[k2 + 1];
            lv[K - 1] = -kInf, lc[K - 1] = -1;
        }
    }
}

// Merge the fresh columns (fv[r], fc[r]), r < 3, into one cache row (K
// entries at stride `stride`), dropping the cached entries of those columns:
// every live entry's output rank is counted in registers, static indices only.
template <int K>
__device__ __forceinline__ void merge_row(float* tv, int* tc, int stride, const float (&fv)[3], const int (&fc)[3]) {
    float v[K];
    int c[K];
    bool stale = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        c[k] = tc[k * stride];
        stale |= c[k] >= 0 && (c[k] == fc[0] || c[k] == fc[1] || c[k] == fc[2]);
    }
    if (!stale && fv[0] == -kInf && fv[1] == -kInf && fv[2] == -kInf) return;  // the row does not change
#pragma unroll
    for (int k = 0; k < K; ++k) {
        v[k] = tv[k * stride];
        if (c[k] == fc[0] || c[k] == fc[1] || c[k] == fc[2]) v[k] = -kInf;  // stale column
    }
    // every value is in registers: the writes below may overwrite the row
    int pre = 0, frank[3] = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const bool live = v[k] != -kInf;
        int rank = pre;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            rank += fv[r] != -kInf && cand_better(fv[r], fc[r], v[k], c[k]);
            frank[r] += live && cand_better(v[k], c[k], fv[r], fc[r]);
        }
        if (live && rank < K) tv[rank * stride] = v[k], tc[rank * stride] = c[k];
        pre += live;
    }
    int total = pre;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        if (fv[r] == -kInf) continue;
        ++total;
#pragma unroll
        for (int r2 = 0; r2 < 3; ++r2) frank[r] += r2 != r && fv[r2] != -kInf && cand_better(fv[r2], fc[r2], fv[r], fc[r]);
        if (frank[r] < K) tv[frank[r] * stride] = fv[r], tc[frank[r] * stride] = fc[r];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (k >= total) tv[k * stride] = -kInf, tc[k * stride] = -1;
    }
}

#ifdef FUSED_CSE_PHASES
// clock cycles of each phase, seen by thread 0 of lane 0's CTA 0, summed in
// shared memory and written out at the end (a build for measurement only:
// chip_smoke.py reports them)
#define PHASE(k)                                         \
    if (watch) {                                         \
        const long long now = clock64();                 \
        ph_acc[k] += now - t_last;                       \
        t_last = now;                                    \
    }
#else
#define PHASE(k)
#endif

template <int K, bool kGlobal>
__global__ void __launch_bounds__(kThreadsFor<K>, 1) fused_cse_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red_v[kMaxWarps];
    __shared__ int red_a[kMaxWarps], red_b[kMaxWarps];
    __shared__ uint32_t mask_R[32], mask_C[32], mask_bit[32];

    cg::cluster_group cluster = cg::this_cluster();
    const Layout& L = p.L;
    const int C = p.C, PC = p.PC, W = p.W, me = (int)cluster.block_rank(), lane = blockIdx.x / C;
    const int tid = threadIdx.x, nthreads = blockDim.x, wid = tid >> 5, lid = tid & 31, nwarps = nthreads >> 5;
    const int P = p.P, O = p.O, B = p.B, OB = O * B, TB = 2 * B, q0 = me * PC, W2 = 2 * W, F = 32 / B;
    int cur = p.cur[lane];
    // the whole cluster leaves alike: a padding or frozen lane, or one whose
    // records would not fit (the wrapper raises before the launch)
    if (cur >= P || P - cur > p.n_iters) return;
    const int cur0 = cur;
    const int method = p.method[lane];
#ifdef FUSED_CSE_PHASES
    __shared__ long long ph_acc[8];
    const bool watch = lane == 0 && me == 0 && tid == 0;
    if (tid < 8) ph_acc[tid] = 0;
    long long t_last = clock64();
#endif

    // the slice of CTA r of this cluster
    auto slice = [&](int r) -> char* {
        return kGlobal ? p.scratch + ((size_t)lane * C + r) * L.bytes
                       : reinterpret_cast<char*>(cluster.map_shared_rank(smem, (unsigned)r));
    };
    char* base = kGlobal ? p.scratch + ((size_t)lane * C + me) * L.bytes : reinterpret_cast<char*>(smem);
    float* tv = reinterpret_cast<float*>(base + L.tv);
    int* tc = reinterpret_cast<int*>(base + L.tc);
    float4* meta = reinterpret_cast<float4*>(base + L.meta);
    uint32_t* pl = reinterpret_cast<uint32_t*>(base + L.planes);
    int* parts = reinterpret_cast<int*>(base + L.parts);
    float* rowS = reinterpret_cast<float*>(base + L.S);
    float* colS = rowS + 3 * TB * PC;
    float* cv = reinterpret_cast<float*>(base + L.cv);
    int* cc = reinterpret_cast<int*>(base + L.cc);
    float* novR = reinterpret_cast<float*>(base + L.nov);
    float* dltR = novR + 3 * PC;
    const int TBPC = TB * PC;

    int8_t* Eg = p.E + (size_t)lane * P * OB;
    float* qm = p.qm + (size_t)lane * P * 3;
    float* lat = p.lat + (size_t)lane * P;
    int32_t* rec = p.rec + (size_t)lane * p.n_iters * 4;
    for (int q = tid; q < P; q += nthreads) meta[q] = make_float4(qm[q * 3], qm[q * 3 + 1], qm[q * 3 + 2], lat[q]);
    if (tid < B) {  // per output field of a word: bits b < B - s2, bits b >= s2, bit b
        const uint32_t low = B - tid >= 32 ? kFull : (1u << (B - tid)) - 1u;
        uint32_t mr = 0, mc = 0, mb = 0;
        for (int f = 0; f < F; ++f) {
            mr |= low << (f * B);
            mc |= (low << tid) << (f * B);
            mb |= 1u << (f * B + tid);
        }
        mask_R[tid] = mr, mask_C[tid] = mc, mask_bit[tid] = mb;
    }
    for (int e = tid; e < P * W; e += nthreads) {  // every row's bit planes, replicated in every CTA
        const int q = e / W, w = e - q * W;
        pack_word(Eg + (size_t)q * OB, w, O, B, pl + q * W2, pl + q * W2 + W);
    }
    __syncthreads();

    // ---- the score cache of this CTA's rows: one warp per (row, shift)
    // scores the row, first, against every slot at that shift, keeps each
    // lane's top-K of the add and the sub candidates in registers, and merges
    // the lanes' lists into the two cache rows; no block barrier, no scratch
    for (int item = wid; item < PC * B; item += nwarps) {
        const int t = item / B, s2 = item - t * B, pr = q0 + t;
        const float4 a = meta[pr];
        float av[K], sv[K];
        int ac[K], sc[K];
        lane_clear(av, ac);
        lane_clear(sv, sc);
        for (int q = lid; q < P; q += 32) {
            int add, sub, unused0, unused1;
            count_pairs<false>(pl + pr * W2, pl + q * W2, W, s2, mask_R[s2], 0u, add, sub, unused0, unused1);
            if (add < 2 && sub < 2) continue;  // neither is a candidate
            const float4 b = meta[q];
            const float nov = overlap(a, b), dl = fabsf(__fsub_rn(a.w, b.w));
            const bool ok = s2 > 0 || pr < q;
            lane_insert(av, ac, score_cand(add, nov, dl, method, ok), q);
            lane_insert(sv, sc, score_cand(sub, nov, dl, method, ok), q);
        }
        float hv;
        int hc;
        warp_merge_lanes(av, ac, tv + s2 * PC + t, tc + s2 * PC + t, TBPC, lid, hv, hc);
        warp_merge_lanes(sv, sc, tv + (B + s2) * PC + t, tc + (B + s2) * PC + t, TBPC, lid, hv, hc);
    }
    __syncthreads();
    cluster.sync();  // every CTA is running before any writes into another's slice
    PHASE(0)

    // this thread's best head key (host scan order), over the heads it
    // scans: all at first, then those of the rows it merges or rebuilds
    float kv = -kInf;
    int ka = INT_MIN, kb = INT_MIN;
    auto fold = [&](float v, int i, int j, int tb) {  // the head (v, column j) of cache row (tb, i)
        const int sub = tb / B, s = tb - sub * B;
        const int major = max(i, j) * P + min(i, j);
        const int minor = sub * (2 * B + 1) + (i < j ? s : -s) + B;
        if (key_better(v, major, minor, kv, ka, kb)) kv = v, ka = major, kb = minor;
    };
    auto scan_head = [&](int e) {
        const int tb = e / PC;
        fold(tv[e], q0 + e - tb * PC, tc[e], tb);
    };
    for (int e = tid; e < TBPC; e += nthreads) scan_head(e);

    while (cur < P) {
        // ---- A. this CTA's winner, pushed into every CTA's slice
        warp_key_max(kv, ka, kb);
        if (lid == 0) red_v[wid] = kv, red_a[wid] = ka, red_b[wid] = kb;
        __syncthreads();
        if (wid == 0) {
            float bv = lid < nwarps ? red_v[lid] : -kInf;
            int ba = lid < nwarps ? red_a[lid] : INT_MIN, bb = lid < nwarps ? red_b[lid] : INT_MIN;
            warp_key_max(bv, ba, bb);
            if (lid < C) {
                int* dst = reinterpret_cast<int*>(slice(lid) + L.parts) + 4 * me;
                dst[0] = __float_as_int(bv), dst[1] = ba, dst[2] = bb;
            }
        }
        PHASE(1)
        cluster.sync();
        PHASE(2)

        // ---- C. the cluster's winner, reduced by every warp alike
        float bv = -kInf;
        int ba = INT_MIN, bb = INT_MIN;
        if (lid < C) bv = __int_as_float(parts[4 * lid]), ba = parts[4 * lid + 1], bb = parts[4 * lid + 2];
        warp_key_max(bv, ba, bb);
        if (bv == -kInf) break;  // no valid candidate: the lane is done
        const int id1 = ba / P, id0 = ba - id1 * P;
        const int sub = bb / (2 * B + 1), shift = bb - sub * (2 * B + 1) - B;
        const int s = shift >= 0 ? shift : -shift, i = shift >= 0 ? id0 : id1, j = shift >= 0 ? id1 : id0;
        const bool same_row = i == j;
        if (tid == 0) {
            meta[cur] = commit_meta(meta, id0, id1, sub, shift, p.adder, p.carry);
            if (me == 0) {
                int32_t* r = rec + (size_t)(cur - cur0) * 4;
                r[0] = id0, r[1] = id1, r[2] = sub, r[3] = shift;
            }
        }

        // ---- substitution on every CTA's copy of the bit planes: word w of
        // rows i, j and cur in one thread; and the dirty rows' metadata
        // against this CTA's slots
        for (int e = tid; e < W + 3 * PC; e += nthreads) {
            if (e < W) {
                const int w = e;
                uint32_t* Pi = pl + i * W2;
                uint32_t* Pj = pl + j * W2;
                uint32_t* Pc = pl + cur * W2;
                const uint32_t ip = Pi[w], in = Pi[W + w], jp = Pj[w], jn = Pj[W + w], mr = mask_R[s];
                uint32_t M = 0;  // bit b: digit b of row i pairs with digit b + s of row j
                if (!same_row) {
                    const uint32_t up = jp >> s, un = jn >> s;
                    M = (sub == 1 ? (ip & un) | (in & up) : (ip & up) | (in & un)) & mr;
                } else {  // digits chain (b, b+s, b+2s): greedy ascending-bit match
                    const uint32_t cand =
                        (sub == 1 ? (ip & (in >> s)) | (in & (ip >> s)) : (ip & (ip >> s)) | (in & (in >> s))) & mr;
                    uint32_t av = ip | in;
                    for (int b = 0; b + s < B; ++b) {
                        const uint32_t ok = cand & av & (av >> s) & mask_bit[b];
                        av &= ~(ok | (ok << s));
                        M |= ok;
                    }
                }
                const uint32_t Mu = M << s;  // bit b + s: the partner digit of row j
                // the new row takes the low-id row's digits: i's at b if i < j, else j's at b + s
                Pc[w] = i < j ? ip & M : jp & Mu, Pc[W + w] = i < j ? in & M : jn & Mu;
                if (same_row) {
                    Pi[w] = ip & ~(M | Mu), Pi[W + w] = in & ~(M | Mu);
                } else {
                    Pi[w] = ip & ~M, Pi[W + w] = in & ~M;
                    Pj[w] = jp & ~Mu, Pj[W + w] = jn & ~Mu;
                }
            } else {  // meta[cur] is being written: its readers commit the pair themselves
                const int x = e - W, r = x / PC, ql = x - r * PC;
                const bool a_new = r == 2, b_new = q0 + ql == cur;
                const float4 mc = a_new || b_new ? commit_meta(meta, id0, id1, sub, shift, p.adder, p.carry) : float4{};
                const float4 a = a_new ? mc : meta[r == 0 ? i : j];
                const float4 b = b_new ? mc : meta[q0 + ql];
                novR[x] = overlap(a, b);
                dltR[x] = fabsf(__fsub_rn(a.w, b.w));
            }
        }
        __syncthreads();
        PHASE(3)

        // ---- D. recount, rescore and merge for this CTA's slots
        // dirty row r: 0 -> i, 1 -> j (skipped for i == j), 2 -> cur
        for (int e = tid; e < 3 * B * PC; e += nthreads) {
            const int r = e / (B * PC), rem = e - r * B * PC, s2 = rem / PC, ql = rem - s2 * PC;
            if (r == 1 && same_row) continue;
            const int q = q0 + ql, R = r == 0 ? i : r == 1 ? j : cur;
            int rs, rd, cs, cd;
            count_pairs<true>(pl + R * W2, pl + q * W2, W, s2, mask_R[s2], mask_C[s2], rs, rd, cs, cd);
            const float nv = novR[r * PC + ql], dl = dltR[r * PC + ql];
            const bool okR = s2 > 0 || R < q, okC = s2 > 0 || q < R;
            rowS[(r * TB + s2) * PC + ql] = score_cand(rs, nv, dl, method, okR);
            rowS[(r * TB + B + s2) * PC + ql] = score_cand(rd, nv, dl, method, okR);
            colS[(r * TB + s2) * PC + ql] = score_cand(cs, nv, dl, method, okC);
            colS[(r * TB + B + s2) * PC + ql] = score_cand(cd, nv, dl, method, okC);
        }
        __syncthreads();
        PHASE(4)
        // warps mw.. send, for each of the 3*2B dirty (row, sub, shift)
        // items, the partial top-K over this CTA's slots to the item's merger
        // (CTA item % C); then the fresh columns are merged into every other
        // row. When the merge takes one round of half the warps, warps ..mw
        // do it beside the lists (they send nothing, so they arrive at the
        // cluster barrier first); else (mw = 0) every warp does both in turn.
        // A list of up to 16 entries takes half a warp (G = 2 lists a warp).
        const int mw = TBPC <= 16 * nwarps ? (TBPC + 31) / 32 : 0, G = PC <= 16 ? 2 : 1;
        kv = -kInf, ka = INT_MIN, kb = INT_MIN;
        if (wid >= mw) {
            for (int base = G * (wid - mw); base < 3 * TB; base += G * (nwarps - mw)) {
                const int item = base + (G == 2 ? lid >> 4 : 0);
                const bool on = item < 3 * TB && !(item / TB == 1 && same_row);
                if (G == 1 && !on) continue;
                const int it = on ? item : base;
                char* merger = slice(it % C);
                float* ov = reinterpret_cast<float*>(merger + L.cv) + (it * C + me) * K;
                int* oc = reinterpret_cast<int*>(merger + L.cc) + (it * C + me) * K;
                float hv;
                int hc;
                if (G == 2)
                    pair_topk<K>(rowS + it * PC, nullptr, q0, PC, ov, oc, 1, on, lid, hv, hc);
                else
                    warp_topk<K>(rowS + it * PC, nullptr, q0, PC, ov, oc, 1, lid, hv, hc);
            }
        }
        cluster_arrive();
        if (wid < mw || mw == 0) {
            for (int e = tid; e < TBPC; e += mw ? 32 * mw : nthreads) {
                const int tb = e / PC, ql = e - tb * PC, q = q0 + ql;
                if (q == i || q == j || q == cur) continue;  // rebuilt in E
                const float fv[3] = {colS[tb * PC + ql], same_row ? -kInf : colS[(TB + tb) * PC + ql],
                                     colS[(2 * TB + tb) * PC + ql]};
                const int fc[3] = {i, same_row ? -1 : j, cur};
                merge_row<K>(tv + e, tc + e, TBPC, fv, fc);
                scan_head(e);
            }
        }
        PHASE(5)
        cluster_wait();
        PHASE(6)

        // ---- E. the dirty rows' caches, rebuilt spread over the cluster:
        // CTA me merges the C partial lists of items me, me + C, ... (a warp
        // each, or half a warp for C·K <= 16 entries), writes the row into
        // its owner's slice and folds its head into its own next argmax
        const int G2 = C * K <= 16 ? 2 : 1;
        for (int base = me + C * G2 * wid; base < 3 * TB; base += C * G2 * nwarps) {
            const int item = base + (G2 == 2 ? C * (lid >> 4) : 0);
            const bool on = item < 3 * TB && !(item / TB == 1 && same_row);
            if (G2 == 1 && !on) continue;
            const int it = on ? item : base, r = it / TB, tb = it - r * TB;
            const int R = r == 0 ? i : r == 1 ? j : cur, lr = R % PC;
            char* owner = slice(R / PC);
            float* ov = reinterpret_cast<float*>(owner + L.tv) + tb * PC + lr;
            int* oc = reinterpret_cast<int*>(owner + L.tc) + tb * PC + lr;
            float hv;
            int hc;
            if (G2 == 2)
                pair_topk<K>(cv + it * C * K, cc + it * C * K, 0, C * K, ov, oc, TBPC, on, lid, hv, hc);
            else
                warp_topk<K>(cv + it * C * K, cc + it * C * K, 0, C * K, ov, oc, TBPC, lid, hv, hc);
            if (on && (lid & 15) == 0 && (G2 == 2 || lid == 0)) fold(hv, R, hc, tb);
        }
        PHASE(7)
        ++cur;
    }
    cluster.sync();  // no CTA leaves while another may still write into its slice

    for (int e = tid; e < PC * OB; e += nthreads) {  // the digits of this CTA's rows, from the bit planes
        const int ql = e / OB, ob = e - ql * OB, o = ob / B, b = ob - o * B, w = o / F, bit = (o - w * F) * B + b;
        const uint32_t* row = pl + (q0 + ql) * W2;
        Eg[(size_t)q0 * OB + e] = (int8_t)((int)((row[w] >> bit) & 1u) - (int)((row[W + w] >> bit) & 1u));
    }
    for (int ql = tid; ql < PC; ql += nthreads) {
        const float4 m = meta[q0 + ql];
        qm[(q0 + ql) * 3] = m.x, qm[(q0 + ql) * 3 + 1] = m.y, qm[(q0 + ql) * 3 + 2] = m.z;
        lat[q0 + ql] = m.w;
    }
    if (me == 0 && tid == 0) p.cur[lane] = cur;
#ifdef FUSED_CSE_PHASES
    if (watch) {
        for (int k = 0; k < 8; ++k) p.clocks[k] += ph_acc[k];
        p.clocks[8] += cur - cur0;
    }
#endif
}

template <int K, bool kGlobal>
cudaError_t configure(int device, int C, int N, int threads, int smem_bytes, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
    // the function attributes are set when a launch first needs them on a
    // device (the largest dynamic size so far; clusters above 8), not at
    // every launch: a launch is a few microseconds of host time
    static int smem_set[kMaxDevices], nonportable_set[kMaxDevices];
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
    const void* fn = reinterpret_cast<const void*>(fused_cse_kernel<K, kGlobal>);
    if (smem_bytes > smem_set[device]) {
        const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (err != cudaSuccess) return err;
        smem_set[device] = smem_bytes;
    }
    if (C > 8 && !nonportable_set[device]) {
        const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
        nonportable_set[device] = 1;
    }
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(N * C);
    cfg->blockDim = dim3(threads);
    cfg->dynamicSmemBytes = smem_bytes;
    cfg->stream = stream;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return cudaSuccess;
}

// One instantiation's occupancy query (p null) or launch.
template <int K, bool kGlobal>
cudaError_t occupancy_or_launch(int device, const Params* p, int C, int N, int threads, int smem_bytes, cudaStream_t stream,
                                int* clusters) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = configure<K, kGlobal>(device, C, N, threads, smem_bytes, stream, &cfg, &attr);
    if (err != cudaSuccess) return err;
    if (!p) return cudaOccupancyMaxActiveClusters(clusters, fused_cse_kernel<K, kGlobal>, &cfg);
    return cudaLaunchKernelEx(&cfg, fused_cse_kernel<K, kGlobal>, *p);
}

cudaError_t dispatch(int device, const Params* p, int K, bool global, int C, int N, int threads, int smem_bytes,
                     cudaStream_t stream, int* clusters) {
    if (K == 8 && !global) return occupancy_or_launch<8, false>(device, p, C, N, threads, smem_bytes, stream, clusters);
    if (K == 8 && global) return occupancy_or_launch<8, true>(device, p, C, N, threads, smem_bytes, stream, clusters);
    if (K == 16 && !global) return occupancy_or_launch<16, false>(device, p, C, N, threads, smem_bytes, stream, clusters);
    if (K == 16 && global) return occupancy_or_launch<16, true>(device, p, C, N, threads, smem_bytes, stream, clusters);
    return cudaErrorInvalidValue;
}

Layout layout_from(const int* off) {
    return Layout{off[0], off[1], off[2], off[3], off[4], off[5], off[6], off[7], off[8], off[9]};
}

}  // namespace

extern "C" {

// Shared memory of a device in bytes: (per block with the opt-in, per SM, reserved per block).
int fused_cse_device_smem(int device, int* per_block, int* per_sm, int* reserved) {
    cudaError_t err = cudaDeviceGetAttribute(per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
    return (int)err;
}

// Clusters of this shape the device can hold at once (0: it cannot launch).
int fused_cse_active_clusters(int device, int K, int global, int C, int threads, int smem_bytes, int* clusters) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)dispatch(device, nullptr, K, global != 0, C, 1, threads, smem_bytes, 0, clusters);
}

// layout: the 10 ints of Layout, in order (fused_cse.py::slice_layout); scratch:
// the slices in global memory, or null to keep them in shared memory; clocks:
// [phases + 1] cycles per phase and iterations of a FUSED_CSE_PHASES build, else null.
int fused_cse_launch(int device, int8_t* E, float* qm, float* lat, int32_t* rec, int32_t* cur, const int32_t* method,
                     char* scratch, long long* clocks, int N, int P, int O, int B, int K, int n_iters, int adder,
                     int carry, int C, int threads, int smem_bytes, const int* layout, cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (C < 1 || C > kMaxCluster || P % C != 0 || threads < 128 || threads > (K > 8 ? kMaxThreads / 2 : kMaxThreads) ||
        threads % 32 != 0 || B < 1 || B > 32)
        return (int)cudaErrorInvalidValue;
    const int W = (O + 32 / B - 1) / (32 / B);
    Params p{E, qm, lat, rec, cur, method, scratch, clocks, P, O, B, n_iters, adder, carry, C, P / C, W,
             layout_from(layout)};
    err = dispatch(device, &p, K, scratch != nullptr, C, N, threads, smem_bytes, stream, nullptr);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* fused_cse_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
