// K2: the whole greedy CSE loop of the device CMVM search, one thread block
// per lane, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel da4ml_tpu/cmvm/fused_cse.py::_build_pallas_loop
// (pallas_call at fused_cse.py:460), which runs the same loop for a block of
// lanes with all state in VMEM. Its plain version is
// da4ml_tpu_torch/cmvm/torch_search.py::greedy_plain; the wrapper is
// da4ml_tpu_torch/cmvm/fused_cse.py.
//
// Per iteration a block
//   1. takes the host-order argmax over the rank-0 score cache entries
//      (max score, then max id-major, then max minor key);
//   2. substitutes the pair in the lane's int8 digit planes (the i == j bit
//      chain matched ascending) and places the new row at slot `cur`;
//   3. commits the new slot's interval, latency and op record (thread 0);
//   4. recounts the pairs touching rows {i, j, cur} exactly, walking each
//      dirty row's nonzero digits against every slot at every shift, and
//      rescores them;
//   5. merges the three fresh columns into every other row's top-K cache
//      (stale columns dropped) and rebuilds the three dirty rows' caches
//      with a k-pass top-K, one warp per (row, sub, shift).
// __syncthreads() separates the phases. A lane stops when it has no valid
// candidate or its next slot reaches P (frozen, resumed at the next rung with
// a fresh cache); a padding lane enters at cur == P and does nothing.
//
// Bound: the work of an iteration is small (the flagship's largest class has
// 2B*P = 3072 cache heads and dirty rows of a few dozen digits), so the kernel
// is bound by the serial chain of dependent iterations of a lane on one SM,
// not by bytes or operations: the flagship's rungs launch 1-6 lane blocks
// for 132 SMs. The digits live in shared memory when P*O*B fits, the cache,
// metadata and scores in global memory, which the 50 MB L2 holds. Batching
// lanes across layers into one launch, or a thread-block cluster per lane,
// is later work.
//
// Numerics follow the plain version exactly: counts are integers; scores and
// metadata use the same float32 operations in the same order, each rounded
// on its own (built with -fmad=false, and written with __fmul_rn/__fadd_rn);
// ceil(log2 x) is taken exactly from the exponent (frexpf), 2^shift from the
// exponent bits; log2f only for a step that is not a power of two.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kInf = __builtin_huge_valf();

struct Params {
    int8_t* E;             // [N][P][O*B] digits (in/out)
    float* qm;             // [N][P][3] lo, hi, step (in/out)
    float* lat;            // [N][P] latency (in/out)
    float* tv;             // [N][2B][P][K] cache scores (scratch)
    int32_t* tc;           // [N][2B][P][K] cache columns (scratch)
    int32_t* rec;          // [N][n_iters][4] op records (out, zeroed)
    int32_t* cur;          // [N] next free slot (in/out)
    const int32_t* method; // [N]
    float* rows;           // [N][3][2B][P] scratch: dirty-row scores
    float* meta;           // [N][2][3][P] scratch: n_overlap and |dlat| of the dirty rows
    int P, O, B, n_iters, adder, carry, smem_E;
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
__device__ float overlap(float lo0, float hi0, float st0, float lo1, float hi1, float st1) {
    float max0 = __fadd_rn(hi0, st0);
    float max1 = __fadd_rn(hi1, st1);
    float f = -iceil_log2(fmaxf(st0, st1));
    float il = iceil_log2(fminf(fmaxf(fabsf(lo0), fabsf(max0)), fmaxf(fabsf(lo1), fabsf(max1))));
    float k = (lo0 < 0.0f || lo1 < 0.0f) ? 1.0f : 0.0f;
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

template <int K>
__global__ void __launch_bounds__(kThreads) fused_cse_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red_v[kWarps];
    __shared__ int red_a[kWarps], red_b[kWarps];
    __shared__ int sh_any, sh_sub, sh_s, sh_i, sh_j;
    __shared__ int nz_cnt[3];
    __shared__ float qR[3][4];

    const int lane = blockIdx.x, tid = threadIdx.x, wid = tid >> 5, lid = tid & 31;
    const int P = p.P, O = p.O, B = p.B, OB = O * B, TB = 2 * B;
    int cur = p.cur[lane];
    if (cur >= P) return;  // padding or frozen lane: nothing to do
    if (P - cur > p.n_iters) return;  // its records would not fit (the wrapper raises before the launch)
    const int cur0 = cur;
    const int method = p.method[lane];

    int8_t* Eg = p.E + (size_t)lane * P * OB;
    float* qm = p.qm + (size_t)lane * P * 3;
    float* lat = p.lat + (size_t)lane * P;
    float* tv = p.tv + (size_t)lane * TB * P * K;
    int32_t* tc = p.tc + (size_t)lane * TB * P * K;
    int32_t* rec = p.rec + (size_t)lane * p.n_iters * 4;
    float* rowS = p.rows + (size_t)lane * 3 * TB * P;
    float* novR = p.meta + (size_t)lane * 6 * P;
    float* dltR = novR + 3 * P;

    // shared memory: [digits when they fit] row_i row_j M Mup avail | nz_ob nz_d
    size_t off = 0;
    int8_t* E = Eg;
    if (p.smem_E) {
        E = reinterpret_cast<int8_t*>(smem);
        off = ((size_t)P * OB + 15) & ~(size_t)15;
        for (int e = tid; e < P * OB; e += kThreads) E[e] = Eg[e];
    }
    int8_t* row_i = reinterpret_cast<int8_t*>(smem + off);
    int8_t* row_j = row_i + OB;
    int8_t* Mm = row_j + OB;
    int8_t* Mup = Mm + OB;
    int8_t* avail = Mup + OB;
    int8_t* nz_d = avail + OB;  // [3][OB]
    int16_t* nz_ob = reinterpret_cast<int16_t*>(smem + ((off + 8 * (size_t)OB + 15) & ~(size_t)15));  // [3][OB]
    __syncthreads();

    while (cur < P) {
        // ---- 1. host-order argmax over the rank-0 cache entries
        float bv = -kInf;
        int ba = INT_MIN, bb = INT_MIN;
        for (int e = tid; e < TB * P; e += kThreads) {
            const int tb = e / P, i = e - tb * P;
            const float v = tv[(size_t)e * K];
            const int j = tc[(size_t)e * K];
            const int sub = tb / B, s = tb - sub * B;
            const int major = max(i, j) * P + min(i, j);
            const int minor = sub * (2 * B + 1) + (i < j ? s : -s) + B;
            if (key_better(v, major, minor, bv, ba, bb)) bv = v, ba = major, bb = minor;
        }
        for (int o = 16; o > 0; o >>= 1) {
            float v = __shfl_down_sync(0xffffffffu, bv, o);
            int a = __shfl_down_sync(0xffffffffu, ba, o), b = __shfl_down_sync(0xffffffffu, bb, o);
            if (key_better(v, a, b, bv, ba, bb)) bv = v, ba = a, bb = b;
        }
        if (lid == 0) red_v[wid] = bv, red_a[wid] = ba, red_b[wid] = bb;
        __syncthreads();
        if (wid == 0) {
            bv = lid < kWarps ? red_v[lid] : -kInf;
            ba = lid < kWarps ? red_a[lid] : INT_MIN;
            bb = lid < kWarps ? red_b[lid] : INT_MIN;
            for (int o = 16; o > 0; o >>= 1) {
                float v = __shfl_down_sync(0xffffffffu, bv, o);
                int a = __shfl_down_sync(0xffffffffu, ba, o), b = __shfl_down_sync(0xffffffffu, bb, o);
                if (key_better(v, a, b, bv, ba, bb)) bv = v, ba = a, bb = b;
            }
            if (lid == 0) {
                sh_any = bv != -kInf;
                const int id1 = ba / P, id0 = ba - id1 * P;
                const int sub = bb / (2 * B + 1), shift = bb - sub * (2 * B + 1) - B;
                sh_sub = sub;
                sh_s = shift >= 0 ? shift : -shift;
                sh_i = shift >= 0 ? id0 : id1;
                sh_j = shift >= 0 ? id1 : id0;
            }
        }
        __syncthreads();
        if (!sh_any) break;
        const int sub = sh_sub, s = sh_s, i = sh_i, j = sh_j;
        const bool same_row = i == j;
        const int target = sub == 1 ? -1 : 1;

        // ---- 2. substitution
        for (int ob = tid; ob < OB; ob += kThreads) {
            row_i[ob] = E[(size_t)i * OB + ob];
            row_j[ob] = E[(size_t)j * OB + ob];
            avail[ob] = E[(size_t)i * OB + ob] != 0;
        }
        __syncthreads();
        if (!same_row) {
            for (int ob = tid; ob < OB; ob += kThreads) {
                const int b = ob % B, ri = row_i[ob];
                const int sj = b + s < B ? row_j[ob + s] : 0;
                Mm[ob] = ri != 0 && sj != 0 && ri * sj == target;
            }
        } else {  // digits chain (b, b+s, b+2s): greedy ascending-bit match
            for (int o = tid; o < O; o += kThreads) {
                int8_t* av = avail + o * B;
                const int8_t* ri = row_i + o * B;
                for (int b = 0; b < B; ++b) {
                    bool ok = false;
                    if (b + s < B) {
                        const int x = ri[b], y = ri[b + s];
                        ok = x != 0 && y != 0 && x * y == target && av[b] && av[b + s];
                    }
                    if (ok) av[b] = 0, av[b + s] = 0;
                    Mm[o * B + b] = ok;
                }
            }
        }
        __syncthreads();
        for (int ob = tid; ob < OB; ob += kThreads) {
            const int b = ob % B;
            Mup[ob] = b >= s ? Mm[ob - s] : 0;
        }
        __syncthreads();
        for (int ob = tid; ob < OB; ob += kThreads) {
            const int8_t ri = row_i[ob], rj = row_j[ob];
            const bool m = Mm[ob], mu = Mup[ob];
            if (same_row) {
                E[(size_t)i * OB + ob] = (m || mu) ? 0 : ri;
            } else {
                E[(size_t)i * OB + ob] = m ? 0 : ri;
                E[(size_t)j * OB + ob] = mu ? 0 : rj;
            }
            E[(size_t)cur * OB + ob] = i < j ? (m ? ri : 0) : (mu ? rj : 0);
        }

        // ---- 3. the new slot's metadata and op record
        if (tid == 0) {
            const int id0 = min(i, j), id1 = max(i, j), shift = i < j ? s : -s;
            const float sp = pow2f(shift);
            const float lo0 = qm[id0 * 3], hi0 = qm[id0 * 3 + 1], st0 = qm[id0 * 3 + 2];
            const float lo1 = qm[id1 * 3], hi1 = qm[id1 * 3 + 1], st1 = qm[id1 * 3 + 2];
            const bool is_sub = sub == 1;
            const float dl = cost_add_lat(lo0, hi0, st0, lo1, hi1, st1, sp, is_sub, p.adder, p.carry);
            lat[cur] = __fadd_rn(fmaxf(lat[id0], lat[id1]), dl);
            qm[cur * 3] = __fadd_rn(lo0, __fmul_rn(is_sub ? -hi1 : lo1, sp));
            qm[cur * 3 + 1] = __fadd_rn(hi0, __fmul_rn(is_sub ? -lo1 : hi1, sp));
            qm[cur * 3 + 2] = fminf(st0, __fmul_rn(st1, sp));
            int32_t* r = rec + (size_t)(cur - cur0) * 4;
            r[0] = id0, r[1] = id1, r[2] = sub, r[3] = shift;
        }
        __syncthreads();

        // ---- 4a. nonzero digits of the dirty rows (one warp each) and their metadata
        const int R[3] = {i, j, cur};
        if (wid < 3) {
            const int8_t* row = E + (size_t)R[wid] * OB;
            int n = 0;
            for (int b0 = 0; b0 < OB; b0 += 32) {
                const int ob = b0 + lid;
                const int d = ob < OB ? row[ob] : 0;
                const unsigned mask = __ballot_sync(0xffffffffu, d != 0);
                if (d != 0) {
                    const int at = wid * OB + n + __popc(mask & ((1u << lid) - 1u));
                    nz_ob[at] = (int16_t)ob;
                    nz_d[at] = (int8_t)d;
                }
                n += __popc(mask);
            }
            if (lid == 0) {
                nz_cnt[wid] = n;
                qR[wid][0] = qm[R[wid] * 3], qR[wid][1] = qm[R[wid] * 3 + 1];
                qR[wid][2] = qm[R[wid] * 3 + 2], qR[wid][3] = lat[R[wid]];
            }
        }
        __syncthreads();
        for (int e = tid; e < 3 * P; e += kThreads) {
            const int r = e / P, q = e - r * P;
            novR[e] = overlap(qR[r][0], qR[r][1], qR[r][2], qm[q * 3], qm[q * 3 + 1], qm[q * 3 + 2]);
            dltR[e] = fabsf(__fsub_rn(qR[r][3], lat[q]));
        }
        __syncthreads();

        // ---- 4b/5a. per (shift s2, slot q): recount, rescore, merge column q
        for (int e = tid; e < B * P; e += kThreads) {
            const int s2 = e / P, q = e - s2 * P;
            const int8_t* Eq = E + (size_t)q * OB;
            float cs[3][2];
            for (int r = 0; r < 3; ++r) {
                int rs = 0, rd = 0, cs_ = 0, cd = 0;
                const int n = nz_cnt[r];
                for (int t = 0; t < n; ++t) {
                    const int ob = nz_ob[r * OB + t], d = nz_d[r * OB + t], b = ob % B;
                    if (b + s2 < B) {  // row R first at bit b, slot q second at b + s2
                        const int x = d * Eq[ob + s2];
                        rs += x == 1, rd += x == -1;
                    }
                    if (b >= s2) {  // slot q first at bit b - s2, row R second at b
                        const int x = d * Eq[ob - s2];
                        cs_ += x == 1, cd += x == -1;
                    }
                }
                const float nov = novR[r * P + q], dl = dltR[r * P + q];
                const bool okR = s2 > 0 || R[r] < q, okC = s2 > 0 || q < R[r];
                rowS[((size_t)r * TB + s2) * P + q] = score_cand(rs, nov, dl, method, okR);
                rowS[((size_t)r * TB + B + s2) * P + q] = score_cand(rd, nov, dl, method, okR);
                cs[r][0] = score_cand(cs_, nov, dl, method, okC);
                cs[r][1] = score_cand(cd, nov, dl, method, okC);
            }
            if (q == i || q == j || q == cur) continue;  // rebuilt below
            const int col[3] = {i, same_row ? -1 : j, cur};
            for (int sb = 0; sb < 2; ++sb) {
                // the fresh live candidates, sorted (score desc, col desc);
                // a duplicate fresh column (i == j) is dead
                float fv[3];
                int fc[3], nf = 0;
                for (int r = 0; r < 3; ++r) {
                    const float v = (r == 1 && same_row) ? -kInf : cs[r][sb];
                    if (v == -kInf) continue;
                    int at = nf++;
                    while (at > 0 && cand_better(v, col[r], fv[at - 1], fc[at - 1])) {
                        fv[at] = fv[at - 1], fc[at] = fc[at - 1];
                        --at;
                    }
                    fv[at] = v, fc[at] = col[r];
                }
                // merge with the cached live entries (sorted, stale columns dropped)
                const size_t base = ((size_t)(sb * B + s2) * P + q) * K;
                float ov[K];
                int oc[K];
#pragma unroll
                for (int k = 0; k < K; ++k) ov[k] = tv[base + k], oc[k] = tc[base + k];
                int a = 0, f = 0;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    while (a < K && (ov[a] == -kInf || oc[a] == i || oc[a] == j || oc[a] == cur)) ++a;
                    const bool have_a = a < K, have_f = f < nf;
                    float v = -kInf;
                    int c = -1;
                    if (have_a && (!have_f || cand_better(ov[a], oc[a], fv[f], fc[f]))) {
                        v = ov[a], c = oc[a], ++a;
                    } else if (have_f) {
                        v = fv[f], c = fc[f], ++f;
                    }
                    tv[base + k] = v;
                    tc[base + k] = c;
                }
            }
        }
        __syncthreads();

        // ---- 5b. rebuild the dirty rows' caches: k-pass top-K, one warp per (row, sub, shift)
        for (int item = wid; item < 3 * TB; item += kWarps) {
            const int r = item / TB, tb = item - r * TB;
            if (r == 1 && same_row) continue;  // identical to row 0
            const float* row = rowS + ((size_t)r * TB + tb) * P;
            const size_t base = ((size_t)tb * P + R[r]) * K;
            float lv = kInf;
            int lc = INT_MAX;
            for (int k = 0; k < K; ++k) {
                float v = -kInf;
                int c = -1;
                for (int q = lid; q < P; q += 32) {  // the best entry strictly after (lv, lc)
                    const float x = row[q];
                    if (x != -kInf && cand_better(lv, lc, x, q) && cand_better(x, q, v, c)) v = x, c = q;
                }
                for (int o = 16; o > 0; o >>= 1) {
                    const float v2 = __shfl_down_sync(0xffffffffu, v, o);
                    const int c2 = __shfl_down_sync(0xffffffffu, c, o);
                    if (cand_better(v2, c2, v, c)) v = v2, c = c2;
                }
                v = __shfl_sync(0xffffffffu, v, 0);
                c = __shfl_sync(0xffffffffu, c, 0);
                if (lid == 0) tv[base + k] = v, tc[base + k] = v == -kInf ? -1 : c;
                lv = v, lc = c;
            }
        }
        __syncthreads();
        ++cur;
    }

    if (p.smem_E) {
        for (int e = tid; e < P * OB; e += kThreads) Eg[e] = E[e];
    }
    if (tid == 0) p.cur[lane] = cur;
}

size_t small_smem(int OB) { return (((size_t)8 * OB + 15) & ~(size_t)15) + (size_t)6 * OB + 16; }

// Dynamic shared-memory bytes of one launch, and whether the digits live there.
cudaError_t launch_smem(int device, int P, int O, int B, int* smem_bytes, int* smem_E) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    const size_t small = small_smem(O * B);
    const size_t with_E = (((size_t)P * O * B + 15) & ~(size_t)15) + small;
    // headroom for the static arrays of the kernel
    *smem_E = with_E + 1024 <= (size_t)optin;
    *smem_bytes = (int)(*smem_E ? with_E : small);
    return cudaSuccess;
}

}  // namespace

extern "C" {

int fused_cse_launch(int device, int8_t* E, float* qm, float* lat, float* tv, int32_t* tc, int32_t* rec, int32_t* cur,
                     const int32_t* method, float* rows, float* meta, int N, int P, int O, int B, int K, int n_iters,
                     int adder, int carry, cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int smem = 0, smem_E = 0;
    err = launch_smem(device, P, O, B, &smem, &smem_E);
    if (err != cudaSuccess) return (int)err;
    Params p{E, qm, lat, tv, tc, rec, cur, method, rows, meta, P, O, B, n_iters, adder, carry, smem_E};
    if (K == 8) {
        err = cudaFuncSetAttribute(fused_cse_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        fused_cse_kernel<8><<<N, kThreads, smem, stream>>>(p);
    } else if (K == 16) {
        err = cudaFuncSetAttribute(fused_cse_kernel<16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        fused_cse_kernel<16><<<N, kThreads, smem, stream>>>(p);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

const char* fused_cse_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
