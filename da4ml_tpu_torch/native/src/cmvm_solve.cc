// Native CMVM solver: CSD decomposition, Prim-MST kernel split, greedy CSE
// with mc/wmc(-dc/-pdc) heuristics, balanced heap adder-tree emission, and an
// OpenMP sweep over decomposition depths.
//
// Decision-identical with the Python host solver (da4ml_tpu_torch/cmvm/*.py): the
// frequency map iterates in sorted Pair order (id1, id0, sub, shift) with
// >=-argmax and the reduction heap is keyed on the same total order, so both
// implementations produce the same op list. Parity targets in the reference
// tree: src/da4ml/_binary/cmvm/{bit_decompose,mat_decompose,state_opr,
// indexers,cmvm_core,api}.cc.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <queue>
#include <stdexcept>
#include <string>
#include <tuple>
#include <vector>

#include <omp.h>

namespace da4ml_cmvm {

constexpr double INF = std::numeric_limits<double>::infinity();

struct QInt {
    double min = 0, max = 0, step = 1;
};

struct OpC {
    int32_t id0, id1, opcode;
    int64_t data;
    QInt qint;
    double latency, cost;
};

struct CombC {
    int32_t n_in = 0, n_out = 0;
    std::vector<int32_t> inp_shifts, out_idxs, out_shifts, out_negs;
    std::vector<OpC> ops;
    int32_t carry_size = -1, adder_size = -1;

    double cost() const {
        double c = 0;
        for (const auto& op : ops) c += op.cost;
        return c;
    }
    std::vector<QInt> out_qint() const {
        std::vector<QInt> out(n_out);
        for (int i = 0; i < n_out; ++i) {
            int idx = out_idxs[i];
            if (idx < 0) {
                out[i] = QInt{0, 0, 1};
                continue;
            }
            const QInt& q = ops[idx].qint;
            double sf = std::ldexp(1.0, out_shifts[i]);
            double lo = q.min * sf, hi = q.max * sf, st = q.step * sf;
            if (out_negs[i]) out[i] = QInt{-hi, -lo, st};
            else out[i] = QInt{lo, hi, st};
        }
        return out;
    }
    std::vector<double> out_latency() const {
        std::vector<double> out(n_out);
        for (int i = 0; i < n_out; ++i) out[i] = out_idxs[i] >= 0 ? ops[out_idxs[i]].latency : 0.0;
        return out;
    }
    double max_out_latency() const {
        double m = 0;
        for (int i = 0; i < n_out; ++i) m = std::max(m, out_idxs[i] >= 0 ? ops[out_idxs[i]].latency : 0.0);
        return m;
    }
};

struct PipeC {
    CombC stages[2];
    double cost() const { return stages[0].cost() + stages[1].cost(); }
};

// ------------------------------------------------------------------ CSD

// Exponent of the lowest set bit of a float32-rounded value; 127 for zero.
// (da4ml_tpu_torch/ir/lut.py lsb_loc; reference bit_decompose.cc:10-20)
inline int lsb_loc(double x) {
    if (x == 0.0) return 127;
    double xf = std::fabs(double(float(x)));
    int ex;
    double m = std::frexp(xf, &ex);
    int64_t mi = int64_t(m * double(int64_t(1) << 24));
    int tz = __builtin_ctzll(uint64_t(mi));
    return ex - 24 + tz;
}

// CSD digits (-1/0/1) of an integer array; threshold 2/3*2^n per bit plane.
// csd[idx][b] reconstructs as sum(digit * 2^b).
struct Csd {
    std::vector<int8_t> digits;  // flattened [size, n_bits]
    int n_bits = 0;
    int8_t at(size_t idx, int b) const { return digits[idx * n_bits + b]; }
};

inline Csd int_arr_to_csd(const std::vector<int64_t>& x) {
    int64_t max_val = 0;
    for (int64_t v : x) max_val = std::max<int64_t>(max_val, std::llabs(v));
    int n = std::max(int(std::ceil(std::log2(double(std::max<int64_t>(max_val, 1)) * 1.5))), 1);
    Csd out;
    out.n_bits = n;
    out.digits.assign(x.size() * n, 0);
    std::vector<int64_t> rem = x;
    for (int b = n - 1; b >= 0; --b) {
        int64_t p = int64_t(1) << b;
        int64_t thres = p * 2 / 3;
        for (size_t i = 0; i < rem.size(); ++i) {
            int8_t digit = rem[i] > thres ? 1 : (rem[i] < -thres ? -1 : 0);
            out.digits[i * n + b] = digit;
            rem[i] -= p * digit;
        }
    }
    return out;
}

// Factor per-column then per-row power-of-2 shifts so entries are odd ints.
inline void center(std::vector<double>& a, int n_in, int n_out, std::vector<int>& shift0, std::vector<int>& shift1) {
    shift1.assign(n_out, 127);
    for (int j = 0; j < n_out; ++j)
        for (int i = 0; i < n_in; ++i) shift1[j] = std::min(shift1[j], lsb_loc(a[i * n_out + j]));
    for (int j = 0; j < n_out; ++j)
        for (int i = 0; i < n_in; ++i) a[i * n_out + j] = std::ldexp(a[i * n_out + j], -shift1[j]);
    shift0.assign(n_in, 127);
    for (int i = 0; i < n_in; ++i)
        for (int j = 0; j < n_out; ++j) shift0[i] = std::min(shift0[i], lsb_loc(a[i * n_out + j]));
    for (int i = 0; i < n_in; ++i)
        for (int j = 0; j < n_out; ++j) a[i * n_out + j] = std::ldexp(a[i * n_out + j], -shift0[i]);
}

// ----------------------------------------------------------------- cost model

inline QInt qint_add(const QInt& q0, const QInt& q1, int shift, bool sub0, bool sub1) {
    double min0 = sub0 ? -q0.max : q0.min, max0 = sub0 ? -q0.min : q0.max;
    double min1 = sub1 ? -q1.max : q1.min, max1 = sub1 ? -q1.min : q1.max;
    double s = std::ldexp(1.0, shift);
    return QInt{min0 + min1 * s, max0 + max1 * s, std::min(q0.step, q1.step * s)};
}

// (latency_delta, cost) of one adder (da4ml_tpu_torch/cmvm/cost.py cost_add).
inline std::pair<double, double> cost_add(const QInt& q0, const QInt& q1, int shift, bool sub, int adder_size,
                                          int carry_size) {
    if (adder_size < 0 && carry_size < 0) return {1.0, 1.0};
    double as = adder_size < 0 ? 65535 : adder_size;
    double cs = carry_size < 0 ? 65535 : carry_size;
    double min0 = q0.min, max0 = q0.max, step0 = q0.step;
    double min1 = q1.min, max1 = q1.max, step1 = q1.step;
    if (sub) std::swap(min1, max1);
    double sf = std::ldexp(1.0, shift);
    min1 *= sf;
    max1 *= sf;
    step1 *= sf;
    max0 += step0;
    max1 += step1;
    double f = -std::log2(std::max(step0, step1));
    double i = std::ceil(std::log2(std::max({std::fabs(min0), std::fabs(min1), std::fabs(max0), std::fabs(max1)})));
    double k = (q0.min < 0 || q1.min < 0) ? 1 : 0;
    double n_accum = k + i + f;
    return {std::ceil(n_accum / cs), std::ceil(n_accum / as)};
}

inline int iceil_log2(double x) { return x > 0 ? int(std::ceil(std::log2(x))) : 0; }

// (n_overlap, n_accum) bit counts for the wmc score.
inline std::pair<int, int> overlap_and_accum(const QInt& q0, const QInt& q1) {
    double min0 = q0.min, max0 = q0.max + q0.step;
    double min1 = q1.min, max1 = q1.max + q1.step;
    int f = -iceil_log2(std::max(q0.step, q1.step));
    int i_high = iceil_log2(std::max({std::fabs(min0), std::fabs(min1), std::fabs(max0), std::fabs(max1)}));
    int i_low = iceil_log2(std::min(std::max(std::fabs(min0), std::fabs(max0)), std::max(std::fabs(min1), std::fabs(max1))));
    int k = (q0.min < 0 || q1.min < 0) ? 1 : 0;
    return {k + i_low + f, k + i_high + f};
}

// --------------------------------------------------------------- CSE state

struct PairC {
    int32_t id0, id1;
    bool sub;
    int32_t shift;
    bool operator==(const PairC& o) const { return id0 == o.id0 && id1 == o.id1 && sub == o.sub && shift == o.shift; }
};

// Sort order (id1, id0, sub, shift) — the reference's flat-vector Pair order.
struct PairLess {
    bool operator()(const PairC& a, const PairC& b) const {
        return std::tie(a.id1, a.id0, a.sub, a.shift) < std::tie(b.id1, b.id0, b.sub, b.shift);
    }
};

inline int to_shift(int v) { return std::abs(v) - 1; }
inline int to_sign(int v) { return v > 0 ? 1 : -1; }
inline int encode_digit(int shift, int sign) { return sign * (shift + 1); }

inline PairC make_pair_c(int id0, int id1, int v0, int v1) {
    bool sub = to_sign(v0) != to_sign(v1);
    return PairC{id0, id1, sub, to_shift(v1) - to_shift(v0)};
}

using FreqMap = std::map<PairC, int, PairLess>;

struct DAStateC {
    std::vector<int> shift0, shift1;
    std::vector<std::vector<std::vector<int>>> expr;  // expr[i_in][i_out] -> encoded digits
    int n_bits = 0;
    std::vector<OpC> ops;
    FreqMap freq_stat;
    int n_in = 0, n_out = 0;
};

inline void count_pairs_into(FreqMap& stat, const std::vector<PairC>& raw) {
    FreqMap counts;
    for (const auto& p : raw) counts[p] += 1;
    for (const auto& [p, c] : counts)
        if (c >= 2) stat[p] = c;
}

inline void row_pairs(std::vector<PairC>& raw, int lo, int hi, const std::vector<int>& row_lo,
                      const std::vector<int>& row_hi) {
    if (row_lo.empty() || row_hi.empty()) return;
    if (lo == hi) {
        for (size_t a = 1; a < row_lo.size(); ++a)
            for (size_t b = 0; b < a; ++b) raw.push_back(make_pair_c(lo, lo, row_lo[a], row_lo[b]));
    } else {
        for (int v0 : row_lo)
            for (int v1 : row_hi) raw.push_back(make_pair_c(lo, hi, v0, v1));
    }
}

inline DAStateC create_state(const std::vector<double>& kernel, int n_in, int n_out, const std::vector<QInt>& qintervals,
                             const std::vector<double>& inp_latencies, bool no_stat_init) {
    DAStateC st;
    st.n_in = n_in;
    st.n_out = n_out;
    std::vector<double> centered = kernel;
    center(centered, n_in, n_out, st.shift0, st.shift1);
    std::vector<int64_t> ints(centered.size());
    for (size_t i = 0; i < centered.size(); ++i) ints[i] = int64_t(std::llround(centered[i]));
    for (int i = 0; i < n_in; ++i)
        if (qintervals[i].min == 0.0 && qintervals[i].max == 0.0)
            for (int j = 0; j < n_out; ++j) ints[i * n_out + j] = 0;
    Csd csd = int_arr_to_csd(ints);
    st.n_bits = csd.n_bits;

    st.expr.resize(n_in);
    for (int i = 0; i < n_in; ++i) {
        st.expr[i].resize(n_out);
        for (int io = 0; io < n_out; ++io) {
            auto& digits = st.expr[i][io];
            for (int b = 0; b < csd.n_bits; ++b) {
                int8_t v = csd.at(size_t(i) * n_out + io, b);
                if (v != 0) digits.push_back(encode_digit(b, v));
            }
        }
    }

    if (!no_stat_init) {
        std::vector<PairC> raw;
        for (int i_out = 0; i_out < n_out; ++i_out)
            for (int i0 = 0; i0 < n_in; ++i0)
                for (int i1 = i0; i1 < n_in; ++i1) row_pairs(raw, i0, i1, st.expr[i0][i_out], st.expr[i1][i_out]);
        count_pairs_into(st.freq_stat, raw);
    }

    for (int i = 0; i < n_in; ++i) {
        double sf = std::ldexp(1.0, st.shift0[i]);
        const QInt& q = qintervals[i];
        st.ops.push_back(OpC{i, -1, -1, 0, QInt{q.min * sf, q.max * sf, q.step * sf}, inp_latencies[i], 0.0});
    }
    return st;
}

inline OpC pair_to_op(const PairC& pair, const DAStateC& st, int adder_size, int carry_size) {
    auto [dlat, cost] = cost_add(st.ops[pair.id0].qint, st.ops[pair.id1].qint, pair.shift, pair.sub, adder_size, carry_size);
    double lat = std::max(st.ops[pair.id0].latency, st.ops[pair.id1].latency) + dlat;
    QInt qint = qint_add(st.ops[pair.id0].qint, st.ops[pair.id1].qint, pair.shift, false, pair.sub);
    return OpC{pair.id0, pair.id1, pair.sub ? 1 : 0, pair.shift, qint, lat, cost};
}

inline void update_expr(DAStateC& st, const PairC& pair, int adder_size, int carry_size) {
    st.ops.push_back(pair_to_op(pair, st, adder_size, carry_size));

    int id0 = pair.id0, id1 = pair.id1, rel_shift = pair.shift;
    bool flip = false;
    if (rel_shift < 0) {
        std::swap(id0, id1);
        rel_shift = -rel_shift;
        flip = true;
    }
    int target_sign = pair.sub ? -1 : 1;

    std::vector<std::vector<int>> new_slice(st.n_out);
    for (int i_out = 0; i_out < st.n_out; ++i_out) {
        auto& row0 = st.expr[id0][i_out];
        auto& row1 = st.expr[id1][i_out];  // aliases row0 when id0 == id1
        for (size_t loc0 = 0; loc0 < row0.size(); ++loc0) {
            int v0 = row0[loc0];
            if (v0 == 0) continue;
            int s0 = to_shift(v0), g0 = to_sign(v0);
            int s1 = s0 + rel_shift;
            if (s1 >= st.n_bits) continue;
            int loc1 = -1;
            for (size_t j = 0; j < row1.size(); ++j)
                if (to_shift(row1[j]) == s1) {
                    loc1 = int(j);
                    break;
                }
            int g1 = loc1 >= 0 ? to_sign(row1[loc1]) : 0;
            if (target_sign * g1 * g0 != 1) continue;
            new_slice[i_out].push_back(flip ? encode_digit(s1, g1) : encode_digit(s0, g0));
            row0[loc0] = 0;
            row1[loc1] = 0;
        }
        auto compact = [](std::vector<int>& row) { row.erase(std::remove(row.begin(), row.end(), 0), row.end()); };
        compact(st.expr[id0][i_out]);
        if (id0 != id1) compact(st.expr[id1][i_out]);
    }
    st.expr.push_back(std::move(new_slice));
}

inline void update_stats(DAStateC& st, const PairC& pair) {
    int id0 = pair.id0, id1 = pair.id1;
    for (auto it = st.freq_stat.begin(); it != st.freq_stat.end();) {
        const PairC& p = it->first;
        if (p.id0 == id0 || p.id0 == id1 || p.id1 == id0 || p.id1 == id1)
            it = st.freq_stat.erase(it);
        else
            ++it;
    }
    int n_constructed = int(st.expr.size());
    std::vector<int> modified = {n_constructed - 1, id0};
    if (id0 != id1) modified.push_back(id1);

    std::vector<PairC> raw;
    for (int i_out = 0; i_out < st.n_out; ++i_out)
        for (int in1 = 0; in1 < n_constructed; ++in1)
            for (int in0 : modified) {
                if ((in1 == n_constructed - 1 || in1 == id0 || in1 == id1) && in0 > in1) continue;
                int lo = std::min(in0, in1), hi = std::max(in0, in1);
                row_pairs(raw, lo, hi, st.expr[lo][i_out], st.expr[hi][i_out]);
            }
    count_pairs_into(st.freq_stat, raw);
}

// --------------------------------------------------------------- heuristics

constexpr PairC PAIR_NONE{-1, -1, false, 0};

inline PairC select_pair(const DAStateC& st, const std::string& method) {
    PairC best = PAIR_NONE;
    if (method == "dummy") return best;
    if (method == "mc") {
        int max_freq = 0;
        for (const auto& [p, c] : st.freq_stat)
            if (c >= max_freq) {
                max_freq = c;
                best = p;
            }
        return best;
    }
    if (method == "mc-dc" || method == "mc-pdc") {
        bool absolute = method == "mc-dc";
        double max_score = absolute ? 0.0 : -INF;
        for (const auto& [p, c] : st.freq_stat) {
            double score = c - 1e9 * std::fabs(st.ops[p.id0].latency - st.ops[p.id1].latency);
            if (score >= max_score) {
                max_score = score;
                best = p;
            }
        }
        return best;
    }
    if (method == "wmc") {
        double max_score = 0;
        for (const auto& [p, c] : st.freq_stat) {
            auto [n_overlap, _] = overlap_and_accum(st.ops[p.id0].qint, st.ops[p.id1].qint);
            double score = double(c) * n_overlap;
            if (score >= max_score) {
                max_score = score;
                best = p;
            }
        }
        return best;
    }
    if (method == "wmc-dc" || method == "wmc-pdc") {
        bool absolute = method == "wmc-dc";
        double max_score = absolute ? 0.0 : -INF;
        for (const auto& [p, c] : st.freq_stat) {
            auto [n_overlap, _] = overlap_and_accum(st.ops[p.id0].qint, st.ops[p.id1].qint);
            double score = double(c) * n_overlap - 256 * std::fabs(st.ops[p.id0].latency - st.ops[p.id1].latency);
            if (score >= max_score) {
                max_score = score;
                best = p;
            }
        }
        return best;
    }
    throw std::runtime_error("Unknown method: " + method);
}

// ------------------------------------------------------------------- core

inline DAStateC cmvm(const std::vector<double>& kernel, int n_in, int n_out, const std::string& method,
                     const std::vector<QInt>& qintervals, const std::vector<double>& latencies, int adder_size,
                     int carry_size) {
    DAStateC st = create_state(kernel, n_in, n_out, qintervals, latencies, method == "dummy");
    while (!st.freq_stat.empty()) {
        PairC pair = select_pair(st, method);
        if (pair.id0 == -1 || pair.id1 == -1) break;
        update_expr(st, pair, adder_size, carry_size);
        update_stats(st, pair);
    }
    return st;
}

inline int left_align(const QInt& q, int shift) {
    return int(std::log2(std::max(std::fabs(q.max + q.step), std::fabs(q.min)))) + shift;
}

// Heap key (lat, sub, left_align, qmin, qmax, qstep, id, shift) — identical
// total order to the host implementation, so reductions are decision-identical.
using HeapEntry = std::tuple<double, int, int, double, double, double, int, int>;

inline CombC to_solution(const DAStateC& st, int adder_size, int carry_size) {
    std::vector<OpC> ops = st.ops;
    CombC sol;
    sol.n_in = st.n_in;
    sol.n_out = st.n_out;
    sol.carry_size = carry_size;
    sol.adder_size = adder_size;
    sol.inp_shifts.assign(st.shift0.begin(), st.shift0.end());
    int n_expr = int(st.expr.size());
    int global_id = int(ops.size());

    for (int i_out = 0; i_out < st.n_out; ++i_out) {
        std::vector<int> idx, shifts, subs;
        for (int i_in = 0; i_in < n_expr; ++i_in)
            for (int v : st.expr[i_in][i_out]) {
                idx.push_back(i_in);
                shifts.push_back(to_shift(v));
                subs.push_back(to_sign(v) == -1 ? 1 : 0);
            }
        if (idx.size() == 1) {
            sol.out_shifts.push_back(st.shift1[i_out] + shifts[0]);
            sol.out_idxs.push_back(idx[0]);
            sol.out_negs.push_back(subs[0]);
            continue;
        }
        if (idx.empty()) {
            sol.out_idxs.push_back(-1);
            sol.out_shifts.push_back(st.shift1[i_out]);
            sol.out_negs.push_back(0);
            continue;
        }
        std::priority_queue<HeapEntry, std::vector<HeapEntry>, std::greater<HeapEntry>> heap;
        for (size_t k = 0; k < idx.size(); ++k) {
            const QInt& q = ops[idx[k]].qint;
            heap.emplace(ops[idx[k]].latency, subs[k], left_align(q, shifts[k]), q.min, q.max, q.step, idx[k], shifts[k]);
        }
        while (heap.size() > 1) {
            auto [lat0, sub0, la0, qmin0, qmax0, qstep0, id0, shift0] = heap.top();
            heap.pop();
            auto [lat1, sub1, la1, qmin1, qmax1, qstep1, id1, shift1] = heap.top();
            heap.pop();
            QInt q0{qmin0, qmax0, qstep0}, q1{qmin1, qmax1, qstep1};
            OpC op;
            int result_shift;
            if (sub0) {
                int s = shift0 - shift1;
                QInt q = qint_add(q1, q0, s, sub1 != 0, true);
                auto [dlat, dcost] = cost_add(q1, q0, s, (1 ^ sub1) != 0, adder_size, carry_size);
                op = OpC{id1, id0, 1 ^ sub1, s, q, std::max(lat0, lat1) + dlat, dcost};
                result_shift = shift1;
            } else {
                int s = shift1 - shift0;
                QInt q = qint_add(q0, q1, s, false, sub1 != 0);
                auto [dlat, dcost] = cost_add(q0, q1, s, sub1 != 0, adder_size, carry_size);
                op = OpC{id0, id1, sub1, s, q, std::max(lat0, lat1) + dlat, dcost};
                result_shift = shift0;
            }
            heap.emplace(op.latency, sub0 & sub1, left_align(op.qint, result_shift), op.qint.min, op.qint.max,
                         op.qint.step, global_id, result_shift);
            ops.push_back(op);
            ++global_id;
        }
        auto [flat, fsub, fla, fqmin, fqmax, fqstep, fid, fshift] = heap.top();
        sol.out_idxs.push_back(global_id - 1);
        sol.out_negs.push_back(fsub);
        sol.out_shifts.push_back(st.shift1[i_out] + fshift);
    }
    sol.ops = std::move(ops);
    return sol;
}

inline CombC solve_single(const std::vector<double>& kernel, int n_in, int n_out, const std::string& method,
                          const std::vector<QInt>& qintervals, const std::vector<double>& latencies, int adder_size,
                          int carry_size) {
    DAStateC st = cmvm(kernel, n_in, n_out, method, qintervals, latencies, adder_size, carry_size);
    return to_solution(st, adder_size, carry_size);
}

// -------------------------------------------------------------- decompose

// Prim's MST from root 0 with optional depth constraint (decompose.py).
inline std::vector<std::pair<int, int>> prim_mst_dc(const std::vector<int64_t>& cost_mat, int n, int dc) {
    constexpr int64_t BIG = (int64_t(1) << 62) / 2;
    std::vector<double> lat_mat(size_t(n) * n);
    for (int i = 0; i < n * n; ++i) lat_mat[i] = std::ceil(std::log2(double(std::max<int64_t>(cost_mat[i], 1))));
    std::vector<int> parent(n, -2);
    parent[0] = -1;
    std::vector<int64_t> latency(n, 0);
    std::vector<std::pair<int, int>> mapping;

    double _dc = -1.0;
    if (dc >= 0) {
        int64_t max_cost0 = 0;
        for (int j = 0; j < n; ++j) max_cost0 = std::max(max_cost0, cost_mat[j]);
        _dc = (std::ldexp(1.0, dc) - 1) + std::ceil(std::log2(double(max_cost0) + 1e-32));
    }

    for (int n_impl = 1; n_impl < n; ++n_impl) {
        std::vector<int> impl, not_impl;
        for (int i = 0; i < n; ++i) (parent[i] != -2 ? impl : not_impl).push_back(i);
        // row-major argmin with strict < matches numpy's first-minimum rule
        int64_t best = std::numeric_limits<int64_t>::max();
        int bi = -1, bj = -1;
        for (size_t a = 0; a < not_impl.size(); ++a)
            for (size_t b = 0; b < impl.size(); ++b) {
                int i = not_impl[a], j = impl[b];
                int64_t c = cost_mat[size_t(i) * n + j];
                if (dc >= 0) {
                    double max_lat = std::max(lat_mat[size_t(i) * n + j], double(latency[j])) + 1;
                    if (max_lat > _dc) c = BIG;
                }
                if (c < best) {
                    best = c;
                    bi = int(a);
                    bj = int(b);
                }
            }
        int i = not_impl[bi], j = impl[bj];
        parent[i] = j;
        mapping.emplace_back(j, i);
        latency[i] = int64_t(std::max(lat_mat[size_t(i) * n + j], double(latency[j])) + 1);
    }
    return mapping;
}

// W = m0 @ m1 split via MST over (centered) columns (decompose.py kernel_decompose).
inline void kernel_decompose(const std::vector<double>& kernel, int n_in, int n_out, int dc, std::vector<double>& m0,
                             std::vector<double>& m1, int& m0_cols) {
    std::vector<double> centered = kernel;
    std::vector<int> shift0, shift1;
    center(centered, n_in, n_out, shift0, shift1);

    if (dc == -1) {
        m0.assign(size_t(n_in) * n_out, 0.0);
        for (int i = 0; i < n_in; ++i)
            for (int j = 0; j < n_out; ++j) m0[size_t(i) * n_out + j] = std::ldexp(centered[size_t(i) * n_out + j], shift0[i]);
        m1.assign(size_t(n_out) * n_out, 0.0);
        for (int j = 0; j < n_out; ++j) m1[size_t(j) * n_out + j] = std::ldexp(1.0, shift1[j]);
        m0_cols = n_out;
        return;
    }

    int na = n_out + 1;  // augmented with zero root column 0
    auto aug = [&](int i, int j) -> double { return j == 0 ? 0.0 : centered[size_t(i) * n_out + (j - 1)]; };

    // pairwise distance = min CSD weight of (col_a - col_b) vs (col_a + col_b)
    std::vector<int64_t> dist(size_t(na) * na, 0), sign_arr(size_t(na) * na, 1);
    {
        std::vector<int64_t> d0(n_in), d1(n_in);
        for (int a = 0; a < na; ++a)
            for (int b = 0; b < na; ++b) {
                for (int i = 0; i < n_in; ++i) {
                    d0[i] = int64_t(aug(i, a) - aug(i, b));
                    d1[i] = int64_t(aug(i, a) + aug(i, b));
                }
                Csd c0 = int_arr_to_csd(d0), c1 = int_arr_to_csd(d1);
                int64_t w0 = 0, w1 = 0;
                for (int8_t v : c0.digits) w0 += v != 0;
                for (int8_t v : c1.digits) w1 += v != 0;
                sign_arr[size_t(a) * na + b] = (w1 - w0 < 0) ? -1 : 1;
                dist[size_t(a) * na + b] = std::min(w0, w1);
            }
    }

    auto mapping = prim_mst_dc(dist, na, dc);

    m0.assign(size_t(n_in) * n_out, 0.0);
    m1.assign(size_t(n_out) * n_out, 0.0);
    int cnt = 0;
    std::vector<double> col1(n_out);
    for (auto [_from, _to] : mapping) {
        int64_t sgn = sign_arr[size_t(_to) * na + _from];
        bool nonzero = false;
        std::vector<double> col0(n_in);
        for (int i = 0; i < n_in; ++i) {
            col0[i] = aug(i, _to) - aug(i, _from) * double(sgn);
            nonzero |= col0[i] != 0.0;
        }
        if (_from != 0)
            for (int r = 0; r < n_out; ++r) col1[r] = m1[size_t(r) * n_out + (_from - 1)] * double(sgn);
        else
            std::fill(col1.begin(), col1.end(), 0.0);
        if (nonzero) {
            col1[cnt] = 1.0;
            for (int i = 0; i < n_in; ++i) m0[size_t(i) * n_out + cnt] = col0[i];
            ++cnt;
        }
        for (int r = 0; r < n_out; ++r) m1[size_t(r) * n_out + (_to - 1)] = col1[r];
    }
    // apply factored-out scales: m0 rows by 2^shift0, m1 rows by 2^shift1 col-wise
    for (int i = 0; i < n_in; ++i)
        for (int j = 0; j < n_out; ++j) m0[size_t(i) * n_out + j] = std::ldexp(m0[size_t(i) * n_out + j], shift0[i]);
    for (int r = 0; r < n_out; ++r)
        for (int j = 0; j < n_out; ++j) m1[size_t(r) * n_out + j] = std::ldexp(m1[size_t(r) * n_out + j], shift1[j]);
    m0_cols = n_out;
}

// ------------------------------------------------------- two-stage solve

inline double minimal_latency(const std::vector<double>& kernel, int n_in, int n_out, const std::vector<QInt>& qintervals,
                              const std::vector<double>& latencies, int carry_size, int adder_size) {
    DAStateC st = create_state(kernel, n_in, n_out, qintervals, latencies, true);
    CombC sol = to_solution(st, adder_size, carry_size);
    return sol.max_out_latency();
}

inline bool ends_with_dc(const std::string& m) { return m.size() >= 2 && m.compare(m.size() - 2, 2, "dc") == 0; }

// One two-stage solve at a fixed decompose depth (cmvm/api.py _solve).
inline PipeC solve_fixed_dc(const std::vector<double>& kernel, int n_in, int n_out, std::string method0,
                            std::string method1, int64_t hard_dc, int64_t decompose_dc,
                            const std::vector<QInt>& qintervals, const std::vector<double>& latencies, int adder_size,
                            int carry_size) {
    if (method1 == "auto") method1 = (hard_dc >= 6 || ends_with_dc(method0)) ? method0 : method0 + "-dc";
    if (hard_dc == 0 && !ends_with_dc(method0)) method0 += "-dc";

    double min_lat = INF;
    if (hard_dc >= 0) min_lat = minimal_latency(kernel, n_in, n_out, qintervals, latencies, carry_size, adder_size);
    double latency_allowed = double(hard_dc) + min_lat;

    int64_t log2_n = int64_t(std::ceil(std::log2(double(n_in))));
    decompose_dc = decompose_dc == -2 ? std::min(hard_dc, log2_n) : std::min({hard_dc, decompose_dc, log2_n});

    while (true) {
        if (decompose_dc < 0 && hard_dc >= 0) {
            if (method0 != "dummy")
                method0 = method1 = "wmc-dc";
            else
                method0 = method1 = "dummy";
        }
        std::vector<double> m0, m1;
        int m0_cols = 0;
        kernel_decompose(kernel, n_in, n_out, int(decompose_dc), m0, m1, m0_cols);
        CombC sol0 = solve_single(m0, n_in, m0_cols, method0, qintervals, latencies, adder_size, carry_size);

        std::vector<QInt> q0 = sol0.out_qint();
        std::vector<double> l0 = sol0.out_latency();
        double max_lat0 = 0;
        for (double v : l0) max_lat0 = std::max(max_lat0, v);

        if (max_lat0 > latency_allowed) {
            if (!(method0 == "wmc-dc" && method1 == "wmc-dc") || decompose_dc >= 0) {
                --decompose_dc;
                continue;
            }
        }
        CombC sol1 = solve_single(m1, m0_cols, n_out, method1, q0, l0, adder_size, carry_size);
        if (sol1.max_out_latency() > latency_allowed) {
            if (!(method0 == "wmc-dc" && method1 == "wmc-dc") || decompose_dc >= 0) {
                --decompose_dc;
                continue;
            }
        }
        PipeC out;
        out.stages[0] = std::move(sol0);
        out.stages[1] = std::move(sol1);
        return out;
    }
}

// Full solve: OpenMP sweep over dc in [-1, min(hard_dc, ceil(log2 n_in))],
// argmin by total op cost (cmvm/api.py solve; reference api.cc:194-249).
inline PipeC solve(const std::vector<double>& kernel, int n_in, int n_out, const std::string& method0,
                   const std::string& method1, int64_t hard_dc, int64_t decompose_dc, const std::vector<QInt>& qintervals,
                   const std::vector<double>& latencies, int adder_size, int carry_size, bool search_all, int n_threads) {
    if (!search_all)
        return solve_fixed_dc(kernel, n_in, n_out, method0, method1, hard_dc, decompose_dc, qintervals, latencies,
                              adder_size, carry_size);

    int64_t h = hard_dc >= 0 ? hard_dc : 1000000000;
    int64_t max_dc = std::min<int64_t>(h, int64_t(std::ceil(std::log2(double(n_in)))));
    std::vector<int64_t> try_dcs;
    for (int64_t dc = -1; dc <= max_dc; ++dc) try_dcs.push_back(dc);

    std::vector<PipeC> results(try_dcs.size());
    std::vector<std::string> errors(try_dcs.size());
    int threads = n_threads > 0 ? n_threads : omp_get_max_threads();

#pragma omp parallel for schedule(dynamic) num_threads(threads)
    for (size_t t = 0; t < try_dcs.size(); ++t) {
        try {
            results[t] = solve_fixed_dc(kernel, n_in, n_out, method0, method1, h, try_dcs[t], qintervals, latencies,
                                        adder_size, carry_size);
        } catch (const std::exception& e) {
            errors[t] = e.what();
        }
    }
    for (const auto& e : errors)
        if (!e.empty()) throw std::runtime_error(e);

    size_t best = 0;
    double best_cost = INF;
    for (size_t t = 0; t < results.size(); ++t) {
        double c = results[t].cost();
        if (c < best_cost) {
            best_cost = c;
            best = t;
        }
    }
    return std::move(results[best]);
}

}  // namespace da4ml_cmvm

// ------------------------------------------------------------------ C ABI

#define DA4ML_API extern "C" __attribute__((visibility("default")))

namespace {
void copy_err(const std::string& msg, char* err, int64_t err_len) {
    if (!err || err_len <= 0) return;
    int64_t n = std::min<int64_t>(int64_t(msg.size()), err_len - 1);
    std::memcpy(err, msg.data(), size_t(n));
    err[n] = '\0';
}
}  // namespace

// Returns an opaque PipeC handle (free with cmvm_free), or NULL on error.
DA4ML_API void* cmvm_solve(const double* kernel, int64_t n_in, int64_t n_out, const char* method0, const char* method1,
                           int64_t hard_dc, int64_t decompose_dc, const double* qintervals /* n_in x 3 */,
                           const double* latencies /* n_in */, int64_t adder_size, int64_t carry_size,
                           int64_t search_all, int64_t n_threads, char* err, int64_t err_len) {
    try {
        std::vector<double> k(kernel, kernel + n_in * n_out);
        std::vector<da4ml_cmvm::QInt> qints(static_cast<size_t>(n_in));
        for (int64_t i = 0; i < n_in; ++i)
            qints[i] = da4ml_cmvm::QInt{qintervals[i * 3], qintervals[i * 3 + 1], qintervals[i * 3 + 2]};
        std::vector<double> lats(latencies, latencies + n_in);
        auto* res = new da4ml_cmvm::PipeC(da4ml_cmvm::solve(k, int(n_in), int(n_out), method0, method1, hard_dc,
                                                            decompose_dc, qints, lats, int(adder_size), int(carry_size),
                                                            search_all != 0, int(n_threads)));
        return res;
    } catch (const std::exception& e) {
        copy_err(e.what(), err, err_len);
        return nullptr;
    }
}

// Stage geometry: n_in, n_out, n_ops of stage 0 or 1.
DA4ML_API int cmvm_stage_shape(void* handle, int64_t stage, int64_t* n_in, int64_t* n_out, int64_t* n_ops) {
    if (!handle || stage < 0 || stage > 1) return 1;
    const auto& s = static_cast<da4ml_cmvm::PipeC*>(handle)->stages[stage];
    *n_in = s.n_in;
    *n_out = s.n_out;
    *n_ops = int64_t(s.ops.size());
    return 0;
}

// Fill caller-allocated buffers: ops as n_ops x 9 doubles
// [id0, id1, opcode, data, qmin, qmax, qstep, latency, cost].
DA4ML_API int cmvm_stage_fill(void* handle, int64_t stage, double* ops9, int32_t* inp_shifts, int32_t* out_idxs,
                              int32_t* out_shifts, int32_t* out_negs) {
    if (!handle || stage < 0 || stage > 1) return 1;
    const auto& s = static_cast<da4ml_cmvm::PipeC*>(handle)->stages[stage];
    for (size_t i = 0; i < s.ops.size(); ++i) {
        const auto& op = s.ops[i];
        double* row = ops9 + i * 9;
        row[0] = op.id0;
        row[1] = op.id1;
        row[2] = op.opcode;
        row[3] = double(op.data);
        row[4] = op.qint.min;
        row[5] = op.qint.max;
        row[6] = op.qint.step;
        row[7] = op.latency;
        row[8] = op.cost;
    }
    std::copy(s.inp_shifts.begin(), s.inp_shifts.end(), inp_shifts);
    std::copy(s.out_idxs.begin(), s.out_idxs.end(), out_idxs);
    std::copy(s.out_shifts.begin(), s.out_shifts.end(), out_shifts);
    std::copy(s.out_negs.begin(), s.out_negs.end(), out_negs);
    return 0;
}

DA4ML_API void cmvm_free(void* handle) { delete static_cast<da4ml_cmvm::PipeC*>(handle); }

// ------------------------------------------------- device-search host side
//
// The device search (cmvm/torch_search.py) returns per-lane greedy *decisions*
// (op records) and final CSD digit tensors; rebuilding f64 op metadata and
// running the adder-tree emission (to_solution) is the host-side tail. These
// batched entry points run that tail in C++ with OpenMP over lanes.

// geo: n_lanes x 4 int64 = (ni, no, nb, n_add). Flat per-lane data follows
// the same lane order with implicit prefix offsets:
//   shift0s: ni int32        shift1s: no int32
//   qints:   ni x 3 f64      lats:    ni f64
//   E:       (ni+n_add) x no x nb int8 (digit in {-1,0,+1})
//   recs:    n_add x 4 int32 = (id0, id1, sub, shift), lane-local ids
// Returns an opaque std::vector<CombC>* (free with cmvm_emit_free).
DA4ML_API void* cmvm_emit_batch(int64_t n_lanes, const int64_t* geo, const int32_t* shift0s, const int32_t* shift1s,
                                const double* qints, const double* lats, const int8_t* E, const int32_t* recs,
                                int64_t adder_size, int64_t carry_size, int64_t n_threads, char* err, int64_t err_len) {
    using namespace da4ml_cmvm;
    try {
        std::vector<int64_t> off_in(n_lanes + 1, 0), off_out(n_lanes + 1, 0), off_E(n_lanes + 1, 0),
            off_rec(n_lanes + 1, 0);
        for (int64_t l = 0; l < n_lanes; ++l) {
            int64_t ni = geo[l * 4], no = geo[l * 4 + 1], nb = geo[l * 4 + 2], na = geo[l * 4 + 3];
            off_in[l + 1] = off_in[l] + ni;
            off_out[l + 1] = off_out[l] + no;
            off_E[l + 1] = off_E[l] + (ni + na) * no * nb;
            off_rec[l + 1] = off_rec[l] + na;
        }
        auto* out = new std::vector<CombC>(size_t(n_lanes));
        std::vector<std::string> errors(static_cast<size_t>(n_lanes));
        int threads = n_threads > 0 ? int(n_threads) : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic) num_threads(threads)
        for (int64_t l = 0; l < n_lanes; ++l) {
            try {
                int ni = int(geo[l * 4]), no = int(geo[l * 4 + 1]), nb = int(geo[l * 4 + 2]), na = int(geo[l * 4 + 3]);
                DAStateC st;
                st.n_in = ni;
                st.n_out = no;
                st.n_bits = nb;
                st.shift0.assign(shift0s + off_in[l], shift0s + off_in[l] + ni);
                st.shift1.assign(shift1s + off_out[l], shift1s + off_out[l] + no);
                const double* q = qints + off_in[l] * 3;
                const double* la = lats + off_in[l];
                for (int i = 0; i < ni; ++i) {
                    double sf = std::ldexp(1.0, st.shift0[i]);
                    st.ops.push_back(
                        OpC{i, -1, -1, 0, QInt{q[i * 3] * sf, q[i * 3 + 1] * sf, q[i * 3 + 2] * sf}, la[i], 0.0});
                }
                const int32_t* r = recs + off_rec[l] * 4;
                for (int t = 0; t < na; ++t) {
                    PairC p{r[t * 4], r[t * 4 + 1], r[t * 4 + 2] != 0, r[t * 4 + 3]};
                    st.ops.push_back(pair_to_op(p, st, int(adder_size), int(carry_size)));
                }
                const int8_t* e = E + off_E[l];
                st.expr.resize(size_t(ni + na));
                for (int p = 0; p < ni + na; ++p) {
                    st.expr[p].resize(no);
                    for (int io = 0; io < no; ++io) {
                        auto& digits = st.expr[p][io];
                        for (int b = 0; b < nb; ++b) {
                            int8_t v = e[(size_t(p) * no + io) * nb + b];
                            if (v != 0) digits.push_back(encode_digit(b, v));
                        }
                    }
                }
                (*out)[l] = to_solution(st, int(adder_size), int(carry_size));
            } catch (const std::exception& ex) {
                errors[l] = ex.what();
            }
        }
        for (const auto& e : errors)
            if (!e.empty()) {
                delete out;
                copy_err(e, err, err_len);
                return nullptr;
            }
        return out;
    } catch (const std::exception& e) {
        copy_err(e.what(), err, err_len);
        return nullptr;
    }
}

DA4ML_API int cmvm_emit_shape(void* handle, int64_t lane, int64_t* n_in, int64_t* n_out, int64_t* n_ops) {
    if (!handle) return 1;
    auto& v = *static_cast<std::vector<da4ml_cmvm::CombC>*>(handle);
    if (lane < 0 || size_t(lane) >= v.size()) return 1;
    *n_in = v[lane].n_in;
    *n_out = v[lane].n_out;
    *n_ops = int64_t(v[lane].ops.size());
    return 0;
}

DA4ML_API int cmvm_emit_fill(void* handle, int64_t lane, double* ops9, int32_t* inp_shifts, int32_t* out_idxs,
                             int32_t* out_shifts, int32_t* out_negs) {
    if (!handle) return 1;
    auto& v = *static_cast<std::vector<da4ml_cmvm::CombC>*>(handle);
    if (lane < 0 || size_t(lane) >= v.size()) return 1;
    const auto& s = v[lane];
    for (size_t i = 0; i < s.ops.size(); ++i) {
        const auto& op = s.ops[i];
        double* row = ops9 + i * 9;
        row[0] = op.id0;
        row[1] = op.id1;
        row[2] = op.opcode;
        row[3] = double(op.data);
        row[4] = op.qint.min;
        row[5] = op.qint.max;
        row[6] = op.qint.step;
        row[7] = op.latency;
        row[8] = op.cost;
    }
    std::copy(s.inp_shifts.begin(), s.inp_shifts.end(), inp_shifts);
    std::copy(s.out_idxs.begin(), s.out_idxs.end(), out_idxs);
    std::copy(s.out_shifts.begin(), s.out_shifts.end(), out_shifts);
    std::copy(s.out_negs.begin(), s.out_negs.end(), out_negs);
    return 0;
}

DA4ML_API void cmvm_emit_free(void* handle) { delete static_cast<std::vector<da4ml_cmvm::CombC>*>(handle); }

// Batched kernel decomposition: lane l reads kernels[koff[l] .. koff[l]+ni*no)
// (row-major ni x no) and writes m0 (ni x no) / m1 (no x no) at the same
// layout into m0_out/m1_out (caller-allocated, same offsets / no*no offsets).
DA4ML_API int cmvm_decompose_batch(int64_t n_lanes, const int64_t* geo /* n_lanes x 3: ni,no,dc */,
                                   const double* kernels, double* m0_out, double* m1_out, int64_t n_threads, char* err,
                                   int64_t err_len) {
    using namespace da4ml_cmvm;
    try {
        std::vector<int64_t> off_k(n_lanes + 1, 0), off_m1(n_lanes + 1, 0);
        for (int64_t l = 0; l < n_lanes; ++l) {
            int64_t ni = geo[l * 3], no = geo[l * 3 + 1];
            off_k[l + 1] = off_k[l] + ni * no;
            off_m1[l + 1] = off_m1[l] + no * no;
        }
        std::vector<std::string> errors(static_cast<size_t>(n_lanes));
        int threads = n_threads > 0 ? int(n_threads) : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic) num_threads(threads)
        for (int64_t l = 0; l < n_lanes; ++l) {
            try {
                int ni = int(geo[l * 3]), no = int(geo[l * 3 + 1]), dc = int(geo[l * 3 + 2]);
                std::vector<double> k(kernels + off_k[l], kernels + off_k[l + 1]);
                std::vector<double> m0, m1;
                int m0_cols = 0;
                kernel_decompose(k, ni, no, dc, m0, m1, m0_cols);
                std::copy(m0.begin(), m0.end(), m0_out + off_k[l]);
                std::copy(m1.begin(), m1.end(), m1_out + off_m1[l]);
            } catch (const std::exception& ex) {
                errors[l] = ex.what();
            }
        }
        for (const auto& e : errors)
            if (!e.empty()) {
                copy_err(e, err, err_len);
                return 1;
            }
        return 0;
    } catch (const std::exception& e) {
        copy_err(e.what(), err, err_len);
        return 1;
    }
}
