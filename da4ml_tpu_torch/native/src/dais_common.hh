// Shared integer semantics for the native DAIS interpreter.
//
// Bit-exact with the Python/NumPy reference backend
// (da4ml_tpu_torch/runtime/numpy_backend.py) and, transitively, with the reference
// C++ interpreter semantics (reference: src/da4ml/_binary/dais/
// DAISInterpreter.cc): two's-complement int64, arithmetic shifts, modular
// wrap into the annotated width.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace da4ml {

// v << s for s >= 0, arithmetic v >> -s otherwise. Left shifts go through
// uint64 so overflow wraps mod 2^64 (matching NumPy int64) instead of UB.
inline int64_t shl(int64_t v, int64_t s) {
    if (s >= 0) {
        if (s >= 64) return 0;
        return static_cast<int64_t>(static_cast<uint64_t>(v) << s);
    }
    s = -s;
    if (s >= 64) return v < 0 ? -1 : 0;
    return v >> s;
}

// Two's-complement wrap of v into `width` bits; unsigned wrap when !is_signed.
// Equivalent to ((v - int_min) mod 2^width) + int_min with Python modulo.
inline int64_t wrap(int64_t v, bool is_signed, int64_t width) {
    if (width <= 0) return 0;
    if (width >= 64) return v;
    const uint64_t mask = (uint64_t(1) << width) - 1;
    uint64_t u = static_cast<uint64_t>(v) & mask;
    if (is_signed && ((u >> (width - 1)) & 1)) u |= ~mask;
    return static_cast<int64_t>(u);
}

inline int64_t quantize(int64_t v, int64_t f_from, bool signed_to, int64_t width_to, int64_t f_to) {
    return wrap(shl(v, f_to - f_from), signed_to, width_to);
}

// MSB of the two's-complement representation: sign bit for signed values,
// top data bit for unsigned ones.
inline bool msb(int64_t v, bool is_signed, int64_t width) {
    if (is_signed) return v < 0;
    if (width <= 0) return false;
    if (width >= 64) return v < 0;  // top bit of the 64-bit pattern
    return v >= (int64_t(1) << (width - 1));
}

// Decoded DAIS program, struct-of-arrays (mirrors ir/dais_binary.py).
struct DaisProgram {
    int32_t n_in = 0, n_out = 0, n_ops = 0, n_tables = 0;
    std::vector<int32_t> inp_shifts, out_idxs, out_shifts, out_negs;
    std::vector<int32_t> opcode, id0, id1, data_lo, data_hi, is_signed, integers, fractionals;
    std::vector<std::vector<int32_t>> tables;

    int32_t width(int i) const { return is_signed[i] + integers[i] + fractionals[i]; }

    // Parse the flat int32 DAIS v1 stream (spec: docs/dais.md in this repo).
    static DaisProgram from_binary(const int32_t* bin, int64_t len) {
        if (len < 6) throw std::runtime_error("Binary data too small to contain a DAIS program");
        if (bin[0] != 1) throw std::runtime_error("DAIS version mismatch: expected 1, got " + std::to_string(bin[0]));
        DaisProgram p;
        p.n_in = bin[2];
        p.n_out = bin[3];
        p.n_ops = bin[4];
        p.n_tables = bin[5];
        int64_t need = 6 + p.n_in + 3 * int64_t(p.n_out) + 8 * int64_t(p.n_ops) + p.n_tables;
        if (len < need) throw std::runtime_error("Binary truncated");
        int64_t off = 6;
        auto take = [&](std::vector<int32_t>& dst, int64_t n) {
            dst.assign(bin + off, bin + off + n);
            off += n;
        };
        take(p.inp_shifts, p.n_in);
        take(p.out_idxs, p.n_out);
        take(p.out_shifts, p.n_out);
        take(p.out_negs, p.n_out);
        p.opcode.resize(p.n_ops);
        p.id0.resize(p.n_ops);
        p.id1.resize(p.n_ops);
        p.data_lo.resize(p.n_ops);
        p.data_hi.resize(p.n_ops);
        p.is_signed.resize(p.n_ops);
        p.integers.resize(p.n_ops);
        p.fractionals.resize(p.n_ops);
        for (int i = 0; i < p.n_ops; ++i) {
            const int32_t* row = bin + off + 8 * int64_t(i);
            p.opcode[i] = row[0];
            p.id0[i] = row[1];
            p.id1[i] = row[2];
            p.data_lo[i] = row[3];
            p.data_hi[i] = row[4];
            p.is_signed[i] = row[5];
            p.integers[i] = row[6];
            p.fractionals[i] = row[7];
        }
        off += 8 * int64_t(p.n_ops);
        if (p.n_tables > 0) {
            std::vector<int32_t> sizes;
            take(sizes, p.n_tables);
            for (int t = 0; t < p.n_tables; ++t) {
                if (off + sizes[t] > len) throw std::runtime_error("Binary truncated in tables");
                p.tables.emplace_back(bin + off, bin + off + sizes[t]);
                off += sizes[t];
            }
        }
        if (off != len) throw std::runtime_error("Binary size mismatch");
        p.validate();
        return p;
    }

    // Causality + width validation (reference: DAISInterpreter.cc:429-457).
    void validate() const {
        for (int i = 0; i < n_ops; ++i) {
            if (opcode[i] != -1 && id0[i] >= i)
                throw std::runtime_error("Causality violation on id0 at op " + std::to_string(i));
            if (id1[i] >= i) throw std::runtime_error("Causality violation on id1 at op " + std::to_string(i));
            if ((opcode[i] == 6 || opcode[i] == -6) && data_lo[i] >= i)
                throw std::runtime_error("Causality violation on mux condition index at op " + std::to_string(i));
            if (width(i) > 63) throw std::runtime_error("Op width exceeds 63 bits at op " + std::to_string(i));
        }
        for (int j = 0; j < n_out; ++j)
            if (out_idxs[j] >= n_ops) throw std::runtime_error("Output index out of range");
    }
};

// Execute the program for one sample. `buf` must hold n_ops slots.
inline void exec_sample(const DaisProgram& p, const double* inp, int64_t* buf, double* out) {
    const int n_ops = p.n_ops;
    for (int i = 0; i < n_ops; ++i) {
        const int oc = p.opcode[i];
        const int i0 = p.id0[i], i1 = p.id1[i];
        const int32_t dlo = p.data_lo[i], dhi = p.data_hi[i];
        const bool sg = p.is_signed[i];
        const int f = p.fractionals[i];
        const int w = p.width(i);
        int64_t r = 0;
        switch (oc) {
            case -1: {
                double scaled = std::ldexp(inp[i0], p.inp_shifts[i0] + f);
                r = wrap(static_cast<int64_t>(std::floor(scaled)), sg, w);
                break;
            }
            case 0:
            case 1: {
                const int f0 = p.fractionals[i0], f1 = p.fractionals[i1];
                const int64_t actual_shift = int64_t(dlo) + f0 - f1;
                int64_t v1 = buf[i0];
                int64_t v2 = oc == 1 ? -buf[i1] : buf[i1];
                int64_t s = actual_shift > 0 ? v1 + shl(v2, actual_shift) : shl(v1, -actual_shift) + v2;
                const int64_t global_shift = std::max<int64_t>(f0, f1 - dlo) - f;
                r = global_shift > 0 ? (s >> global_shift) : s;
                break;
            }
            case 2:
            case -2: {
                int64_t v = oc == -2 ? -buf[i0] : buf[i0];
                int64_t q = quantize(v, p.fractionals[i0], sg, w, f);
                r = v < 0 ? 0 : q;
                break;
            }
            case 3:
            case -3: {
                int64_t v = oc == -3 ? -buf[i0] : buf[i0];
                r = quantize(v, p.fractionals[i0], sg, w, f);
                break;
            }
            case 4: {
                const int64_t shift = int64_t(f) - p.fractionals[i0];
                const int64_t c = (int64_t(dhi) << 32) | int64_t(uint32_t(dlo));
                r = shl(buf[i0], shift) + c;
                break;
            }
            case 5:
                r = (int64_t(dhi) << 32) | int64_t(uint32_t(dlo));
                break;
            case 6:
            case -6: {
                const int ic = dlo;
                const int f0 = p.fractionals[i0], f1 = p.fractionals[i1];
                const int64_t shift1 = int64_t(f) - f1 + dhi;
                const int64_t shift0 = int64_t(f) - f0;
                const bool cond = msb(buf[ic], p.is_signed[ic], p.width(ic));
                int64_t v1 = oc == -6 ? -buf[i1] : buf[i1];
                r = cond ? wrap(shl(buf[i0], shift0), sg, w) : wrap(shl(v1, shift1), sg, w);
                break;
            }
            case 7:
                r = buf[i0] * buf[i1];
                break;
            case 8: {
                const int t = dlo;
                const auto& table = p.tables[t];
                const bool sg0 = p.is_signed[i0];
                const int w0 = p.width(i0);
                const int64_t zero = sg0 ? -(int64_t(1) << (w0 - 1)) : 0;
                const int64_t index = buf[i0] - zero - dhi;
                if (index < 0 || index >= int64_t(table.size()))
                    throw std::runtime_error("Logic lookup index out of bounds at op " + std::to_string(i));
                r = table[size_t(index)];
                break;
            }
            case 9:
            case -9: {
                int64_t v = oc == -9 ? -buf[i0] : buf[i0];
                const int w0 = p.width(i0);
                const int64_t mask = w0 >= 64 ? -1 : (int64_t(1) << w0) - 1;
                if (dlo == 0)
                    r = sg ? ~v : (~v) & mask;
                else if (dlo == 1)
                    r = v != 0;
                else if (dlo == 2)
                    r = (v & mask) == mask;
                else
                    throw std::runtime_error("Unknown bit unary op");
                break;
            }
            case 10: {
                const int f0 = p.fractionals[i0], f1 = p.fractionals[i1];
                const int64_t actual_shift = int64_t(dlo) + f0 - f1;
                int64_t v1 = buf[i0], v2 = buf[i1];
                if (dhi & 1) v1 = -v1;
                if (dhi & 2) v2 = -v2;
                if (actual_shift > 0)
                    v2 = shl(v2, actual_shift);
                else
                    v1 = shl(v1, -actual_shift);
                const int subop = dhi >> 24;
                if (subop == 0)
                    r = v1 & v2;
                else if (subop == 1)
                    r = v1 | v2;
                else if (subop == 2)
                    r = v1 ^ v2;
                else
                    throw std::runtime_error("Unknown bit binary op");
                break;
            }
            default:
                throw std::runtime_error("Unknown opcode " + std::to_string(oc));
        }
        buf[i] = r;
    }
    for (int j = 0; j < p.n_out; ++j) {
        const int idx = p.out_idxs[j];
        if (idx < 0) {
            out[j] = 0.0;
            continue;
        }
        int64_t v = buf[idx];
        if (p.out_negs[j]) v = -v;
        out[j] = std::ldexp(double(v), p.out_shifts[j] - p.fractionals[idx]);
    }
}

}  // namespace da4ml
