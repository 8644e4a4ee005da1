// Self-contained integer fixed-point helpers for generated HLS kernels.
//
// The generated kernel is a straight-line DAIS program over int64 codes;
// these helpers give it exact two's-complement wrap / arithmetic-shift
// semantics both in host emulation (g++) and under HLS synthesis (the
// expressions reduce to wires and adders; width recovery is left to the
// scheduler). No vendor ap_fixed/ac_fixed dependency.
//
// Semantics parity: da4ml_tpu/native/src/dais_common.hh and
// da4ml_tpu/runtime/numpy_backend.py.
#pragma once

#include <cstdint>

namespace da {

inline int64_t shl(int64_t v, int s) {
    if (s >= 0) return s >= 64 ? 0 : int64_t(uint64_t(v) << s);
    s = -s;
    if (s >= 64) return v < 0 ? -1 : 0;
    return v >> s;
}

inline int64_t wrap(int64_t v, bool is_signed, int width) {
    if (width <= 0) return 0;
    if (width >= 64) return v;
    const uint64_t mask = (uint64_t(1) << width) - 1;
    uint64_t u = uint64_t(v) & mask;
    if (is_signed && ((u >> (width - 1)) & 1)) u |= ~mask;
    return int64_t(u);
}

inline int64_t requant(int64_t v, int f_from, bool sg, int width, int f_to) {
    return wrap(shl(v, f_to - f_from), sg, width);
}

inline int64_t relu_q(int64_t v, int f_from, bool sg, int width, int f_to) {
    return v < 0 ? 0 : requant(v, f_from, sg, width, f_to);
}

inline bool msb(int64_t v, bool is_signed, int width) {
    if (is_signed) return v < 0;
    if (width <= 0) return false;
    if (width >= 64) return v < 0;
    return v >= (int64_t(1) << (width - 1));
}

inline int64_t shift_add(int64_t a, int64_t b, bool sub, int actual_shift, int gshift) {
    int64_t v2 = sub ? -b : b;
    int64_t s = actual_shift > 0 ? a + shl(v2, actual_shift) : shl(a, -actual_shift) + v2;
    return gshift > 0 ? (s >> gshift) : s;
}

}  // namespace da
