// Helpers shared by generated Verilator binders: bit-field access on
// Verilator port types (plain integers for <=64-bit ports, WData word arrays
// for wider ones) and the OpenMP batch-inference driver.
//
// Parity target: reference src/da4ml/codegen/rtl/common_source/
// {binder_util.hh,ioutil.hh} (bitpack/bitunpack + batch_inference).
#pragma once

#include <cstdint>
#include <type_traits>

#include <verilated.h>

namespace da4ml_binder {

// ---- integral ports (CData/SData/IData/QData) ----
template <typename T, typename std::enable_if<std::is_integral<T>::value, int>::type = 0>
inline void set_bits(T& port, int off, int width, uint64_t val) {
    uint64_t mask = width >= 64 ? ~0ull : ((1ull << width) - 1);
    uint64_t cur = static_cast<uint64_t>(port);
    cur &= ~(mask << off);
    cur |= (val & mask) << off;
    port = static_cast<T>(cur);
}

template <typename T, typename std::enable_if<std::is_integral<T>::value, int>::type = 0>
inline uint64_t get_bits(const T& port, int off, int width) {
    uint64_t mask = width >= 64 ? ~0ull : ((1ull << width) - 1);
    return (static_cast<uint64_t>(port) >> off) & mask;
}

// ---- wide ports (VlWide / WData[N]) ----
template <typename T, typename std::enable_if<!std::is_integral<T>::value, int>::type = 0>
inline void set_bits(T& port, int off, int width, uint64_t val) {
    for (int b = 0; b < width; ++b) {
        int pos = off + b;
        uint32_t bit = (val >> b) & 1;
        port[pos / 32] = (port[pos / 32] & ~(1u << (pos % 32))) | (bit << (pos % 32));
    }
}

template <typename T, typename std::enable_if<!std::is_integral<T>::value, int>::type = 0>
inline uint64_t get_bits(const T& port, int off, int width) {
    uint64_t out = 0;
    for (int b = 0; b < width; ++b) {
        int pos = off + b;
        out |= uint64_t((port[pos / 32] >> (pos % 32)) & 1) << b;
    }
    return out;
}

// Sign-extend a width-bit field to int64.
inline int64_t sext(uint64_t v, int width, bool is_signed) {
    if (!is_signed || width >= 64) return int64_t(v);
    uint64_t sign = 1ull << (width - 1);
    return int64_t((v ^ sign) - sign);
}

}  // namespace da4ml_binder
