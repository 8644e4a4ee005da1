// Native DAIS batch runner: OpenMP over sample chunks, one exec buffer per
// thread. C-ABI entry points consumed via ctypes (da4ml_tpu_torch/native/bindings.py).
//
// Parity targets (the upstream da4ml tree): src/da4ml/_binary/dais/
// bindings.cc:30-100 (chunked omp batch, exception funnel) and
// DAISInterpreter.cc (op semantics — see dais_common.hh).

#include <algorithm>
#include <atomic>
#include <cstring>

#include <omp.h>

#include "dais_common.hh"

namespace {

void copy_error(const std::string& msg, char* err, int64_t err_len) {
    if (!err || err_len <= 0) return;
    int64_t n = std::min<int64_t>(int64_t(msg.size()), err_len - 1);
    std::memcpy(err, msg.data(), size_t(n));
    err[n] = '\0';
}

}  // namespace

#define DA4ML_API extern "C" __attribute__((visibility("default")))

// Run a DAIS program over a (n_samples, n_in) float64 batch.
// Returns 0 on success, nonzero with a message in `err` otherwise.
DA4ML_API int dais_run(const int32_t* binary, int64_t binary_len, const double* data, int64_t n_samples, double* out,
             int64_t n_threads, char* err, int64_t err_len) {
    try {
        da4ml::DaisProgram prog = da4ml::DaisProgram::from_binary(binary, binary_len);
        const int64_t n_in = prog.n_in, n_out = prog.n_out;

        int threads = n_threads > 0 ? int(n_threads) : omp_get_max_threads();
        // At least 32 samples per chunk so tiny batches don't pay thread
        // overhead (reference dais/bindings.cc:58-64).
        const int64_t chunk = std::max<int64_t>(32, (n_samples + threads - 1) / std::max(threads, 1));
        const int64_t n_chunks = (n_samples + chunk - 1) / chunk;

        std::atomic<bool> failed{false};
        std::string first_error;

#pragma omp parallel for schedule(static) num_threads(threads)
        for (int64_t c = 0; c < n_chunks; ++c) {
            if (failed.load(std::memory_order_relaxed)) continue;
            std::vector<int64_t> buf(size_t(prog.n_ops));
            const int64_t lo = c * chunk, hi = std::min(n_samples, lo + chunk);
            try {
                for (int64_t s = lo; s < hi; ++s)
                    da4ml::exec_sample(prog, data + s * n_in, buf.data(), out + s * n_out);
            } catch (const std::exception& e) {
                bool expected = false;
                if (failed.compare_exchange_strong(expected, true)) {
#pragma omp critical(dais_err)
                    first_error = e.what();
                }
            }
        }
        if (failed.load()) {
            copy_error(first_error, err, err_len);
            return 2;
        }
        return 0;
    } catch (const std::exception& e) {
        copy_error(e.what(), err, err_len);
        return 1;
    }
}

// Introspection helper: op count / max width of a serialized program.
DA4ML_API int dais_program_info(const int32_t* binary, int64_t binary_len, int64_t* n_in, int64_t* n_out, int64_t* n_ops,
                      int64_t* max_width, char* err, int64_t err_len) {
    try {
        da4ml::DaisProgram prog = da4ml::DaisProgram::from_binary(binary, binary_len);
        *n_in = prog.n_in;
        *n_out = prog.n_out;
        *n_ops = prog.n_ops;
        int w = 0;
        for (int i = 0; i < prog.n_ops; ++i) w = std::max(w, int(prog.width(i)));
        *max_width = w;
        return 0;
    } catch (const std::exception& e) {
        copy_error(e.what(), err, err_len);
        return 1;
    }
}

DA4ML_API int da4ml_native_abi_version() { return 1; }
