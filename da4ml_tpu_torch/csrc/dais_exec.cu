// DAIS program executor: one table-driven CUDA kernel for Hopper (sm_90a).
//
// Replaces da4ml_tpu/runtime/pallas_backend.py::build_pallas_fn, the Pallas
// mega-kernel that walks the whole level schedule of one DAIS program over a
// block of samples with its operand buffer in VMEM.
//
// Design. The kernel is compiled once, for int32_t and int64_t; a program is
// data: a list of 64-byte op records in the packed level order of
// ir.schedule.levelize_program(prog, sort_key=family), built on the host by
// runtime/cuda_backend.py. One thread evaluates one sample. Each thread walks
// the op list over its own column of a [n_slots][blockDim] buffer in dynamic
// shared memory; buffer slots are assigned on the host by operand liveness,
// so the buffer holds the live window of the program (about peak_live
// slots), not one slot per op. All threads of a block run the same op at the
// same time: the family switch does not diverge, the op record is a
// warp-uniform (broadcast) load, and no __syncthreads is needed, since a
// thread only ever reads its own column. When slots x itemsize x 32 samples
// exceed the shared memory a block may use, the same kernel keeps the buffer
// in a global-memory scratch ([block][n_slots][blockDim]) and the wrapper
// runs the batch in chunks so the scratch stays bounded.
//
// Bound on an H100. Per sample the kernel does about n_ops op evaluations of
// a few integer ALU instructions each, with two shared-memory reads and one
// write per op; device-memory traffic is only (n_in + n_out) x itemsize per
// sample plus the op records, which every block re-reads from L2. So the
// kernel is bound by integer ALU issue and shared-memory bandwidth, not by
// HBM. What the design does about it: the operand buffer stays on chip, the
// branch is uniform, op records are staged through shared memory a chunk at a
// time while the next chunk is fetched, and the ops of a (level, family)
// group are evaluated kUnroll at a time so their loads overlap. What it does
// not yet do: occupancy is bounded by the buffer, since a sample's column of
// slots must fit in shared memory (three 64-sample blocks per SM for the
// 268-slot int32 flagship), so each op's latency is hidden by few warps.
//
// Semantics, copied exactly from the level lowering (jax_backend.py
// _build_level / pallas_backend.py emitters):
// - a left shift is a multiply by a power of two taken mod 2^bits; signed
//   overflow is undefined in C++, so products and sums run in unsigned
//   arithmetic (mulw / addw / subw);
// - a right shift is arithmetic; the host clamps its amount to bits - 1,
//   which is the sign fill XLA and torch give for larger amounts;
// - wrap into `w` bits is a floor modulo; C `%` truncates, so it is done by
//   mask and sign extension;
// - subtraction is opcode +1, folded into the second operand's multiplier;
// - a LUT index clamps within its own table (flat tables + offsets);
// - an output is buf[slot] x sign, sign 0 for a dead lane (out_idx < 0).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

// The family switch. Names match OpSpec.lower in ir/optable.py; the Python
// wrapper audits this enum against the opcode table both ways at import.
enum Family : int32_t {
    FAM_copy = 0,
    FAM_addsub = 1,
    FAM_relu = 2,
    FAM_quantize = 3,
    FAM_const_add = 4,
    FAM_const = 5,
    FAM_msb_mux = 6,
    FAM_mul = 7,
    FAM_lookup = 8,
    FAM_bit_unary = 9,
    FAM_bit_binary = 10,
};

// One op, in packed order. Layout shared with REC_DTYPE in cuda_backend.py;
// fam holds the family id in its low byte and, above it, how many ops of the
// op's (level, family) group remain from this one on.
struct OpRec {
    int32_t fam, dst, a, b, c, w, sg, aux;
    int64_t k0, k1, k2, k3;
};
static_assert(sizeof(OpRec) == 64, "OpRec layout is shared with cuda_backend.py");

template <typename T> struct Unsigned;
template <> struct Unsigned<int32_t> { using type = uint32_t; };
template <> struct Unsigned<int64_t> { using type = uint64_t; };

template <typename T> __device__ __forceinline__ T mulw(T a, T b) {
    using U = typename Unsigned<T>::type;
    return static_cast<T>(static_cast<U>(a) * static_cast<U>(b));
}

template <typename T> __device__ __forceinline__ T addw(T a, T b) {
    using U = typename Unsigned<T>::type;
    return static_cast<T>(static_cast<U>(a) + static_cast<U>(b));
}

template <typename T> __device__ __forceinline__ T subw(T a, T b) {
    using U = typename Unsigned<T>::type;
    return static_cast<T>(static_cast<U>(a) - static_cast<U>(b));
}

// two's-complement wrap of v into w bits (signed or unsigned container)
template <typename T> __device__ __forceinline__ T wrap(T v, int32_t sg, int32_t w) {
    using U = typename Unsigned<T>::type;
    constexpr int32_t kBits = static_cast<int32_t>(sizeof(T) * 8);
    if (w >= kBits) return v;
    if (w <= 0) return sg ? T(-1) : T(0);
    const U mask = (U(1) << w) - U(1);
    U u = static_cast<U>(v) & mask;
    if (sg && ((u >> (w - 1)) & U(1))) u |= ~mask;
    return static_cast<T>(u);
}

// One op of family kFam for one sample: read its operands from this sample's
// column `col` (slot s at col[s * nt]) and return its value.
template <int32_t kFam, typename T, typename Idx>
__device__ __forceinline__ T eval_op(const OpRec& op, const T* col, Idx nt, const T* __restrict__ xr,
                                     const T* __restrict__ tab) {
    if constexpr (kFam == FAM_copy) {
        return wrap<T>(xr[op.a], op.sg, op.w);
    } else if constexpr (kFam == FAM_addsub) {  // (x0 << l) +/- (x1 << r), then >> g
        return addw<T>(mulw<T>(col[Idx(op.a) * nt], T(op.k0)), mulw<T>(col[Idx(op.b) * nt], T(op.k1))) >> op.aux;
    } else if constexpr (kFam == FAM_relu || kFam == FAM_quantize) {
        const T s = mulw<T>(col[Idx(op.a) * nt], T(op.k0));
        const T q = wrap<T>(mulw<T>(s, T(op.k1)) >> op.aux, op.sg, op.w);
        return (kFam == FAM_relu && s < 0) ? T(0) : q;
    } else if constexpr (kFam == FAM_const_add) {
        return addw<T>(mulw<T>(col[Idx(op.a) * nt], T(op.k1)) >> op.aux, T(op.k2));
    } else if constexpr (kFam == FAM_const) {
        return T(op.k2);
    } else if constexpr (kFam == FAM_msb_mux) {
        const T xc = col[Idx(op.c) * nt];
        const bool cond = ((op.aux >> 16) & 1) ? (xc < 0) : (xc >= T(op.k3));
        const T r0 = wrap<T>(mulw<T>(col[Idx(op.a) * nt], T(op.k1)) >> (op.aux & 0xFF), op.sg, op.w);
        const T v1 = mulw<T>(col[Idx(op.b) * nt], T(op.k0));
        const T r1 = wrap<T>(mulw<T>(v1, T(op.k2)) >> ((op.aux >> 8) & 0xFF), op.sg, op.w);
        return cond ? r0 : r1;
    } else if constexpr (kFam == FAM_mul) {
        return mulw<T>(col[Idx(op.a) * nt], col[Idx(op.b) * nt]);
    } else if constexpr (kFam == FAM_lookup) {
        T idx = subw<T>(col[Idx(op.a) * nt], T(op.k0));
        idx = idx < T(op.k1) ? T(op.k1) : (idx > T(op.k2) ? T(op.k2) : idx);
        return tab[idx];
    } else if constexpr (kFam == FAM_bit_unary) {
        const T s = mulw<T>(col[Idx(op.a) * nt], T(op.k0));
        const T mask = T(op.k1);
        if (op.aux == 0) return op.sg ? T(~s) : T(~s & mask);
        if (op.aux == 1) return T(s != 0);
        return T((s & mask) == mask);
    } else {
        static_assert(kFam == FAM_bit_binary, "every family has a lowering");
        T v1 = mulw<T>(col[Idx(op.a) * nt], T(op.k0));
        T v2 = mulw<T>(col[Idx(op.b) * nt], T(op.k1));
        if (op.aux & 1) {
            v2 = mulw<T>(v2, T(op.k2));
        } else {
            v1 = mulw<T>(v1, T(op.k3));
        }
        const int32_t so = op.aux >> 8;
        return so == 0 ? T(v1 & v2) : (so == 1 ? T(v1 | v2) : T(v1 ^ v2));
    }
}

// A run of ops of one (level, family) group. Ops of a group are mutually
// independent and no op's result slot is one another op of its group still
// reads, so kUnroll of them read their operands before any writes its
// result: their dependent chains overlap instead of running back to back.
// The last, partial batch of a run repeats the run's last op in its empty
// places instead of branching around them: the repeats compute and store the
// same value, and the batch stays free of branches, so its loads can issue
// together.
constexpr int32_t kUnroll = 4;

template <int32_t kFam, typename T, typename Idx>
__device__ __forceinline__ void run_group(const OpRec* recs, int32_t n, T* col, Idx nt, const T* __restrict__ xr,
                                          const T* __restrict__ tab) {
    for (int32_t k = 0; k < n; k += kUnroll) {
        T v[kUnroll];
#pragma unroll
        for (int32_t u = 0; u < kUnroll; ++u) v[u] = eval_op<kFam, T, Idx>(recs[min(k + u, n - 1)], col, nt, xr, tab);
#pragma unroll
        for (int32_t u = 0; u < kUnroll; ++u) col[Idx(recs[min(k + u, n - 1)].dst) * nt] = v[u];
    }
}

// Op records are staged through shared memory kChunk at a time: every thread
// loads its share of the next chunk into registers while the block executes
// the current one, so the records' L2 latency hides behind a chunk of ops
// and each op reads its record as a shared-memory broadcast.
constexpr int32_t kChunk = 64;
constexpr int32_t kChunkVecs = kChunk * static_cast<int32_t>(sizeof(OpRec) / sizeof(uint4));

// this thread's share of the record chunk starting at vector `base`, into
// registers: vectors threadIdx.x + k * blockDim.x (blockDim.x >= 32)
template <int32_t kPer>
__device__ __forceinline__ void fetch_chunk(uint4 (&next)[kPer], const uint4* __restrict__ src, int32_t base,
                                            int32_t n_vecs) {
#pragma unroll
    for (int32_t k = 0; k < kPer; ++k) {
        const int32_t v = static_cast<int32_t>(threadIdx.x) + k * static_cast<int32_t>(blockDim.x);
        if (v < kChunkVecs && base + v < n_vecs) next[k] = src[base + v];
    }
}

// kGlobal selects where the operand buffer lives: shared memory (false), or
// the global-memory scratch of the chunked path for programs too wide for it
template <typename T, bool kGlobal>
__global__ void __launch_bounds__(128) dais_exec_kernel(const OpRec* __restrict__ ops, int32_t n_ops,
                                                        const T* __restrict__ x, int32_t n_in,
                                                        const int64_t* __restrict__ outs, int32_t n_out,
                                                        T* __restrict__ y, const T* __restrict__ tab,
                                                        int64_t batch, int32_t n_slots, T* __restrict__ scratch) {
    using Idx = std::conditional_t<kGlobal, int64_t, int32_t>;  // slot x blockDim fits int32 on chip
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ __align__(16) OpRec stage[kChunk];
    const Idx nt = static_cast<Idx>(blockDim.x);
    const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const bool live = row < batch;
    T* buf;
    if constexpr (kGlobal) {
        buf = scratch + static_cast<int64_t>(blockIdx.x) * n_slots * nt;
    } else {
        buf = reinterpret_cast<T*>(smem_raw);
    }
    T* col = buf + threadIdx.x;  // slot s of this sample lives at col[s * nt]
    const T* xr = x + (live ? row : 0) * static_cast<int64_t>(n_in);  // rows past the batch replay row 0

    constexpr int32_t kPer = kChunkVecs / 32;  // vectors per thread at the smallest block
    const uint4* src = reinterpret_cast<const uint4*>(ops);
    uint4* dst = reinterpret_cast<uint4*>(stage);
    const int32_t n_vecs = n_ops * static_cast<int32_t>(sizeof(OpRec) / sizeof(uint4));
    uint4 next[kPer];
    fetch_chunk<kPer>(next, src, 0, n_vecs);
    for (int32_t c0 = 0; c0 < n_ops; c0 += kChunk) {
        __syncthreads();  // the previous chunk's records are no longer read
#pragma unroll
        for (int32_t k = 0; k < kPer; ++k) {
            const int32_t v = static_cast<int32_t>(threadIdx.x) + k * static_cast<int32_t>(blockDim.x);
            if (v < kChunkVecs) dst[v] = next[k];
        }
        __syncthreads();
        if (c0 + kChunk < n_ops) {
            fetch_chunk<kPer>(next, src, (c0 + kChunk) * static_cast<int32_t>(sizeof(OpRec) / sizeof(uint4)), n_vecs);
        }
        const int32_t n = min(kChunk, n_ops - c0);
        for (int32_t j = 0; j < n;) {
            // fam packs the family id (low byte) and the ops left in its group
            const int32_t head = stage[j].fam;
            const int32_t run = max(1, min(head >> 8, n - j));
            const OpRec* recs = stage + j;
            switch (head & 0xFF) {
            case FAM_copy: run_group<FAM_copy, T, Idx>(recs, run, col, nt, xr, tab); break;
            case FAM_addsub: run_group<FAM_addsub, T, Idx>(recs, run, col, nt, xr, tab); break;
            case FAM_relu: run_group<FAM_relu, T, Idx>(recs, run, col, nt, xr, tab); break;
            case FAM_quantize: run_group<FAM_quantize, T, Idx>(recs, run, col, nt, xr, tab); break;
            case FAM_const_add: run_group<FAM_const_add, T, Idx>(recs, run, col, nt, xr, tab); break;
            case FAM_const: run_group<FAM_const, T, Idx>(recs, run, col, nt, xr, tab); break;
            case FAM_msb_mux: run_group<FAM_msb_mux, T, Idx>(recs, run, col, nt, xr, tab); break;
            case FAM_mul: run_group<FAM_mul, T, Idx>(recs, run, col, nt, xr, tab); break;
            case FAM_lookup: run_group<FAM_lookup, T, Idx>(recs, run, col, nt, xr, tab); break;
            case FAM_bit_unary: run_group<FAM_bit_unary, T, Idx>(recs, run, col, nt, xr, tab); break;
            case FAM_bit_binary: run_group<FAM_bit_binary, T, Idx>(recs, run, col, nt, xr, tab); break;
            default: break;  // unreachable: the host audits every family id
            }
            j += run;
        }
    }
    if (!live) return;
    T* yr = y + row * n_out;
    for (int32_t j = 0; j < n_out; ++j) yr[j] = mulw<T>(col[Idx(outs[2 * j]) * nt], T(outs[2 * j + 1]));
}

template <typename T>
int launch(int device, const void* ops, int n_ops, const T* x, int n_in, const int64_t* outs, int n_out, T* y,
           const T* tab, long long batch, int n_slots, int threads, T* scratch, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>((batch + threads - 1) / threads));
    const auto* recs = static_cast<const OpRec*>(ops);
    auto* s = static_cast<cudaStream_t>(stream);
    if (scratch) {
        dais_exec_kernel<T, true><<<grid, dim3(threads), 0, s>>>(recs, n_ops, x, n_in, outs, n_out, y, tab, batch,
                                                                 n_slots, scratch);
    } else {
        // Always opt in: without it the dynamic buffer may only take 48 KB
        // less the static record stage, and a buffer just under 48 KB fails.
        const size_t smem = static_cast<size_t>(n_slots) * threads * sizeof(T);
        err = cudaFuncSetAttribute(dais_exec_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        dais_exec_kernel<T, false><<<grid, dim3(threads), smem, s>>>(recs, n_ops, x, n_in, outs, n_out, y, tab,
                                                                    batch, n_slots, scratch);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dais_exec_i32(int device, const void* ops, int n_ops, const int32_t* x, int n_in, const int64_t* outs, int n_out,
                  int32_t* y, const int32_t* tab, long long batch, int n_slots, int threads, int32_t* scratch,
                  void* stream) {
    return launch<int32_t>(device, ops, n_ops, x, n_in, outs, n_out, y, tab, batch, n_slots, threads, scratch, stream);
}

int dais_exec_i64(int device, const void* ops, int n_ops, const int64_t* x, int n_in, const int64_t* outs, int n_out,
                  int64_t* y, const int64_t* tab, long long batch, int n_slots, int threads, int64_t* scratch,
                  void* stream) {
    return launch<int64_t>(device, ops, n_ops, x, n_in, outs, n_out, y, tab, batch, n_slots, threads, scratch, stream);
}

// shared memory of `device`, in bytes: what one block may use (the opt-in
// maximum), what one SM holds, and what the system reserves per block
int dais_device_smem(int device, int* per_block, int* per_sm, int* reserved) {
    cudaError_t err = cudaDeviceGetAttribute(per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
    return static_cast<int>(err);
}

const char* dais_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
