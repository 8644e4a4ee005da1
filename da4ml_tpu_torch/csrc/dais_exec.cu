// DAIS program executor: one table-driven CUDA kernel for Hopper (sm_90a).
//
// Replaces da4ml_tpu/runtime/pallas_backend.py::build_pallas_fn, the Pallas
// mega-kernel that walks the whole level schedule of one DAIS program over a
// block of samples with its operand buffer in VMEM.
//
// What bounds it on an H100. Per sample the kernel evaluates every op of the
// program: a few integer ALU instructions, two operand reads and one result
// write of the operand buffer, and one read of the op's record. Device memory
// sees only the inputs, the outputs and the records (from L2), so the bound is
// integer issue and shared-memory traffic. One thread per sample, the first
// design, kept a sample's column of slots in shared memory (1 KB for the int32
// flagship), which left 6 warps per SM to hide each op's dependent chain
// (record, operand addresses, operands, result). Measured on the card
// (PERF.md), what holds this design back is instruction issue: each op's
// record decode, operand addresses and arithmetic in the batch loop, plus
// each phase's fixed work (the record wait, the group dispatch, the barrier)
// that every warp of a tile repeats.
//
// Design. The kernel is compiled once, for int32_t and int64_t; a program is
// data built on the host by runtime/cuda_backend.py:
// - A tile is 32 samples, the lanes of a warp; its buffer [slot][32] lives in
//   shared memory, so the lanes of an operand access hit 32 distinct banks.
//   G warps share a tile: the program's packed level order is cut into phases
//   (a level, or a near-equal part of a wide level), each phase's ops are
//   dealt out among the G warps kUnroll at a time, and the G warps meet at a
//   named barrier (bar.sync 1 + tile, 32 G) after each phase, so tiles of a
//   block never wait on each other. Buffer slots are assigned by liveness at
//   phase granularity: a slot is free again only after the barrier that ends
//   the phase of its value's last reader, so a warp never overwrites a value
//   another warp of the phase has yet to read.
// - An op is a 16-byte record, read as one vector load: three 16-bit slots, a
//   16-bit control word, and a multiplier in the executor's width (int32
//   records also hold the sign, +1 or -1). copy, addsub, relu and quantize
//   need nothing else; the other families read their constants from a pool
//   in global memory, one entry per record.
// - A phase's block of the record stream (a header, its (family) groups,
//   its records) reaches a tile's stage in shared memory by cp.async.bulk,
//   completing on an mbarrier, kStages phases ahead: one thread issues the
//   copy of phase p + kStages when the barrier ending phase p has freed its
//   buffer. No registers stage records, no block-wide barrier is taken, and
//   a phase reads nothing from global memory but a copy's inputs.
// - A warp evaluates kUnroll consecutive ops of one group together, so their
//   loads overlap; the host pads each group to a multiple of kUnroll by
//   repeating its last op, which computes and stores the same value again.
// - On the shared-memory path a record's slot fields are byte offsets in a
//   sample's column (slot x 32 x itemsize, so a tile's buffer is at most 64
//   KB there): an operand's address is the column's 32-bit shared-memory
//   address plus the field.
// A program whose tile does not fit in shared memory keeps the same tiles in
// a global-memory scratch ([tile][slot][32]); the wrapper then runs the batch
// in chunks so the scratch stays bounded.
// A program with a slot field over 16 bits (more than 65535 input columns, or
// slots on the global-memory path) takes the 24-bit-field layout (kHi): the
// records stay as they are, and bits 16-23 of each slot field are in the
// pool entry's hi word, which every op then reads.
//
// Semantics, copied exactly from the level lowering (jax_backend.py
// _build_level / pallas_backend.py emitters):
// - a left shift is a multiply by a power of two taken mod 2^bits (the host
//   wraps 2^s to 0 for s >= bits and 2^(bits-1) to the most negative value);
//   signed overflow is undefined in C++, so products and sums run in unsigned
//   arithmetic (mulw / addw / subw);
// - a right shift is arithmetic; the host clamps its amount to bits - 1,
//   which is the sign fill XLA and torch give for larger amounts;
// - wrap into `w` bits is a floor modulo; C `%` truncates, so it is done by
//   mask and sign extension;
// - subtraction is opcode +1, folded into the second operand's sign;
// - a LUT index clamps within its own table (flat tables + offsets);
// - an output is buf[slot] x sign, sign 0 for a dead lane (out_idx < 0).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

// the block's dynamic shared memory: its tiles' regions, one after another
extern __shared__ __align__(16) unsigned char smem_raw[];

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

constexpr int32_t kTile = 32;         // samples of a tile: the lanes of a warp
constexpr int32_t kUnroll = 2;        // consecutive ops a warp evaluates together
constexpr int32_t kStages = 2;        // record buffers of a tile's stage
constexpr int32_t kMaxThreads = 256;  // threads of a block: tiles x G x 32
constexpr int32_t kMaxTiles = 4;      // tiles of a block: named barriers 1 to kMaxTiles
constexpr int32_t kStageHead = (8 * kStages + 15) / 16 * 16;  // the stage's mbarriers
constexpr int kMaxDevices = 64;

// A record, as four 32-bit words (REC_DTYPES in cuda_backend.py):
// x = dst | a << 16, y = ctl | b << 16, z = k (int64: its low word),
// w = int32: the sign s (+1 or -1); int64: k's high word.
// ctl of copy, addsub, relu, quantize: right shift (bits 0-5, so q.y & 63 is
// the shift alone), wrap width (bits 6-12), signed (bit 13), negate (bit 14);
// of the other families: the third operand's slot.
__device__ __forceinline__ uint32_t rec_dst(const uint4& q) { return q.x & 0xFFFFu; }
__device__ __forceinline__ uint32_t rec_a(const uint4& q) { return q.x >> 16; }
__device__ __forceinline__ uint32_t rec_b(const uint4& q) { return q.y >> 16; }
__device__ __forceinline__ uint32_t rec_ctl(const uint4& q) { return q.y & 0xFFFFu; }

// The constant pool's entry of one record (EXT_DTYPES in cuda_backend.py).
// hi: in the 24-bit-field layout, bits 16-23 of the record's slot fields:
// dst (bits 0-7), a (8-15), b (16-23), the third operand's slot (24-31).
template <typename T> struct Ext {
    T k0, k1, k2, k3;
    int32_t aux, w, sg;
    uint32_t hi;
};

// a slot field: its 16 record bits, and with kHi its byte `at` of hi above them
template <bool kHi> __device__ __forceinline__ uint32_t field(uint32_t lo, uint32_t hi, int32_t at) {
    if constexpr (kHi) {
        return lo | (((hi >> (8 * at)) & 0xFFu) << 16);
    } else {
        return lo;
    }
}

// stream: per phase a block of 16-byte units (phase_stream in
// cuda_backend.py): a header (groups, the pool index of its first record,
// and the first unit and units of the block of phase + kStages), the group
// words (family | start << 8 | length << 20, start within the phase's
// records, length a multiple of kUnroll), padded to whole units, then the
// records. offsets: per phase, its block's first unit and units (read for
// the first kStages phases only). ext: the constant pool, one entry per
// record of the stream.
template <typename T> struct Params {
    const uint4* stream;
    const int2* offsets;
    const Ext<T>* ext;
    const T* x;
    const int64_t* outs;  // per output: slot, sign
    T* y;
    const T* tab;
    T* scratch;  // the global-memory buffers, or null
    long long batch;
    int32_t n_in, n_out, n_phases, n_slots, tiles, warps, stage_units, region;
};

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

// the record's multiplier k
template <typename T> __device__ __forceinline__ T rec_k(const uint4& q) {
    if constexpr (sizeof(T) == 4) {
        return static_cast<T>(q.z);
    } else {
        return static_cast<T>((static_cast<uint64_t>(q.w) << 32) | q.z);
    }
}

// v times the record's sign
template <typename T> __device__ __forceinline__ T signed_by(T v, const uint4& q) {
    if constexpr (sizeof(T) == 4) {
        return mulw<T>(v, static_cast<T>(q.w));
    } else {
        return ((q.y >> 14) & 1u) ? subw<T>(T(0), v) : v;
    }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One sample's column of a tile's buffer. In shared memory a slot field is
// the slot's byte offset from `base`, the column's shared-memory address; in
// the global-memory scratch it is the slot, at p[s * kTile].
template <typename T, bool kGlobal> struct Column;

template <typename T> struct Column<T, false> {
    uint32_t base;

    __device__ __forceinline__ T load(uint32_t off) const {
        T v;
        if constexpr (sizeof(T) == 4) {
            asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(base + off));
        } else {
            asm volatile("ld.shared.b64 %0, [%1];" : "=l"(v) : "r"(base + off));
        }
        return v;
    }
    __device__ __forceinline__ void store(uint32_t off, T v) const {
        if constexpr (sizeof(T) == 4) {
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(base + off), "r"(v) : "memory");
        } else {
            asm volatile("st.shared.b64 [%0], %1;" ::"r"(base + off), "l"(v) : "memory");
        }
    }
};

template <typename T> struct Column<T, true> {
    T* p;

    __device__ __forceinline__ T load(uint32_t s) const { return p[static_cast<uint64_t>(s) * kTile]; }
    __device__ __forceinline__ void store(uint32_t s, T v) const { p[static_cast<uint64_t>(s) * kTile] = v; }
};

// One op of family kFam for one sample: read its operands from this sample's
// column and return its value. hi: the pool entry's hi word (kHi only).
template <int32_t kFam, typename T, bool kGlobal, bool kHi>
__device__ __forceinline__ T eval_op(const uint4& q, uint32_t hi, const Column<T, kGlobal>& col,
                                     const T* __restrict__ xr, const Ext<T>* __restrict__ e,
                                     const T* __restrict__ tab) {
    const uint32_t ctl = rec_ctl(q);
    const uint32_t a = field<kHi>(rec_a(q), hi, 1), b = field<kHi>(rec_b(q), hi, 2);
    const int32_t r = static_cast<int32_t>(q.y & 63u);
    const int32_t w = static_cast<int32_t>((ctl >> 6) & 127u), sg = static_cast<int32_t>((ctl >> 13) & 1u);
    if constexpr (kFam == FAM_copy) {
        return wrap<T>(xr[a], sg, w);
    } else if constexpr (kFam == FAM_addsub) {  // (x << l) +/- (y << r), then >> g: x * k + y * s
        return addw<T>(mulw<T>(col.load(a), rec_k<T>(q)), signed_by<T>(col.load(b), q)) >> r;
    } else if constexpr (kFam == FAM_relu || kFam == FAM_quantize) {
        const T s = signed_by<T>(col.load(a), q);
        const T v = wrap<T>(mulw<T>(s, rec_k<T>(q)) >> r, sg, w);
        return (kFam == FAM_relu && s < 0) ? T(0) : v;
    } else if constexpr (kFam == FAM_const_add) {
        return addw<T>(mulw<T>(col.load(a), e->k1) >> e->aux, e->k2);
    } else if constexpr (kFam == FAM_const) {
        return e->k2;
    } else if constexpr (kFam == FAM_msb_mux) {
        const int32_t aux = e->aux;
        const T xc = col.load(field<kHi>(ctl, hi, 3));
        const bool cond = ((aux >> 16) & 1) ? (xc < 0) : (xc >= e->k3);
        const T r0 = wrap<T>(mulw<T>(col.load(a), e->k1) >> (aux & 0xFF), e->sg, e->w);
        const T v1 = mulw<T>(col.load(b), e->k0);
        const T r1 = wrap<T>(mulw<T>(v1, e->k2) >> ((aux >> 8) & 0xFF), e->sg, e->w);
        return cond ? r0 : r1;
    } else if constexpr (kFam == FAM_mul) {
        return mulw<T>(col.load(a), col.load(b));
    } else if constexpr (kFam == FAM_lookup) {
        T idx = subw<T>(col.load(a), e->k0);
        idx = idx < e->k1 ? e->k1 : (idx > e->k2 ? e->k2 : idx);
        return tab[idx];
    } else if constexpr (kFam == FAM_bit_unary) {
        const T s = mulw<T>(col.load(a), e->k0);
        const T mask = e->k1;
        if (e->aux == 0) return e->sg ? T(~s) : T(~s & mask);
        if (e->aux == 1) return T(s != 0);
        return T((s & mask) == mask);
    } else {
        static_assert(kFam == FAM_bit_binary, "every family has a lowering");
        T v1 = mulw<T>(col.load(a), e->k0);
        T v2 = mulw<T>(col.load(b), e->k1);
        if (e->aux & 1) {
            v2 = mulw<T>(v2, e->k2);
        } else {
            v1 = mulw<T>(v1, e->k3);
        }
        const int32_t so = e->aux >> 8;
        return so == 0 ? T(v1 & v2) : (so == 1 ? T(v1 | v2) : T(v1 ^ v2));
    }
}

// This warp's share of one group of n records of family kFam (n a multiple
// of kUnroll): batches of kUnroll consecutive records, batch b to warp b mod
// G. A batch reads its records at fixed offsets, then all its operands, then
// writes its results.
template <int32_t kFam, typename T, bool kGlobal, bool kHi>
__device__ __forceinline__ void run_group(const uint4* recs, int32_t n, int32_t w, int32_t G,
                                          const Column<T, kGlobal>& col, const T* __restrict__ xr,
                                          const Ext<T>* __restrict__ ext, const T* __restrict__ tab) {
    for (int32_t j = w * kUnroll; j < n; j += G * kUnroll) {
        uint4 q[kUnroll];
        uint32_t hi[kUnroll];
        T v[kUnroll];
#pragma unroll
        for (int32_t u = 0; u < kUnroll; ++u) {
            q[u] = recs[j + u];
            if constexpr (kHi) {
                hi[u] = ext[j + u].hi;
            } else {
                hi[u] = 0u;
            }
        }
#pragma unroll
        for (int32_t u = 0; u < kUnroll; ++u) {
            v[u] = eval_op<kFam, T, kGlobal, kHi>(q[u], hi[u], col, xr, ext + j + u, tab);
        }
#pragma unroll
        for (int32_t u = 0; u < kUnroll; ++u) col.store(field<kHi>(rec_dst(q[u]), hi[u], 0), v[u]);
    }
}

// The tile's leader copies the block of `units` 16-byte units at unit `at`
// of the stream (one phase's) into stage buffer s; the copy completes on
// that buffer's mbarrier.
__device__ __forceinline__ void load_block(const uint4* stream, int32_t at, int32_t units, uint64_t* full,
                                           uint4* buffer) {
    const uint32_t bytes = static_cast<uint32_t>(units) * 16u;
    const uint32_t bar = smem_addr(full);
    // the buffer's last reads (generic proxy) are ordered before this copy
    // (async proxy) by the phase barrier; the fence makes that explicit
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(smem_addr(buffer)), "l"(reinterpret_cast<uintptr_t>(stream + at)), "r"(bytes), "r"(bar)
                 : "memory");
}

__device__ __forceinline__ void wait_phase(uint64_t* full, int32_t ph) {
    const uint32_t bar = smem_addr(full + ph % kStages);
    const uint32_t parity = static_cast<uint32_t>(ph / kStages) & 1u;
    uint32_t done = 0;
    do {
        asm volatile(
            "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// The G warps of tile t meet on named barrier 1 + t (0 is __syncthreads').
// The ids are immediates: ptxas reserves every id the source names, and the
// SM's barriers bound the blocks it holds.
__device__ __forceinline__ void tile_sync(int32_t t, int32_t G) {
    static_assert(kMaxTiles == 4, "one case per tile");
    const int32_t n = kTile * G;
    switch (t) {
    case 0: asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory"); break;
    case 1: asm volatile("bar.sync 2, %0;" ::"r"(n) : "memory"); break;
    case 2: asm volatile("bar.sync 3, %0;" ::"r"(n) : "memory"); break;
    default: asm volatile("bar.sync 4, %0;" ::"r"(n) : "memory"); break;
    }
}

// kGlobal selects where the operand buffers live: shared memory (false), or
// the global-memory scratch of the chunked path for programs too wide for it;
// kHi the 24-bit-field layout. The register budget keeps five full blocks
// per SM for int32, four for int64.
template <typename T, bool kGlobal, bool kHi>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 4 ? 5 : 4) dais_exec_kernel(const Params<T> p) {
    const int32_t lane = static_cast<int32_t>(threadIdx.x) & 31, warp = static_cast<int32_t>(threadIdx.x) >> 5;
    const int32_t t = warp / p.warps, w = warp - t * p.warps;  // tile of the block, warp of the tile
    unsigned char* region = smem_raw + t * p.region;
    uint64_t* full = reinterpret_cast<uint64_t*>(region);
    uint4* stage = reinterpret_cast<uint4*>(region + kStageHead);
    const bool leader = w == 0 && lane == 0;
    if (leader) {
        for (int32_t s = 0; s < kStages; ++s) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(full + s)), "r"(1) : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();  // once: the mbarriers are set up before anyone waits on them

    const int64_t tile = static_cast<int64_t>(blockIdx.x) * p.tiles + t;
    if (tile * kTile >= p.batch) return;  // a whole tile past the batch: its warps leave together
    Column<T, kGlobal> col;
    if constexpr (kGlobal) {
        col.p = p.scratch + tile * p.n_slots * kTile + lane;
    } else {
        col.base = smem_addr(region + kStageHead + kStages * p.stage_units * 16) +
                   lane * static_cast<uint32_t>(sizeof(T));
    }
    const int64_t row = tile * kTile + lane;
    const bool live = row < p.batch;
    const T* xr = p.x + (live ? row : 0) * static_cast<int64_t>(p.n_in);  // rows past the batch replay row 0

    if (leader) {
        for (int32_t ph = 0; ph < kStages && ph < p.n_phases; ++ph) {
            const int2 o = p.offsets[ph];
            load_block(p.stream, o.x, o.y, full + ph, stage + ph * p.stage_units);
        }
    }
    for (int32_t ph = 0; ph < p.n_phases; ++ph) {
        wait_phase(full, ph);
        const int32_t s = ph % kStages;
        const uint4* blk = stage + s * p.stage_units;
        const uint4 head = blk[0];  // groups, first record, the block kStages phases on
        const int32_t* groups = reinterpret_cast<const int32_t*>(blk + 1);
        const uint4* recs = blk + 1 + (head.x + 3) / 4;
        const Ext<T>* ext = p.ext + head.y;
        for (uint32_t g = 0; g < head.x; ++g) {
            const int32_t grp = groups[g];
            const int32_t start = (grp >> 8) & 0xFFF, n = grp >> 20;
            const uint4* r = recs + start;
            const Ext<T>* e = ext + start;
            switch (grp & 0xFF) {
            case FAM_copy: run_group<FAM_copy, T, kGlobal, kHi>(r, n, w, p.warps, col, xr, e, p.tab); break;
            case FAM_addsub: run_group<FAM_addsub, T, kGlobal, kHi>(r, n, w, p.warps, col, xr, e, p.tab); break;
            case FAM_relu: run_group<FAM_relu, T, kGlobal, kHi>(r, n, w, p.warps, col, xr, e, p.tab); break;
            case FAM_quantize: run_group<FAM_quantize, T, kGlobal, kHi>(r, n, w, p.warps, col, xr, e, p.tab); break;
            case FAM_const_add: run_group<FAM_const_add, T, kGlobal, kHi>(r, n, w, p.warps, col, xr, e, p.tab); break;
            case FAM_const: run_group<FAM_const, T, kGlobal, kHi>(r, n, w, p.warps, col, xr, e, p.tab); break;
            case FAM_msb_mux: run_group<FAM_msb_mux, T, kGlobal, kHi>(r, n, w, p.warps, col, xr, e, p.tab); break;
            case FAM_mul: run_group<FAM_mul, T, kGlobal, kHi>(r, n, w, p.warps, col, xr, e, p.tab); break;
            case FAM_lookup: run_group<FAM_lookup, T, kGlobal, kHi>(r, n, w, p.warps, col, xr, e, p.tab); break;
            case FAM_bit_unary: run_group<FAM_bit_unary, T, kGlobal, kHi>(r, n, w, p.warps, col, xr, e, p.tab); break;
            case FAM_bit_binary: run_group<FAM_bit_binary, T, kGlobal, kHi>(r, n, w, p.warps, col, xr, e, p.tab); break;
            default: break;  // unreachable: the host audits every family id
            }
        }
        tile_sync(t, p.warps);  // the phase's values are written and its records and slots read
        if (leader && head.w) load_block(p.stream, head.z, head.w, full + s, stage + s * p.stage_units);
    }
    if (!live) return;
    T* yr = p.y + row * p.n_out;
    for (int32_t j = w; j < p.n_out; j += p.warps) {
        yr[j] = mulw<T>(col.load(static_cast<uint32_t>(p.outs[2 * j])), static_cast<T>(p.outs[2 * j + 1]));
    }
}

// One instantiation's launch (p not null) or occupancy query. The dynamic
// shared-memory size is always opted into, up to the largest size asked so
// far on the device: without it a block may take only 48 KB.
template <typename T, bool kGlobal, bool kHi>
cudaError_t launch_or_occupancy(int device, const Params<T>* p, unsigned blocks, int threads, int smem,
                                cudaStream_t stream, int* occupancy) {
    static int smem_set[kMaxDevices];
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
    if (smem > smem_set[device]) {
        const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(dais_exec_kernel<T, kGlobal, kHi>),
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        smem_set[device] = smem;
    }
    if (!p) {
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, dais_exec_kernel<T, kGlobal, kHi>, threads, smem);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cfg.attrs = nullptr;
    cfg.numAttrs = 0;
    return cudaLaunchKernelEx(&cfg, dais_exec_kernel<T, kGlobal, kHi>, *p);
}

template <typename T>
cudaError_t dispatch(int device, const Params<T>* p, bool global, bool hi, unsigned blocks, int threads, int smem,
                     cudaStream_t stream, int* occupancy) {
    if (global && hi) return launch_or_occupancy<T, true, true>(device, p, blocks, threads, smem, stream, occupancy);
    if (global) return launch_or_occupancy<T, true, false>(device, p, blocks, threads, smem, stream, occupancy);
    if (hi) return launch_or_occupancy<T, false, true>(device, p, blocks, threads, smem, stream, occupancy);
    return launch_or_occupancy<T, false, false>(device, p, blocks, threads, smem, stream, occupancy);
}

// one tile's shared-memory region: its stage (mbarriers, kStages buffers of
// stage_units 16-byte units), then its buffer on the shared-memory path
int tile_region(int n_slots, int itemsize, int stage_units, bool global) {
    return kStageHead + kStages * stage_units * 16 + (global ? 0 : n_slots * kTile * itemsize);
}

template <typename T>
int launch(int device, bool hi, const void* stream, const void* offsets, const void* ext, const void* x,
           const void* outs, void* y, const void* tab, void* scratch, long long batch, int n_in, int n_out,
           int n_phases, int n_slots, int tiles, int warps, int stage_units, void* cuda_stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tiles < 1 || tiles > kMaxTiles || warps < 1 || tiles * warps * kTile > kMaxThreads || stage_units < 2 ||
        n_slots < 1 || n_slots > (hi ? 0x1000000 : 0x10000) || batch < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool global = scratch != nullptr;
    const int region = tile_region(n_slots, static_cast<int>(sizeof(T)), stage_units, global);
    const Params<T> p{static_cast<const uint4*>(stream), static_cast<const int2*>(offsets),
                      static_cast<const Ext<T>*>(ext), static_cast<const T*>(x), static_cast<const int64_t*>(outs),
                      static_cast<T*>(y), static_cast<const T*>(tab), static_cast<T*>(scratch), batch, n_in, n_out,
                      n_phases, n_slots, tiles, warps, stage_units, region};
    const long long rows = static_cast<long long>(kTile) * tiles;
    const unsigned blocks = static_cast<unsigned>((batch + rows - 1) / rows);
    err = dispatch<T>(device, &p, global, hi, blocks, tiles * warps * kTile, tiles * region,
                      static_cast<cudaStream_t>(cuda_stream), nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Runs a DAIS program over `batch` rows of x. wide: int64 executor (else
// int32); hi: the 24-bit-field layout (else 16-bit); scratch: the
// global-memory buffers, [tiles of the launch][n_slots][32] values, or null
// to keep them in shared memory.
int dais_exec_launch(int device, int wide, int hi, const void* stream, const void* offsets, const void* ext,
                     const void* x, const void* outs, void* y, const void* tab, void* scratch, long long batch,
                     int n_in, int n_out, int n_phases, int n_slots, int tiles, int warps, int stage_units,
                     void* cuda_stream) {
    if (wide) {
        return launch<int64_t>(device, hi != 0, stream, offsets, ext, x, outs, y, tab, scratch, batch, n_in, n_out,
                               n_phases, n_slots, tiles, warps, stage_units, cuda_stream);
    }
    return launch<int32_t>(device, hi != 0, stream, offsets, ext, x, outs, y, tab, scratch, batch, n_in, n_out,
                           n_phases, n_slots, tiles, warps, stage_units, cuda_stream);
}

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory one
// SM holds at once, registers included.
int dais_exec_occupancy(int device, int wide, int global, int hi, int threads, int smem, int* blocks) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (wide) {
        return static_cast<int>(dispatch<int64_t>(device, nullptr, global != 0, hi != 0, 0, threads, smem, 0, blocks));
    }
    return static_cast<int>(dispatch<int32_t>(device, nullptr, global != 0, hi != 0, 0, threads, smem, 0, blocks));
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
