// K1: fused expression-count over dense shard stacks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `count_expr_stack`
// (pilosa_tpu/ops/pallas_kernels.py:141, body `_count_expr_kernel` :85),
// generalised from a left-to-right op chain to any nested &,|,^,&~ tree.
//
// Work: every leaf is an [S, W] stack of uint32 words (held as int32 on
// the PyTorch side). The tree is compiled on the host to a postfix program
// (push leaf i = opcode i < 16; & | ^ &~ = opcodes 16..19). Each thread
// evaluates the program on 16-byte vectors of every leaf, takes __popc of
// the result and sums; a warp shuffle, then a block reduce, then one
// 64-bit atomicAdd per block gives the exact total.
//
// Bound: memory. Every leaf word is read once and nothing is written
// but the 8-byte total: two leaves at S = 954 are 250,085,376 bytes,
// about 75 us at an H100 SXM's 3.35 TB/s; one part's shape on a node of 8
// cards (S = 120) is 31.5 MB, about 9.4 us, so every microsecond a launch
// spends before or after its stream is a tenth of the bound there. The
// design reads each word exactly once with 16-byte streaming (evict-first)
// loads in a grid-stride loop over one resident wave and never
// materialises an intermediate plane. Two variants share the reduction:
//  - chain programs (L0 L1 op L2 op ..., every flat Intersect/Union/...
//    and the north-star Count(Intersect(Row, Row))) keep one accumulator
//    per vector and evaluate K1_ILP vectors per thread per step, so each
//    thread has K1_ILP independent loads in flight;
//  - any other tree runs a register stack (named slots behind a switch
//    on the depth, uniform across the grid, so it never diverges).
// No kernel parameter is indexed at run time: thread 0 copies the leaf
// pointers and the program into shared memory with compile-time indices
// (`stage_params`). A runtime index makes nvcc copy the whole parameter
// block into every thread's local memory (ROADMAP trap 6): 192-208 bytes
// a thread, ~26 MB of local traffic a launch at 1,024 threads an SM: about
// 11 of the 13.6 us each launch cost beside its stream on an H100 80GB
// HBM3. Without it ptxas reports no stack frame and no spill for any K1
// kernel (the chain kernels run 3 blocks an SM, up to 85 registers a
// thread, where 4 blocks spilled). A ring of bulk asynchronous copies
// (cp.async.bulk into shared memory, a persistent grid) was measured
// against this loop on an H100 and was slower at every shape: PERF.md has
// both.

#include <cuda_runtime.h>
#include <stdint.h>

#define K1_MAX_LEAVES 16
#define K1_MAX_PROG 64
#define K1_MAX_STACK 8
#define K1_THREADS 256
#define K1_MIN_BLOCKS_PER_SM 3
#define K1_ILP 4

enum { OP_AND = 16, OP_OR = 17, OP_XOR = 18, OP_ANDNOT = 19 };

struct Leaves {
    const uint4* ptr[K1_MAX_LEAVES];
};

struct Program {
    uint8_t code[K1_MAX_PROG];
};

__device__ __forceinline__ uint4 combine(int op, uint4 a, uint4 b) {
    switch (op) {
        case OP_AND:
            return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
        case OP_OR:
            return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
        case OP_XOR:
            return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
        default:
            return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z,
                              a.w & ~b.w);
    }
}

__device__ __forceinline__ unsigned popc4(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// Block-wide sum of `total`, added once per block into *out.
__device__ __forceinline__ void block_reduce_add(unsigned long long total,
                                                 unsigned long long* out) {
    __shared__ unsigned long long s_warp[K1_THREADS / 32];
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        total += __shfl_down_sync(0xffffffffu, total, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) s_warp[warp] = total;
    __syncthreads();
    if (warp == 0) {
        total = lane < (K1_THREADS / 32) ? s_warp[lane] : 0ull;
        #pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            total += __shfl_down_sync(0xffffffffu, total, off);
        if (lane == 0 && total) atomicAdd(out, total);
    }
}

// Thread 0's copies of the kernel parameters into shared memory, every
// index a compile-time constant (the parameters are __grid_constant__, so
// reading them through a reference copies nothing either); the per-step
// lookups then stay on chip.
__device__ __forceinline__ void stage_code(uint8_t* s_code,
                                           const Program& prog) {
    #pragma unroll
    for (int k = 0; k < K1_MAX_PROG; ++k) s_code[k] = prog.code[k];
}

__device__ __forceinline__ void stage_params(const uint4** s_ptr,
                                             uint8_t* s_code,
                                             const Leaves& leaves,
                                             const Program& prog) {
    #pragma unroll
    for (int k = 0; k < K1_MAX_LEAVES; ++k) s_ptr[k] = leaves.ptr[k];
    stage_code(s_code, prog);
}

#define K1_STAGE_PARAMS()                                                   \
    __shared__ const uint4* s_ptr[K1_MAX_LEAVES];                           \
    __shared__ uint8_t s_code[K1_MAX_PROG];                                 \
    if (threadIdx.x == 0) stage_params(s_ptr, s_code, leaves, prog);       \
    __syncthreads()

// The chain loop: one accumulator per vector, K1_ILP vectors in flight per
// thread per step; the program is L0 L1 op L2 op ... in shared memory.
// Returns this thread's popcount over its grid-stride share of the words
// (the x dimension of the grid strides; y, where used, picks a member).
__device__ __forceinline__ unsigned long long chain_total(
    const uint4* const* s_ptr, const uint8_t* s_code, int prog_len,
    long long n_vec) {
    unsigned long long total = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         base < n_vec; base += stride * K1_ILP) {
        uint4 acc[K1_ILP];
        const uint4* p0 = s_ptr[s_code[0]];
        #pragma unroll
        for (int u = 0; u < K1_ILP; ++u) {
            const long long i = base + u * stride;
            acc[u] = i < n_vec ? __ldcs(p0 + i) : make_uint4(0, 0, 0, 0);
        }
        for (int pc = 1; pc < prog_len; pc += 2) {
            const uint4* p = s_ptr[s_code[pc]];
            const int op = s_code[pc + 1];
            uint4 v[K1_ILP];
            #pragma unroll
            for (int u = 0; u < K1_ILP; ++u) {
                const long long i = base + u * stride;
                v[u] = i < n_vec ? __ldcs(p + i) : make_uint4(0, 0, 0, 0);
            }
            #pragma unroll
            for (int u = 0; u < K1_ILP; ++u) acc[u] = combine(op, acc[u], v[u]);
        }
        // out-of-range slots hold 0 op 0 = 0 for every op: count-neutral
        #pragma unroll
        for (int u = 0; u < K1_ILP; ++u) total += popc4(acc[u]);
    }
    return total;
}

__global__ void __launch_bounds__(K1_THREADS, K1_MIN_BLOCKS_PER_SM)
count_chain_kernel(const __grid_constant__ Leaves leaves,
                   const __grid_constant__ Program prog, int prog_len,
                   long long n_vec, unsigned long long* out) {
    K1_STAGE_PARAMS();
    block_reduce_add(chain_total(s_ptr, s_code, prog_len, n_vec), out);
}

// Register stack: named slots behind a switch on the (uniform) depth.
#define K1_SET(k, v)                                   \
    switch (k) {                                       \
        case 0: r0 = (v); break;                       \
        case 1: r1 = (v); break;                       \
        case 2: r2 = (v); break;                       \
        case 3: r3 = (v); break;                       \
        case 4: r4 = (v); break;                       \
        case 5: r5 = (v); break;                       \
        case 6: r6 = (v); break;                       \
        default: r7 = (v); break;                      \
    }

#define K1_GET(k, out)                                 \
    switch (k) {                                       \
        case 0: (out) = r0; break;                     \
        case 1: (out) = r1; break;                     \
        case 2: (out) = r2; break;                     \
        case 3: (out) = r3; break;                     \
        case 4: (out) = r4; break;                     \
        case 5: (out) = r5; break;                     \
        case 6: (out) = r6; break;                     \
        default: (out) = r7; break;                    \
    }

// The register-stack loop for any other tree, one vector per thread per
// step; same contract as chain_total.
__device__ __forceinline__ unsigned long long tree_total(
    const uint4* const* s_ptr, const uint8_t* s_code, int prog_len,
    long long n_vec) {
    unsigned long long total = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_vec; i += stride) {
        uint4 r0, r1, r2, r3, r4, r5, r6, r7;
        r0 = r1 = r2 = r3 = r4 = r5 = r6 = r7 = make_uint4(0, 0, 0, 0);
        int sp = 0;
        for (int pc = 0; pc < prog_len; ++pc) {
            const int c = s_code[pc];
            if (c < K1_MAX_LEAVES) {
                const uint4 v = __ldcs(s_ptr[c] + i);
                K1_SET(sp, v);
                ++sp;
            } else {
                uint4 a, b;
                K1_GET(sp - 1, b);
                K1_GET(sp - 2, a);
                const uint4 v = combine(c, a, b);
                K1_SET(sp - 2, v);
                --sp;
            }
        }
        total += popc4(r0);
    }
    return total;
}

__global__ void __launch_bounds__(K1_THREADS)
count_tree_kernel(const __grid_constant__ Leaves leaves,
                  const __grid_constant__ Program prog, int prog_len,
                  long long n_vec, unsigned long long* out) {
    K1_STAGE_PARAMS();
    block_reduce_add(tree_total(s_ptr, s_code, prog_len, n_vec), out);
}

// One full wave: as many blocks as can be resident at once, so every
// block of the grid-stride loop does the same work with no tail wave.
template <typename Kernel>
static int k1_grid(Kernel kernel) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K1_THREADS, 0);
    if (sms < 1) sms = 132;
    if (per_sm < 1) per_sm = 1;
    return sms * per_sm;
}

// True for L0 L1 op L2 op ... (a left-to-right chain).
static bool is_chain(const unsigned char* code, int len) {
    if (len % 2 == 0 || code[0] >= K1_MAX_LEAVES) return false;
    for (int k = 1; k < len; ++k)
        if ((k % 2 == 1) != (code[k] < K1_MAX_LEAVES)) return false;
    return true;
}

// Plain C entry point, bound with ctypes. `leaf_ptrs` holds `n_leaves`
// device pointers to [n_words] word arrays (16-byte aligned, n_words a
// multiple of 4); `code` holds the postfix program. Zeroes `out` (one
// uint64) and launches on `stream`. Returns cudaGetLastError().
extern "C" int count_expr_launch(const void* const* leaf_ptrs, int n_leaves,
                                 const unsigned char* code, int code_len,
                                 long long n_words, void* out, void* stream) {
    if (n_leaves < 1 || n_leaves > K1_MAX_LEAVES || code_len < 1 ||
        code_len > K1_MAX_PROG || n_words % 4 != 0)
        return (int)cudaErrorInvalidValue;
    Leaves leaves;
    Program prog;
    for (int k = 0; k < K1_MAX_LEAVES; ++k)
        leaves.ptr[k] = (const uint4*)(k < n_leaves ? leaf_ptrs[k] : leaf_ptrs[0]);
    for (int k = 0; k < K1_MAX_PROG; ++k) prog.code[k] = k < code_len ? code[k] : 0;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    const long long n_vec = n_words / 4;
    if (n_vec == 0) return (int)cudaGetLastError();
    const long long want = (n_vec + K1_THREADS - 1) / K1_THREADS;
    if (is_chain(code, code_len)) {
        static const int cap = k1_grid(count_chain_kernel);
        count_chain_kernel<<<(unsigned)(want < cap ? want : cap), K1_THREADS, 0, s>>>(
            leaves, prog, code_len, n_vec, (unsigned long long*)out);
    } else {
        static const int cap = k1_grid(count_tree_kernel);
        count_tree_kernel<<<(unsigned)(want < cap ? want : cap), K1_THREADS, 0, s>>>(
            leaves, prog, code_len, n_vec, (unsigned long long*)out);
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1's batched entry: B independent trees of one signature in one launch.
//
// Replaces the TPU package's batched count programs `_count_batch_fn` and
// `_vmap_count_fn` (pilosa_tpu/exec/stacked.py:1424, :1620), which run
// `containers.count_program`, and so K1's function
// (pilosa_tpu/ops/pallas_kernels.py:141), over a batch of leaf sets.
//
// Every member runs the same postfix program over its own n leaves. Member
// q's leaf pointers are row q of a device-resident [B, n] int64 table: B·n
// pointers as kernel parameters indexed by blockIdx would be copied to local
// memory (ROADMAP trap 6). The grid is (blocks per member, B): the blocks of
// one resident wave split evenly over the members. Each block stages its
// member's row of the table and the program in shared memory once (the
// program with compile-time indices into the parameter), runs
// K1's chain loop (K1_ILP evict-first 16-byte vectors in flight) or its
// register stack over that member's words, and adds its block sum into
// out[q] with one 64-bit atomicAdd.
//
// Bound: memory, as K1: each member's leaf words read once (B·n·S·W·4
// bytes), plus the table and the B totals. Members that share a leaf read
// it once each; reading a shared leaf once for the batch is later work.

#define K1B_STAGE_PARAMS()                                                  \
    __shared__ const uint4* s_ptr[K1_MAX_LEAVES];                           \
    __shared__ uint8_t s_code[K1_MAX_PROG];                                 \
    if ((int)threadIdx.x < n_leaves)                                        \
        s_ptr[threadIdx.x] = reinterpret_cast<const uint4*>(                \
            table[(long long)blockIdx.y * n_leaves + threadIdx.x]);         \
    if (threadIdx.x == 0) stage_code(s_code, prog);                        \
    __syncthreads()

__global__ void __launch_bounds__(K1_THREADS, K1_MIN_BLOCKS_PER_SM)
count_chain_batch_kernel(const long long* table, int n_leaves,
                         const __grid_constant__ Program prog,
                         int prog_len, long long n_vec,
                         unsigned long long* out) {
    K1B_STAGE_PARAMS();
    block_reduce_add(chain_total(s_ptr, s_code, prog_len, n_vec),
                     out + blockIdx.y);
}

__global__ void __launch_bounds__(K1_THREADS)
count_tree_batch_kernel(const long long* table, int n_leaves,
                        const __grid_constant__ Program prog,
                        int prog_len, long long n_vec,
                        unsigned long long* out) {
    K1B_STAGE_PARAMS();
    block_reduce_add(tree_total(s_ptr, s_code, prog_len, n_vec),
                     out + blockIdx.y);
}

// Plain C entry point, bound with ctypes. `table` is a device [n_members,
// n_leaves] int64 array of leaf pointers, each to [n_words] words (16-byte
// aligned, n_words a multiple of 4, the same for every member); `code` holds
// the members' one postfix program. Zeroes `out` (n_members uint64) and
// launches on `stream`. Returns cudaGetLastError().
extern "C" int count_expr_batch_launch(const unsigned char* code, int code_len,
                                       const void* table, int n_leaves,
                                       int n_members, long long n_words,
                                       void* out, void* stream) {
    if (n_leaves < 1 || n_leaves > K1_MAX_LEAVES || code_len < 1 ||
        code_len > K1_MAX_PROG || n_members < 1 || n_members > 65535 ||
        n_words % 4 != 0)
        return (int)cudaErrorInvalidValue;
    Program prog;
    for (int k = 0; k < K1_MAX_PROG; ++k) prog.code[k] = k < code_len ? code[k] : 0;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)n_members * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    const long long n_vec = n_words / 4;
    if (n_vec == 0) return (int)cudaGetLastError();
    const long long want = (n_vec + K1_THREADS - 1) / K1_THREADS;
    const long long* tab = (const long long*)table;
    unsigned long long* o = (unsigned long long*)out;
    if (is_chain(code, code_len)) {
        static const int cap = k1_grid(count_chain_batch_kernel);
        long long per = cap / n_members;
        per = per < 1 ? 1 : (per > want ? want : per);
        count_chain_batch_kernel<<<dim3((unsigned)per, (unsigned)n_members),
                                   K1_THREADS, 0, s>>>(
            tab, n_leaves, prog, code_len, n_vec, o);
    } else {
        static const int cap = k1_grid(count_tree_batch_kernel);
        long long per = cap / n_members;
        per = per < 1 ? 1 : (per > want ? want : per);
        count_tree_batch_kernel<<<dim3((unsigned)per, (unsigned)n_members),
                                  K1_THREADS, 0, s>>>(
            tab, n_leaves, prog, code_len, n_vec, o);
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1's multi-tree entry: n trees of DIFFERENT programs, each over its own
// leaves, in one launch.
//
// Replaces the TPU package's whole-plan fusion program `fused_count_fn`
// (pilosa_tpu/exec/stacked.py:1452), which traces every top-level Count of a
// query through `containers.count_program`, and so through K1's function
// (`count_expr_stack`, pilosa_tpu/ops/pallas_kernels.py:141, body
// `_count_expr_kernel` :85), into one XLA program.
//
// Member m has its own postfix program and leaves. A program table on the
// device holds, per member, one descriptor of K1M_DESC int32 (code offset,
// code length, leaf offset, leaf count, chain flag), then every member's
// code bytes; a second device array holds every member's int64 leaf
// pointers, concatenated. The grid is (blocks per member, n): a resident
// wave's blocks split evenly over the members. Each block stages its own
// member's code and pointers in shared memory (runtime-indexed kernel
// parameters would sit in local memory, ROADMAP trap 6), runs K1's chain
// loop or its register-stack loop over that member's words (the branch is
// uniform per block), and adds its block sum into out[m] with one 64-bit
// atomicAdd.
//
// Bound: memory, as K1: every member's leaf words read once (a leaf shared
// by two members is read once by each), plus the table and the n totals.

#define K1M_DESC 5

__global__ void __launch_bounds__(K1_THREADS)
count_multi_kernel(const int* table, int n_members, const long long* ptrs,
                   long long n_vec, unsigned long long* out) {
    __shared__ const uint4* s_ptr[K1_MAX_LEAVES];
    __shared__ uint8_t s_code[K1_MAX_PROG];
    __shared__ int s_desc[K1M_DESC];
    const int m = blockIdx.y;
    if (threadIdx.x < K1M_DESC)
        s_desc[threadIdx.x] = table[m * K1M_DESC + threadIdx.x];
    __syncthreads();
    const int code_len = s_desc[1], n_leaves = s_desc[3];
    const uint8_t* codes =
        reinterpret_cast<const uint8_t*>(table + n_members * K1M_DESC);
    if ((int)threadIdx.x < n_leaves)
        s_ptr[threadIdx.x] =
            reinterpret_cast<const uint4*>(ptrs[s_desc[2] + threadIdx.x]);
    if ((int)threadIdx.x < code_len) s_code[threadIdx.x] = codes[s_desc[0] + threadIdx.x];
    __syncthreads();
    const unsigned long long total =
        s_desc[4] ? chain_total(s_ptr, s_code, code_len, n_vec)
                  : tree_total(s_ptr, s_code, code_len, n_vec);
    block_reduce_add(total, out + m);
}

// Plain C entry point, bound with ctypes. `table` is the device program
// table of `n_members` members (K1M_DESC int32 each, then the code bytes;
// every code length 1..K1_MAX_PROG, every leaf count 1..K1_MAX_LEAVES,
// checked on the host when the table is built); `ptrs` the device int64
// leaf pointers, each to [n_words] words (16-byte aligned, n_words a
// multiple of 4, the same for every member). Zeroes `out` (n_members
// uint64) and launches on `stream`. Returns cudaGetLastError().
extern "C" int count_expr_multi_launch(const void* table, int n_members,
                                       const void* ptrs, long long n_words,
                                       void* out, void* stream) {
    if (n_members < 1 || n_members > 65535 || n_words % 4 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)n_members * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    const long long n_vec = n_words / 4;
    if (n_vec == 0) return (int)cudaGetLastError();
    const long long want = (n_vec + K1_THREADS - 1) / K1_THREADS;
    static const int cap = k1_grid(count_multi_kernel);
    long long per = cap / n_members;
    per = per < 1 ? 1 : (per > want ? want : per);
    count_multi_kernel<<<dim3((unsigned)per, (unsigned)n_members), K1_THREADS,
                         0, s>>>((const int*)table, n_members,
                                 (const long long*)ptrs, n_vec,
                                 (unsigned long long*)out);
    return (int)cudaGetLastError();
}
