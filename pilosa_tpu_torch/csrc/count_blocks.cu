// K2: popcounts over block-sparse containers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `count_blocks_stack` and
// `count_and_blocks_stack` (pilosa_tpu/ops/pallas_kernels.py:235, :245;
// body `_count_blocks_kernel` :190, call :218). A block-sparse container
// keeps only the non-empty 128-word blocks of an [S, W] plane stack as
// sorted block ids [NB] int32 plus blocks [NB, 128] uint32 (held as int32
// on the PyTorch side); padding ids are SPARSE_SENTINEL with zero blocks.
// Two entries, both exact 64-bit totals:
//   mode 0  Σ popcount(a)                      count_blocks
//   mode 2  Σ popcount(a & b[match(ids_a)])    count_and_blocks
// and their batched entry (count_blocks_batch_launch, at the end): B
// members of one shape in one launch, as the TPU package's vmapped count
// program makes one kernel of a batch of sparse Counts.
// Mode 2 is `count_and_blocks_stack` with its caller's searchsorted
// alignment (pilosa_tpu/ops/containers.py:757-761) fused in: a block of a
// counts against b's block of the same id; one without a partner, or with
// the padding id, counts zero and is never loaded.
//
// Bound: memory. Every block that counts is read once, each id array is
// read once, and nothing is written but the 8-byte total: count_blocks
// over the served sparse row (NB = 32,768) reads 16,777,216 B, ~5.0 us at
// an H100 SXM's 3.35 TB/s; the served count_and_blocks pair reads
// 11,984,904 B, ~3.6 us.
//
// count_blocks_kernel (mode 0): one warp owns one 512 B block, each lane
// one 16-byte vector of it, loaded evict-first; warps walk the blocks in a
// grid-stride loop over one resident wave with K2_ILP blocks in flight.
//
// count_blocks_kernel_fused (mode 2): the wait is latency, not bytes — a
// binary search per block of a is a chain of ~15 dependent loads. So the
// two sorted id lists are intersected tile by tile instead:
//   1. each CTA owns K2_TILE consecutive ids of a, loaded coalesced into
//      shared memory; a tile that starts with padding exits;
//   2. in the same round trip, the CTA's K2_THREADS threads probe evenly
//      spaced ids of b and one __syncthreads_count narrows the lower bound
//      of the tile's first id to K2_THREADS-th of b (one round up to
//      K2_THREADS * K2_CHUNK ids of b; more rounds past that);
//   3. from there b's ids are loaded coalesced, K2_CHUNK at a time, into
//      shared memory, and each thread binary-searches its own id of a in
//      the chunk; the walk stops at the chunk that reaches the tile's last
//      id, so a b much denser than a takes several chunks;
//   4. matched (row of a, row of b) pairs are compacted into a shared list
//      (warp ballot + one shared atomic per warp);
//   5. the warps stream only the matched block pairs, K2_ILP pairs in
//      flight per warp, 16-byte evict-first loads, AND and __popc.
// That is ~3 dependent trips to memory (tile and probes, chunk, blocks)
// instead of ~17. Per-thread 64-bit sums go through a warp shuffle and a
// block reduce to one 64-bit atomicAdd per CTA in both kernels. The Pallas
// kernel's [8, 128] int32 accumulator carried across grid steps is TPU
// tiling and is not kept.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define K2_THREADS 256
#define K2_WARPS (K2_THREADS / 32)
#define K2_ILP 4             // blocks (mode 0) or block pairs (mode 2) in flight per warp
#define K2_VEC_PER_BLOCK 32  // 128 words = 32 uint4
#define K2_SENTINEL (1 << 30)
#define K2_TILE 128          // ids of a per CTA of the fused kernel
#define K2_CHUNK 1024        // ids of b per shared-memory chunk

__device__ __forceinline__ unsigned popc4(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
    return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// Σ of every thread's `total` into *out: a warp shuffle, a shared-memory
// reduce, one 64-bit atomicAdd per CTA.
__device__ __forceinline__ void block_reduce_add(unsigned long long total,
                                                 unsigned long long* out) {
    __shared__ unsigned long long s_warp[K2_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        total += __shfl_down_sync(0xffffffffu, total, off);
    if (lane == 0) s_warp[warp] = total;
    __syncthreads();
    if (warp == 0) {
        total = lane < K2_WARPS ? s_warp[lane] : 0ull;
        #pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            total += __shfl_down_sync(0xffffffffu, total, off);
        if (lane == 0 && total) atomicAdd(out, total);
    }
}

// Mode 0's body over one container: the CTA's share of a's blocks.
__device__ __forceinline__ void count_blocks_body(
        const uint4* __restrict__ a, long long nb_a,
        unsigned long long* __restrict__ out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long stride = (long long)gridDim.x * K2_WARPS;
    unsigned long long total = 0;
    // `base` depends on the warp only, so a whole warp enters each step
    for (long long base = (long long)blockIdx.x * K2_WARPS + warp; base < nb_a;
         base += stride * K2_ILP) {
        uint4 v[K2_ILP];
        #pragma unroll
        for (int u = 0; u < K2_ILP; ++u) {
            const long long i = base + u * stride;
            v[u] = i < nb_a ? __ldcs(a + i * K2_VEC_PER_BLOCK + lane)
                            : make_uint4(0, 0, 0, 0);
        }
        #pragma unroll
        for (int u = 0; u < K2_ILP; ++u) total += popc4(v[u]);
    }
    block_reduce_add(total, out);
}

__global__ void __launch_bounds__(K2_THREADS)
count_blocks_kernel(const uint4* __restrict__ a, long long nb_a,
                    unsigned long long* __restrict__ out) {
    count_blocks_body(a, nb_a, out);
}

// Mode 2's body over one pair of containers: the CTA's tile of a's ids.
__device__ __forceinline__ void count_and_blocks_body(
        const uint4* __restrict__ a, const uint4* __restrict__ b,
        const int* __restrict__ ids_a, const int* __restrict__ ids_b,
        int nb_a, int nb_b, unsigned long long* __restrict__ out) {
    __shared__ int s_ids_a[K2_TILE];
    __shared__ int s_chunk[K2_CHUNK];
    __shared__ int s_pair_a[K2_TILE], s_pair_b[K2_TILE];
    __shared__ int s_n_pairs;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int tile0 = blockIdx.x * K2_TILE;

    // 1-2: the tile's ids, its first id and the first probes of b, all in
    // one round trip (the probe positions do not depend on the key).
    // lower_bound(ids_b, key_lo) lies in [lo, hi]
    int lo = 0, hi = nb_b;
    int step = nb_b / K2_THREADS;  // >= 4 whenever a round probes
    int probe = hi - lo > K2_CHUNK ? __ldg(ids_b + tid * step) : 0;
    const int key_lo = __ldg(ids_a + tile0);
    int mine = K2_SENTINEL;
    if (tid < K2_TILE) {
        if (tile0 + tid < nb_a) mine = __ldg(ids_a + tile0 + tid);
        s_ids_a[tid] = mine;
    }
    if (tid == 0) s_n_pairs = 0;
    if (key_lo == K2_SENTINEL) return;  // padding only: uniform over the CTA
    while (hi - lo > K2_CHUNK) {
        // probes ascend with tid, so those below key_lo are a prefix
        const int below = __syncthreads_count(probe < key_lo);
        if (below == 0) {
            hi = lo;
        } else {
            hi = below < K2_THREADS ? lo + below * step : hi;
            lo += (below - 1) * step + 1;
        }
        step = (hi - lo) / K2_THREADS;
        if (hi - lo > K2_CHUNK) probe = __ldg(ids_b + lo + tid * step);
    }
    // the tile's real ids, hence its last one (ids ascend, padding last)
    const int n_real = __syncthreads_count(tid < K2_TILE && mine != K2_SENTINEL);
    const int key_hi = s_ids_a[n_real - 1];

    // 3: walk b's ids from lo in chunks until one reaches key_hi
    int partner = -1;
    for (int pos = lo; pos < nb_b; pos += K2_CHUNK) {
        #pragma unroll
        for (int j = 0; j < K2_CHUNK / K2_THREADS; ++j) {
            const int k = j * K2_THREADS + tid;
            s_chunk[k] = pos + k < nb_b ? __ldg(ids_b + pos + k) : K2_SENTINEL;
        }
        __syncthreads();
        if (tid < n_real && partner < 0) {
            int l = 0, h = K2_CHUNK;
            while (l < h) {
                const int m = (l + h) >> 1;
                if (s_chunk[m] < mine) l = m + 1;
                else h = m;
            }
            if (l < K2_CHUNK && s_chunk[l] == mine) partner = pos + l;
        }
        const bool done = s_chunk[K2_CHUNK - 1] >= key_hi;
        __syncthreads();  // every thread read the chunk before it is refilled
        if (done) break;
    }

    // 4: compact the matched pairs
    const unsigned hit = __ballot_sync(0xffffffffu, partner >= 0);
    int base = 0;
    if (lane == 0 && hit) base = atomicAdd(&s_n_pairs, __popc(hit));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (partner >= 0) {
        const int slot = base + __popc(hit & ((1u << lane) - 1));
        s_pair_a[slot] = tile0 + tid;
        s_pair_b[slot] = partner;
    }
    __syncthreads();
    const int n_pairs = s_n_pairs;

    // 5: stream the matched block pairs. The loads are unconditional (a
    // batch's tail repeats the last pair and is masked out of the sum) so
    // that all 2 * K2_ILP of a warp's loads are in flight at once.
    unsigned long long total = 0;
    for (int p0 = warp * K2_ILP; p0 < n_pairs; p0 += K2_WARPS * K2_ILP) {
        uint4 v[K2_ILP], w[K2_ILP];
        #pragma unroll
        for (int u = 0; u < K2_ILP; ++u) {
            const int p = min(p0 + u, n_pairs - 1);
            v[u] = __ldcs(a + (long long)s_pair_a[p] * K2_VEC_PER_BLOCK + lane);
            w[u] = __ldcs(b + (long long)s_pair_b[p] * K2_VEC_PER_BLOCK + lane);
        }
        #pragma unroll
        for (int u = 0; u < K2_ILP; ++u)
            if (p0 + u < n_pairs) total += popc4(and4(v[u], w[u]));
    }
    block_reduce_add(total, out);
}

__global__ void __launch_bounds__(K2_THREADS)
count_blocks_kernel_fused(const uint4* __restrict__ a, const uint4* __restrict__ b,
                          const int* __restrict__ ids_a, const int* __restrict__ ids_b,
                          int nb_a, int nb_b, unsigned long long* __restrict__ out) {
    count_and_blocks_body(a, b, ids_a, ids_b, nb_a, nb_b, out);
}

// One full wave: as many blocks as can be resident at once.
template <typename Kernel>
static int resident_blocks(Kernel kernel) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K2_THREADS, 0);
    if (sms < 1) sms = 132;
    if (per_sm < 1) per_sm = 1;
    return sms * per_sm;
}

// Plain C entry point, bound with ctypes. `a` and `b` are [nb, 128] word
// arrays (16-byte aligned), `ids_a` / `ids_b` [nb] int32 block ids sorted
// ascending with padding last (mode 2 only; b and the ids are NULL in
// mode 0). Mode 2 takes nb_a, nb_b < 2^31. Zeroes `out` (one uint64) and
// launches on `stream`. Returns cudaGetLastError().
extern "C" int count_blocks_launch(int mode, const void* a, const void* b,
                                   const void* ids_a, const void* ids_b,
                                   long long nb_a, long long nb_b, void* out,
                                   void* stream) {
    if ((mode != 0 && mode != 2) || nb_a < 0 || nb_b < 0 ||
        (mode == 2 && (!b || !ids_a || !ids_b || nb_a > INT_MAX - K2_TILE ||
                       nb_b > INT_MAX - K2_CHUNK)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    if (nb_a == 0 || (mode == 2 && nb_b == 0)) return (int)cudaGetLastError();
    unsigned long long* o = (unsigned long long*)out;
    if (mode == 0) {
        static const int cap = resident_blocks(count_blocks_kernel);
        const long long want = (nb_a + K2_WARPS - 1) / K2_WARPS;
        count_blocks_kernel<<<(unsigned)(want < cap ? want : cap), K2_THREADS, 0, s>>>(
            (const uint4*)a, nb_a, o);
    } else {
        const unsigned tiles = (unsigned)((nb_a + K2_TILE - 1) / K2_TILE);
        count_blocks_kernel_fused<<<tiles, K2_THREADS, 0, s>>>(
            (const uint4*)a, (const uint4*)b, (const int*)ids_a,
            (const int*)ids_b, (int)nb_a, (int)nb_b, o);
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The batched entry: B members of one shape in one launch.
//
// Replaces `count_blocks_stack` and `count_and_blocks_stack` (pilosa_tpu/
// ops/pallas_kernels.py:235, :245; call :218) as the TPU package's vmapped
// count program runs them (`_vmap_count_fn`, pilosa_tpu/exec/stacked.py:1620):
// `jax.vmap` of a `pallas_call` is one kernel with the batch as an extra grid
// axis. Here too: the grid is the single kernels' grid with the member as
// blockIdx.y — mode 0's resident wave split evenly over the members, mode
// 2's one CTA per K2_TILE ids of a. Every member of a batch has the same
// nb_a (and, in mode 2, nb_b): the callers group members on their exact
// shapes.
//
// Member q's pointers are row q of a device-resident int64 table (mode 0:
// a's blocks; mode 2: a's blocks, b's blocks, a's ids, b's ids). Each CTA
// stages its row in shared memory: B pointers as kernel parameters indexed
// by blockIdx would be copied to local memory (ROADMAP trap 6). Then it runs
// the single kernel's body on that member and adds its sum into out[q].
// A mode-2 tile of padding only exits, as in the single kernel.
//
// Bound: memory, as the single kernels: every member's blocks that count
// and its id arrays read once, plus the table and the B totals.

#define K2B_MODE0_PTRS 1
#define K2B_MODE2_PTRS 4

__global__ void __launch_bounds__(K2_THREADS)
count_blocks_batch_kernel(const long long* __restrict__ table, long long nb_a,
                          unsigned long long* __restrict__ out) {
    __shared__ long long s_ptr[K2B_MODE0_PTRS];
    if (threadIdx.x < K2B_MODE0_PTRS)
        s_ptr[threadIdx.x] = table[(long long)blockIdx.y * K2B_MODE0_PTRS + threadIdx.x];
    __syncthreads();
    count_blocks_body(reinterpret_cast<const uint4*>(s_ptr[0]), nb_a,
                      out + blockIdx.y);
}

__global__ void __launch_bounds__(K2_THREADS)
count_blocks_fused_batch_kernel(const long long* __restrict__ table, int nb_a,
                                int nb_b, unsigned long long* __restrict__ out) {
    __shared__ long long s_ptr[K2B_MODE2_PTRS];
    if (threadIdx.x < K2B_MODE2_PTRS)
        s_ptr[threadIdx.x] = table[(long long)blockIdx.y * K2B_MODE2_PTRS + threadIdx.x];
    __syncthreads();
    count_and_blocks_body(reinterpret_cast<const uint4*>(s_ptr[0]),
                          reinterpret_cast<const uint4*>(s_ptr[1]),
                          reinterpret_cast<const int*>(s_ptr[2]),
                          reinterpret_cast<const int*>(s_ptr[3]), nb_a, nb_b,
                          out + blockIdx.y);
}

// Plain C entry point, bound with ctypes. `table` is a device [n_members,
// 1] (mode 0) or [n_members, 4] (mode 2: a, b, ids_a, ids_b) int64 array of
// pointers, laid out as count_blocks_launch takes them (16-byte aligned
// blocks, sorted ids with padding last); every member has nb_a blocks of a
// and, in mode 2, nb_b of b (< 2^31 each). 1 <= n_members <= 65535 (grid.y).
// Zeroes `out` (n_members uint64) and launches on `stream`; with nb_a == 0,
// or nb_b == 0 in mode 2, it launches nothing. Returns cudaGetLastError().
extern "C" int count_blocks_batch_launch(int mode, const void* table,
                                         int n_members, long long nb_a,
                                         long long nb_b, void* out,
                                         void* stream) {
    if ((mode != 0 && mode != 2) || !table || n_members < 1 ||
        n_members > 65535 || nb_a < 0 || nb_b < 0 ||
        (mode == 2 && (nb_a > INT_MAX - K2_TILE || nb_b > INT_MAX - K2_CHUNK)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)n_members * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    if (nb_a == 0 || (mode == 2 && nb_b == 0)) return (int)cudaGetLastError();
    const long long* tab = (const long long*)table;
    unsigned long long* o = (unsigned long long*)out;
    if (mode == 0) {
        static const int cap = resident_blocks(count_blocks_batch_kernel);
        const long long want = (nb_a + K2_WARPS - 1) / K2_WARPS;
        long long per = cap / n_members;
        per = per < 1 ? 1 : (per > want ? want : per);
        count_blocks_batch_kernel<<<dim3((unsigned)per, (unsigned)n_members),
                                    K2_THREADS, 0, s>>>(tab, nb_a, o);
    } else {
        const unsigned tiles = (unsigned)((nb_a + K2_TILE - 1) / K2_TILE);
        count_blocks_fused_batch_kernel<<<dim3(tiles, (unsigned)n_members),
                                          K2_THREADS, 0, s>>>(
            tab, (int)nb_a, (int)nb_b, o);
    }
    return (int)cudaGetLastError();
}
