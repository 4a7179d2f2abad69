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
// The batched entry: B members of one shape in one launch, and for the
// batches that concurrent Counts form, one device operation a call.
//
// Replaces `count_blocks_stack` and `count_and_blocks_stack` (pilosa_tpu/
// ops/pallas_kernels.py:235, :245; call :218) as the TPU package's vmapped
// count program runs them (`_vmap_count_fn`, pilosa_tpu/exec/stacked.py:1620):
// `jax.vmap` of a `pallas_call` is one kernel with the batch as an extra grid
// axis. Here too: the member is blockIdx.y, and every member of a batch has
// the same nb_a (and, in mode 2, nb_b): the callers group members on their
// exact shapes.
//
// Bound: memory, as the single kernels: every member's blocks that count and
// its id arrays read once, and per member its 8-byte total written and its
// 8-byte state word. At the small batches that concurrent Counts form
// (B = 2-4) a call's fixed part weighed most: a pinned pointer table copied
// to the card and a memset before the kernel, and in mode 2 a chain of
// dependent trips to memory with nothing else in flight, since every CTA of
// a small batch runs it at once. The design:
//  - members by value: up to K2B_SLOTS pointers (mode 0: 128 members of 1,
//    mode 2: 32 members of 4; 1 KiB) ride in the launch's parameters, so
//    the host builds no table and the call copies nothing to the card.
//    Thread 0 reads its member's row into shared memory. The parameter is
//    `const __grid_constant__`, so reading it at the run-time index
//    blockIdx.y copies nothing to local memory (ptxas: 0-byte frame), and it
//    is faster than a select over all slots at compile-time indices. Larger
//    batches keep a device table, one row a member, read the same way.
//  - no memset: each CTA adds its partial and one arrival (bit
//    K2B_ARRIVAL_SHIFT up) to its member's state word with one atomic; the
//    CTA that returns the last arrival writes out[q] and leaves the word
//    zero for the next launch on the stream (as K4's small kernel ends). A
//    member's total is at most nb_a * 4096 < 2^43 bits, under the shift,
//    and a member has at most K2B_MAX_CTAS < 2^16 CTAs, whose arrivals fit
//    above it: mode 0's grid is one resident wave over all members, and
//    mode 2 takes a CTA a tile up to K2B_MAX_CTAS tiles a member, past which
//    its CTAs walk several tiles each.
//  - the chain (mode 2), ~3 dependent trips a tile in the single kernel (a's
//    ids with the probes of b, b's chunk of ids, the matched blocks): the
//    first trip also loads the K2B_CHUNK ids of b at a's relative position
//    (tile0 * nb_b / nb_a, centred on the tile); when they span the tile's
//    first to last id, which is the rule where a and b hold ids alike, the
//    tile skips the second trip. The one-round probe of b's ids is kept
//    for the tiles whose window misses. The matched pairs go out
//    K2B_ILP = 3 a warp (2, 4 and 8 were slower, as were tiles of 64 ids).
// What is left at B = 1 on the served pair (PERF.md §6): ~1.9 us of
// launch, staging and arrival, ~1.8 us of ids and search, then ~4.7 us
// streaming 11.7 MB of scattered 512-byte blocks; the byte bound is 3.6 us.

#define K2B_SLOTS 128          // pointers carried by value: 1 KiB of parameters
#define K2B_MODE0_PTRS 1       // a's blocks
#define K2B_MODE2_PTRS 4       // a's blocks, b's blocks, a's ids, b's ids
#define K2B_ARRIVAL_SHIFT 48   // a member's total below, its arrivals above
#define K2B_MAX_CTAS 4096      // CTAs a member at most (< 2^16 arrivals)
#define K2B_TILE 128           // ids of a per tile of mode 2
#define K2B_ILP 3              // block pairs in flight per warp
#define K2B_CHUNK 1024         // ids of b per shared-memory chunk

// The launch's parameters: member q's K pointers at ptr[q * K + j] when
// `table` is NULL, else row q of the device [n_members, K] table.
struct K2BatchArgs {
    long long ptr[K2B_SLOTS];
    const long long* table;
};

// Thread 0: member blockIdx.y's K pointers into s_ptr.
template <int K>
__device__ __forceinline__ void stage_member(long long* s_ptr,
                                             const K2BatchArgs& args) {
    const int q = blockIdx.y;
    if (args.table) {
        #pragma unroll
        for (int j = 0; j < K; ++j) s_ptr[j] = args.table[(long long)q * K + j];
    } else {
        #pragma unroll
        for (int j = 0; j < K; ++j) s_ptr[j] = args.ptr[q * K + j];
    }
}

// The CTA's total (every thread's `total`, summed) and one arrival into
// the member's state word; the last of `arrivals` CTAs writes *out and
// zeroes the word.
__device__ __forceinline__ void batch_arrive(unsigned long long total,
                                             unsigned arrivals,
                                             unsigned long long* out,
                                             unsigned long long* state) {
    __shared__ unsigned long long s_warp[K2_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        total += __shfl_down_sync(0xffffffffu, total, off);
    if (lane == 0) s_warp[warp] = total;
    __syncthreads();
    if (threadIdx.x == 0) {
        #pragma unroll
        for (int w = 1; w < K2_WARPS; ++w) total += s_warp[w];
        const unsigned long long old =
            atomicAdd(state, (1ull << K2B_ARRIVAL_SHIFT) + total);
        if ((old >> K2B_ARRIVAL_SHIFT) == arrivals - 1) {
            *out = (old + total) & ((1ull << K2B_ARRIVAL_SHIFT) - 1);
            *state = 0;
        }
    }
}

// Mode 0: the member's blocks over its gridDim.x CTAs, grid-stride, K2_ILP
// blocks a warp in flight (count_blocks_body's loop).
__global__ void __launch_bounds__(K2_THREADS)
count_blocks_batch_kernel(const __grid_constant__ K2BatchArgs args,
                          long long nb_a, unsigned long long* __restrict__ out,
                          unsigned long long* __restrict__ state) {
    __shared__ long long s_ptr[K2B_MODE0_PTRS];
    if (threadIdx.x == 0) stage_member<K2B_MODE0_PTRS>(s_ptr, args);
    __syncthreads();
    const uint4* __restrict__ a = reinterpret_cast<const uint4*>(s_ptr[0]);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long stride = (long long)gridDim.x * K2_WARPS;
    unsigned long long total = 0;
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
    batch_arrive(total, gridDim.x, out + blockIdx.y, state + blockIdx.y);
}

// Mode 2: member blockIdx.y's tiles of K2B_TILE ids of a, tile blockIdx.x
// and every gridDim.x-th tile after it (gridDim.x is the member's tiles up
// to K2B_MAX_CTAS, so the served shapes take one tile a CTA).
__global__ void __launch_bounds__(K2_THREADS)
count_blocks_fused_batch_kernel(const __grid_constant__ K2BatchArgs args,
                                int nb_a, int nb_b,
                                unsigned long long* __restrict__ out,
                                unsigned long long* __restrict__ state) {
    __shared__ long long s_ptr[K2B_MODE2_PTRS];
    __shared__ int s_ids_a[K2B_TILE];
    __shared__ int s_chunk[K2B_CHUNK];
    __shared__ int s_pair_a[K2B_TILE], s_pair_b[K2B_TILE];
    __shared__ int s_n_pairs;
    if (threadIdx.x == 0) stage_member<K2B_MODE2_PTRS>(s_ptr, args);
    __syncthreads();
    const uint4* __restrict__ a = reinterpret_cast<const uint4*>(s_ptr[0]);
    const uint4* __restrict__ b = reinterpret_cast<const uint4*>(s_ptr[1]);
    const int* __restrict__ ids_a = reinterpret_cast<const int*>(s_ptr[2]);
    const int* __restrict__ ids_b = reinterpret_cast<const int*>(s_ptr[3]);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n_tiles = (nb_a + K2B_TILE - 1) / K2B_TILE;
    unsigned long long total = 0;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int tile0 = tile * K2B_TILE;
        // first trip: the tile's ids, the first probes of b, and b's ids
        // at a's relative position; lower_bound(ids_b, key_lo) lies in
        // [lo, hi]
        int lo = 0, hi = nb_b;
        int step = nb_b / K2_THREADS;  // >= 4 whenever a round probes
        int probe = hi - lo > K2B_CHUNK ? __ldg(ids_b + tid * step) : 0;
        const int key_lo = __ldg(ids_a + tile0);
        int mine = K2_SENTINEL;
        if (tid < K2B_TILE) {
            if (tile0 + tid < nb_a) mine = __ldg(ids_a + tile0 + tid);
            s_ids_a[tid] = mine;
        }
        const long long guess = (long long)tile0 * nb_b / nb_a
                                - (K2B_CHUNK - K2B_TILE) / 2;
        const int win = (int)(guess < 0 ? 0 : guess);
        #pragma unroll
        for (int j = 0; j < K2B_CHUNK / K2_THREADS; ++j) {
            const int k = j * K2_THREADS + tid;
            s_chunk[k] = win + k < nb_b ? __ldg(ids_b + win + k) : K2_SENTINEL;
        }
        if (tid == 0) s_n_pairs = 0;
        // padding only (uniform over the CTA): so is every later tile
        if (key_lo == K2_SENTINEL) break;
        while (hi - lo > K2B_CHUNK) {
            // probes ascend with tid, so those below key_lo are a prefix
            const int below = __syncthreads_count(probe < key_lo);
            if (below == 0) {
                hi = lo;
            } else {
                hi = below < K2_THREADS ? lo + below * step : hi;
                lo += (below - 1) * step + 1;
            }
            step = (hi - lo) / K2_THREADS;
            if (hi - lo > K2B_CHUNK) probe = __ldg(ids_b + lo + tid * step);
        }
        // the tile's real ids, hence its last one (ids ascend, padding last)
        const int n_real =
            __syncthreads_count(tid < K2B_TILE && mine != K2_SENTINEL);
        const int key_hi = s_ids_a[n_real - 1];

        // the window holds every id of b in [key_lo, key_hi] when it starts
        // below key_lo (or at 0) and ends at or past key_hi; the barrier
        // also keeps the window until every thread has read it
        int partner = -1;
        const bool covered = __syncthreads_and(
            (win == 0 || s_chunk[0] < key_lo) &&
            s_chunk[K2B_CHUNK - 1] >= key_hi);
        if (covered) {
            if (tid < n_real) {
                int l = 0, h = K2B_CHUNK;
                while (l < h) {
                    const int m = (l + h) >> 1;
                    if (s_chunk[m] < mine) l = m + 1;
                    else h = m;
                }
                if (l < K2B_CHUNK && s_chunk[l] == mine) partner = win + l;
            }
        } else {
            // second trip: b's ids from lo in chunks until one reaches key_hi
            for (int pos = lo; pos < nb_b; pos += K2B_CHUNK) {
                #pragma unroll
                for (int j = 0; j < K2B_CHUNK / K2_THREADS; ++j) {
                    const int k = j * K2_THREADS + tid;
                    s_chunk[k] = pos + k < nb_b ? __ldg(ids_b + pos + k)
                                                : K2_SENTINEL;
                }
                __syncthreads();
                if (tid < n_real && partner < 0) {
                    int l = 0, h = K2B_CHUNK;
                    while (l < h) {
                        const int m = (l + h) >> 1;
                        if (s_chunk[m] < mine) l = m + 1;
                        else h = m;
                    }
                    if (l < K2B_CHUNK && s_chunk[l] == mine) partner = pos + l;
                }
                const bool done = s_chunk[K2B_CHUNK - 1] >= key_hi;
                __syncthreads();  // every thread read the chunk before it is refilled
                if (done) break;
            }
        }

        // compact the matched pairs
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

        // the matched block pairs, K2B_ILP a warp in flight at once (a
        // round's tail repeats the last pair and is masked out of the sum)
        for (int p0 = warp * K2B_ILP; p0 < n_pairs; p0 += K2_WARPS * K2B_ILP) {
            uint4 v[K2B_ILP], w[K2B_ILP];
            #pragma unroll
            for (int u = 0; u < K2B_ILP; ++u) {
                const int p = min(p0 + u, n_pairs - 1);
                v[u] = __ldcs(a + (long long)s_pair_a[p] * K2_VEC_PER_BLOCK + lane);
                w[u] = __ldcs(b + (long long)s_pair_b[p] * K2_VEC_PER_BLOCK + lane);
            }
            #pragma unroll
            for (int u = 0; u < K2B_ILP; ++u)
                if (p0 + u < n_pairs) total += popc4(and4(v[u], w[u]));
        }
        // every thread read n_pairs and the pairs before the next tile
        __syncthreads();
    }
    batch_arrive(total, gridDim.x, out + blockIdx.y, state + blockIdx.y);
}

static int mode0_batch_ctas(int n_members, long long nb_a) {
    static const int cap = resident_blocks(count_blocks_batch_kernel);
    const long long want = (nb_a + K2_WARPS - 1) / K2_WARPS;
    long long per = cap / n_members;
    per = per < 1 ? 1 : (per > want ? want : per);
    return (int)per;
}

// The most members whose pointers a launch carries by value in `mode` (0
// or 2), -1 for another mode: past it the caller passes a device table.
extern "C" int count_blocks_batch_by_value_cap(int mode) {
    return mode == 0 ? K2B_SLOTS / K2B_MODE0_PTRS
         : mode == 2 ? K2B_SLOTS / K2B_MODE2_PTRS : -1;
}

// Plain C entry point, bound with ctypes. The members' pointers, laid out
// as count_blocks_launch takes them (16-byte aligned blocks, sorted ids with
// padding last), K = 1 (mode 0: a) or 4 (mode 2: a, b, ids_a, ids_b) a
// member: either `ptrs`, a host array of n_members * K <= K2B_SLOTS int64
// carried by value (`table` NULL), or `table`, a device [n_members, K] int64
// array (`ptrs` NULL). Every member has nb_a >= 1 blocks of a and, in mode 2,
// nb_b >= 1 of b (< 2^31 each). 1 <= n_members <= 65535 (grid.y). `state`
// holds n_members uint64 that are zero, and are zero again after the kernel.
// Launches one kernel on `stream` and nothing else. Returns
// cudaGetLastError().
extern "C" int count_blocks_batch_launch(int mode, const long long* ptrs,
                                         const void* table, int n_members,
                                         long long nb_a, long long nb_b,
                                         void* out, void* state, void* stream) {
    const int k = mode == 0 ? K2B_MODE0_PTRS : K2B_MODE2_PTRS;
    if ((mode != 0 && mode != 2) || n_members < 1 || n_members > 65535 ||
        nb_a < 1 || (mode == 2 && nb_b < 1) || !out || !state ||
        (!ptrs == !table) || (ptrs && (long long)n_members * k > K2B_SLOTS) ||
        (mode == 2 && (nb_a > INT_MAX - K2B_TILE || nb_b > INT_MAX - K2B_CHUNK)))
        return (int)cudaErrorInvalidValue;
    K2BatchArgs args;
    args.table = (const long long*)table;
    for (int i = 0; i < K2B_SLOTS; ++i)
        args.ptr[i] = ptrs && i < n_members * k ? ptrs[i] : 0;
    cudaStream_t s = (cudaStream_t)stream;
    unsigned long long* o = (unsigned long long*)out;
    unsigned long long* st = (unsigned long long*)state;
    if (mode == 0) {
        const dim3 grid(mode0_batch_ctas(n_members, nb_a), n_members);
        count_blocks_batch_kernel<<<grid, K2_THREADS, 0, s>>>(args, nb_a, o, st);
    } else {
        const long long tiles = (nb_a + K2B_TILE - 1) / K2B_TILE;
        const dim3 grid((unsigned)(tiles < K2B_MAX_CTAS ? tiles : K2B_MAX_CTAS),
                        n_members);
        count_blocks_fused_batch_kernel<<<grid, K2_THREADS, 0, s>>>(
            args, (int)nb_a, (int)nb_b, o, st);
    }
    return (int)cudaGetLastError();
}
