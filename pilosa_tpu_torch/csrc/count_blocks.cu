// K2: popcounts over block-sparse containers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `count_blocks_stack` and
// `count_and_blocks_stack` (pilosa_tpu/ops/pallas_kernels.py:235, :245;
// body `_count_blocks_kernel` :190, call :218). A block-sparse container
// keeps only the non-empty 128-word blocks of an [S, W] plane stack as
// sorted block ids [NB] int32 plus blocks [NB, 128] uint32 (held as int32
// on the PyTorch side); padding ids are SPARSE_SENTINEL with zero blocks.
// Three entries, all exact 64-bit totals:
//   mode 0  Σ popcount(a)                      count_blocks
//   mode 1  Σ popcount(a & b), b pre-aligned   count_and_blocks_aligned
//   mode 2  Σ popcount(a & b[match(ids_a)])    count_and_blocks
// Mode 2 fuses the caller's searchsorted (pilosa_tpu/ops/containers.py
// :757-761): for each of a's blocks the partner in b is found by binary
// search over ids_b inside the kernel; an unmatched or padding block is
// skipped without loading either side (a & 0 is 0).
//
// Bound: memory. Every block that counts is read once and nothing is
// written but the 8-byte total: count_blocks over the served sparse row
// (NB = 32,768) reads 16,777,216 B, ~5.0 us at an H100 SXM's 3.35 TB/s;
// count_and_blocks reads both id arrays plus the matched blocks of both
// sides. Design: a 128-word block is 512 B, so one warp owns one block
// and each lane loads one 16-byte vector of it with an evict-first load.
// Warps walk the blocks in a grid-stride loop over one resident wave and
// keep K2_ILP blocks in flight each; in mode 2, lanes 0..K2_ILP-1 run the
// K2_ILP binary searches at once (ids_b is at most 512 KB and stays in
// L2) and broadcast each result with __shfl_sync. Per-thread 64-bit sums
// go through a warp shuffle and a block reduce to one 64-bit atomicAdd
// per block. The Pallas kernel's [8, 128] int32 accumulator carried
// across grid steps is TPU tiling and is not kept.

#include <cuda_runtime.h>
#include <stdint.h>

#define K2_THREADS 256
#define K2_WARPS (K2_THREADS / 32)
#define K2_ILP 4
#define K2_VEC_PER_BLOCK 32  // 128 words = 32 uint4
#define K2_SENTINEL (1 << 30)

__device__ __forceinline__ unsigned popc4(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
    return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// Row of ids_b equal to `key`, or -1 (lower bound, then compare).
__device__ __forceinline__ long long find_block(const int* __restrict__ ids_b,
                                                long long nb_b, int key) {
    long long lo = 0, hi = nb_b;
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (__ldg(ids_b + mid) < key) lo = mid + 1;
        else hi = mid;
    }
    return (lo < nb_b && __ldg(ids_b + lo) == key) ? lo : -1;
}

template <int MODE>
__global__ void __launch_bounds__(K2_THREADS)
count_blocks_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                    const int* __restrict__ ids_a, const int* __restrict__ ids_b,
                    long long nb_a, long long nb_b,
                    unsigned long long* __restrict__ out) {
    __shared__ unsigned long long s_warp[K2_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long stride = (long long)gridDim.x * K2_WARPS;
    unsigned long long total = 0;
    // `base` depends on the warp only, so a whole warp enters each step
    for (long long base = (long long)blockIdx.x * K2_WARPS + warp; base < nb_a;
         base += stride * K2_ILP) {
        long long partner[K2_ILP];  // row of b to AND with, or -1 to skip
        if (MODE == 2) {
            long long mine = -1;
            if (lane < K2_ILP) {
                const long long i = base + lane * stride;
                if (i < nb_a) {
                    const int key = __ldg(ids_a + i);
                    if (key != K2_SENTINEL) mine = find_block(ids_b, nb_b, key);
                }
            }
            #pragma unroll
            for (int u = 0; u < K2_ILP; ++u)
                partner[u] = __shfl_sync(0xffffffffu, mine, u);
        } else {
            #pragma unroll
            for (int u = 0; u < K2_ILP; ++u) {
                const long long i = base + u * stride;
                partner[u] = i < nb_a ? i : -1;
            }
        }
        uint4 v[K2_ILP];
        #pragma unroll
        for (int u = 0; u < K2_ILP; ++u) {
            const long long i = base + u * stride;
            v[u] = make_uint4(0, 0, 0, 0);
            if (partner[u] >= 0) {
                v[u] = __ldcs(a + i * K2_VEC_PER_BLOCK + lane);
                if (MODE != 0)
                    v[u] = and4(v[u], __ldcs(b + partner[u] * K2_VEC_PER_BLOCK + lane));
            }
        }
        #pragma unroll
        for (int u = 0; u < K2_ILP; ++u) total += popc4(v[u]);
    }
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
// ascending (mode 2 only; b is NULL in mode 0). Zeroes `out` (one uint64)
// and launches on `stream`. Returns cudaGetLastError().
extern "C" int count_blocks_launch(int mode, const void* a, const void* b,
                                   const void* ids_a, const void* ids_b,
                                   long long nb_a, long long nb_b, void* out,
                                   void* stream) {
    if (mode < 0 || mode > 2 || nb_a < 0 || nb_b < 0 || (mode != 0 && !b) ||
        (mode == 2 && (!ids_a || !ids_b)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    if (nb_a == 0 || (mode == 2 && nb_b == 0)) return (int)cudaGetLastError();
    const long long want = (nb_a + K2_WARPS - 1) / K2_WARPS;
    const uint4* pa = (const uint4*)a;
    const uint4* pb = (const uint4*)b;
    const int* ia = (const int*)ids_a;
    const int* ib = (const int*)ids_b;
    unsigned long long* o = (unsigned long long*)out;
    if (mode == 0) {
        static const int cap = resident_blocks(count_blocks_kernel<0>);
        count_blocks_kernel<0><<<(unsigned)(want < cap ? want : cap), K2_THREADS, 0, s>>>(
            pa, pb, ia, ib, nb_a, nb_b, o);
    } else if (mode == 1) {
        static const int cap = resident_blocks(count_blocks_kernel<1>);
        count_blocks_kernel<1><<<(unsigned)(want < cap ? want : cap), K2_THREADS, 0, s>>>(
            pa, pb, ia, ib, nb_a, nb_b, o);
    } else {
        static const int cap = resident_blocks(count_blocks_kernel<2>);
        count_blocks_kernel<2><<<(unsigned)(want < cap ? want : cap), K2_THREADS, 0, s>>>(
            pa, pb, ia, ib, nb_a, nb_b, o);
    }
    return (int)cudaGetLastError();
}
