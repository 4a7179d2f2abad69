// K3: per-row filtered popcounts over a row stack, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel behind `topn_counts_stack`
// (pilosa_tpu/ops/pallas_kernels.py:515, body `_topn_kernel` :260, call
// :280). out[r] = Σ_w popcount(rows[r, w] & filt[w]) over a [R, T] uint32
// stack (held as int32 on the PyTorch side), T = S·W for a [R, S, W]
// row chunk viewed flat. The filter is optional. Totals are exact 64-bit
// counts; the top-k that the TPU function does after its kernel is a
// stable sort in the wrapper (ops/row_counts.py).
//
// Bound: memory. Every row word is read once and the filter once:
// (R·T + T)·4 bytes, e.g. 131,072,000 + 1,310,720 bytes for TopN's
// [100, 10·32768] chunk, ~39.5 us at an H100 SXM's 3.35 TB/s. Row words
// stream through with 16-byte evict-first loads, K3_ILP vectors per
// thread in flight; filter words use the read-only path so that a filter
// that fits in the 50 MB L2 (1.3 MB at S = 10) is read from HBM once for
// all rows. One row per blockIdx.y (grid-stride past 65535 rows); blocks
// along x split the row's words, so the grid is one resident wave for
// any R. Per-thread sums go through a warp shuffle and a block reduce to
// one 64-bit atomicAdd per block and row. The TPU kernel's 128-lane
// broadcast output and 16-row padding are TPU tiling and are not kept.

#include <cuda_runtime.h>
#include <stdint.h>

#define K3_THREADS 256
#define K3_ILP 4

__device__ __forceinline__ unsigned popc4(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
    return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

template <bool HAS_FILT>
__global__ void __launch_bounds__(K3_THREADS)
row_counts_kernel(const uint4* __restrict__ rows, const uint4* __restrict__ filt,
                  int n_rows, long long n_vec, unsigned long long* __restrict__ out) {
    __shared__ unsigned long long s_warp[K3_THREADS / 32];
    const long long stride = (long long)gridDim.x * K3_THREADS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = blockIdx.y; r < n_rows; r += gridDim.y) {
        const uint4* row = rows + (long long)r * n_vec;
        unsigned long long total = 0;
        for (long long base = (long long)blockIdx.x * K3_THREADS + threadIdx.x;
             base < n_vec; base += stride * K3_ILP) {
            uint4 v[K3_ILP];
            #pragma unroll
            for (int u = 0; u < K3_ILP; ++u) {
                const long long i = base + u * stride;
                v[u] = i < n_vec ? __ldcs(row + i) : make_uint4(0, 0, 0, 0);
            }
            if (HAS_FILT) {
                #pragma unroll
                for (int u = 0; u < K3_ILP; ++u) {
                    const long long i = base + u * stride;
                    if (i < n_vec) v[u] = and4(v[u], __ldg(filt + i));
                }
            }
            #pragma unroll
            for (int u = 0; u < K3_ILP; ++u) total += popc4(v[u]);
        }
        #pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            total += __shfl_down_sync(0xffffffffu, total, off);
        if (lane == 0) s_warp[warp] = total;
        __syncthreads();
        if (warp == 0) {
            total = lane < (K3_THREADS / 32) ? s_warp[lane] : 0ull;
            #pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                total += __shfl_down_sync(0xffffffffu, total, off);
            if (lane == 0 && total) atomicAdd(out + r, total);
        }
        __syncthreads();  // s_warp is reused by the next row
    }
}

template <typename Kernel>
static int resident_blocks(Kernel kernel) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K3_THREADS, 0);
    if (sms < 1) sms = 132;
    if (per_sm < 1) per_sm = 1;
    return sms * per_sm;
}

// Plain C entry point, bound with ctypes. `rows` is a [n_rows, n_words]
// word array, `filt` a [n_words] word array or NULL (both 16-byte
// aligned, n_words a multiple of 4). Zeroes `out` (n_rows uint64) and
// launches on `stream`. Returns cudaGetLastError().
extern "C" int row_counts_launch(const void* rows, const void* filt, int n_rows,
                                 long long n_words, void* out, void* stream) {
    if (n_rows < 0 || n_words < 0 || n_words % 4 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long) * (size_t)n_rows, s);
    if (err != cudaSuccess) return (int)err;
    const long long n_vec = n_words / 4;
    if (n_rows == 0 || n_vec == 0) return (int)cudaGetLastError();
    static const int cap_f = resident_blocks(row_counts_kernel<true>);
    static const int cap_n = resident_blocks(row_counts_kernel<false>);
    const int cap = filt ? cap_f : cap_n;
    const int gy = n_rows < 65535 ? n_rows : 65535;
    long long gx = (cap + gy - 1) / gy;
    const long long most = (n_vec + (long long)K3_THREADS * K3_ILP - 1) /
                           ((long long)K3_THREADS * K3_ILP);
    if (gx > most) gx = most;
    if (gx < 1) gx = 1;
    const dim3 grid((unsigned)gx, (unsigned)gy);
    if (filt)
        row_counts_kernel<true><<<grid, K3_THREADS, 0, s>>>(
            (const uint4*)rows, (const uint4*)filt, n_rows, n_vec,
            (unsigned long long*)out);
    else
        row_counts_kernel<false><<<grid, K3_THREADS, 0, s>>>(
            (const uint4*)rows, nullptr, n_rows, n_vec, (unsigned long long*)out);
    return (int)cudaGetLastError();
}
