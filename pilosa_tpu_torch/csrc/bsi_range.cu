// K5: signed BSI range mask over bit planes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `bsi_range_mask`
// (pilosa_tpu/ops/pallas_kernels.py:493, body `_bsi_range_kernel` :422,
// call :479). A BSI field stores each value sign-magnitude across bit-plane
// rows: exists, sign, and D magnitude planes, LSB first (reference
// fragment.go:91-93). For every word position of T words (T = S·W for a
// [D, S, W] stacked view, W for one shard) the kernel walks the magnitude
// planes MSB first against the predicate magnitude,
//
//     gt |= eq & p & ~pm;   lt |= eq & ~p & pm;   eq &= ~(p ^ pm)
//
// (pm = all ones where the predicate bit is set), then applies the signed
// combine of the operator (eq, lt, gt; neq, lte and gte are composed by the
// caller) and writes the [T] mask. The predicate magnitude arrives as one
// 64-bit scalar (bit d is plane d's predicate bit), so no runtime-indexed
// array sits in a kernel parameter; op, neg_pred and allow_eq are template
// parameters.
//
// Bound: memory. Every word of the D planes, sign and exists is read once
// and the mask written once: (D + 3)·T·4 bytes, e.g. 24 × 128 × 131,072 =
// 402,653,184 B at D = 21, S = 128, ~120 us at an H100 SXM's 3.35 TB/s.
// Each word is read once, so nothing is staged in shared memory: a
// one-wave grid-stride loop over 16-byte vectors, K5_ILP vectors per
// thread in flight for each plane, evict-first loads and streaming stores.
// The TPU kernel's 4096-word blocks and depth padded to 8 sublanes are TPU
// tiling and are not kept.

#include <cuda_runtime.h>
#include <stdint.h>

#define K5_THREADS 256
#define K5_ILP 4

enum { K5_EQ = 0, K5_LT = 1, K5_GT = 2 };

template <int OP, bool NEG, bool ALLOW_EQ>
__device__ __forceinline__ unsigned combine(unsigned lt, unsigned eq, unsigned gt,
                                            unsigned sign, unsigned exists) {
    const unsigned pos = exists & ~sign, neg = exists & sign;
    const unsigned eqm = ALLOW_EQ ? eq : 0u;
    if (OP == K5_EQ) return (NEG ? neg : pos) & eq;
    if (OP == K5_LT) return NEG ? (neg & (gt | eqm)) : (neg | (pos & (lt | eqm)));
    return NEG ? (pos | (neg & (lt | eqm))) : (pos & (gt | eqm));
}

__device__ __forceinline__ void step(unsigned p, unsigned pm, unsigned& lt,
                                     unsigned& eq, unsigned& gt) {
    gt |= eq & p & ~pm;
    lt |= eq & ~p & pm;
    eq &= ~(p ^ pm);
}

template <int OP, bool NEG, bool ALLOW_EQ>
__global__ void __launch_bounds__(K5_THREADS)
bsi_range_kernel(const uint4* __restrict__ planes, long long plane_vec_stride,
                 int depth, unsigned long long pred,
                 const uint4* __restrict__ sign, const uint4* __restrict__ exists,
                 uint4* __restrict__ out, long long n_vec) {
    const long long stride = (long long)gridDim.x * K5_THREADS;
    for (long long base = (long long)blockIdx.x * K5_THREADS + threadIdx.x;
         base < n_vec; base += stride * K5_ILP) {
        uint4 lt[K5_ILP], eq[K5_ILP], gt[K5_ILP];
        #pragma unroll
        for (int u = 0; u < K5_ILP; ++u) {
            lt[u] = make_uint4(0, 0, 0, 0);
            gt[u] = make_uint4(0, 0, 0, 0);
            eq[u] = make_uint4(~0u, ~0u, ~0u, ~0u);
        }
        for (int d = depth - 1; d >= 0; --d) {
            const unsigned pm = 0u - (unsigned)((pred >> d) & 1ull);
            const uint4* row = planes + (long long)d * plane_vec_stride;
            uint4 p[K5_ILP];
            #pragma unroll
            for (int u = 0; u < K5_ILP; ++u) {
                const long long i = base + u * stride;
                p[u] = i < n_vec ? __ldcs(row + i) : make_uint4(0, 0, 0, 0);
            }
            #pragma unroll
            for (int u = 0; u < K5_ILP; ++u) {
                step(p[u].x, pm, lt[u].x, eq[u].x, gt[u].x);
                step(p[u].y, pm, lt[u].y, eq[u].y, gt[u].y);
                step(p[u].z, pm, lt[u].z, eq[u].z, gt[u].z);
                step(p[u].w, pm, lt[u].w, eq[u].w, gt[u].w);
            }
        }
        #pragma unroll
        for (int u = 0; u < K5_ILP; ++u) {
            const long long i = base + u * stride;
            if (i >= n_vec) continue;
            const uint4 s = __ldcs(sign + i), e = __ldcs(exists + i);
            uint4 r;
            r.x = combine<OP, NEG, ALLOW_EQ>(lt[u].x, eq[u].x, gt[u].x, s.x, e.x);
            r.y = combine<OP, NEG, ALLOW_EQ>(lt[u].y, eq[u].y, gt[u].y, s.y, e.y);
            r.z = combine<OP, NEG, ALLOW_EQ>(lt[u].z, eq[u].z, gt[u].z, s.z, e.z);
            r.w = combine<OP, NEG, ALLOW_EQ>(lt[u].w, eq[u].w, gt[u].w, s.w, e.w);
            __stcs(out + i, r);
        }
    }
}

template <typename Kernel>
static int resident_blocks(Kernel kernel) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K5_THREADS, 0);
    if (sms < 1) sms = 132;
    if (per_sm < 1) per_sm = 1;
    return sms * per_sm;
}

template <int OP, bool NEG, bool ALLOW_EQ>
static int launch(const uint4* planes, long long plane_vec_stride, int depth,
                  unsigned long long pred, const uint4* sign, const uint4* exists,
                  uint4* out, long long n_vec, cudaStream_t s) {
    static const int cap = resident_blocks(bsi_range_kernel<OP, NEG, ALLOW_EQ>);
    const long long most = (n_vec + (long long)K5_THREADS * K5_ILP - 1) /
                           ((long long)K5_THREADS * K5_ILP);
    const long long blocks = most < cap ? most : cap;
    bsi_range_kernel<OP, NEG, ALLOW_EQ><<<(unsigned)blocks, K5_THREADS, 0, s>>>(
        planes, plane_vec_stride, depth, pred, sign, exists, out, n_vec);
    return (int)cudaGetLastError();
}

template <int OP>
static int launch_op(int neg_pred, int allow_eq, const uint4* planes,
                     long long stride, int depth, unsigned long long pred,
                     const uint4* sign, const uint4* exists, uint4* out,
                     long long n_vec, cudaStream_t s) {
    if (neg_pred)
        return allow_eq
            ? launch<OP, true, true>(planes, stride, depth, pred, sign, exists, out, n_vec, s)
            : launch<OP, true, false>(planes, stride, depth, pred, sign, exists, out, n_vec, s);
    return allow_eq
        ? launch<OP, false, true>(planes, stride, depth, pred, sign, exists, out, n_vec, s)
        : launch<OP, false, false>(planes, stride, depth, pred, sign, exists, out, n_vec, s);
}

// Plain C entry point, bound with ctypes. `planes` points at plane 0 of
// `depth` planes, each `n_words` words long and `plane_stride` words after
// the previous one; `sign`, `exists` and `out` are [n_words] word arrays.
// Every pointer is 16-byte aligned; n_words and plane_stride are multiples
// of 4; 1 <= depth <= 64; op is 0 (eq), 1 (lt) or 2 (gt). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int bsi_range_launch(const void* planes, long long plane_stride,
                                int depth, unsigned long long pred,
                                const void* sign, const void* exists, int op,
                                int neg_pred, int allow_eq, void* out,
                                long long n_words, void* stream) {
    if (depth < 1 || depth > 64 || n_words < 0 || n_words % 4 != 0 ||
        plane_stride % 4 != 0 || op < K5_EQ || op > K5_GT)
        return (int)cudaErrorInvalidValue;
    const long long n_vec = n_words / 4;
    if (n_vec == 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const uint4* p = (const uint4*)planes;
    const uint4* sg = (const uint4*)sign;
    const uint4* ex = (const uint4*)exists;
    uint4* o = (uint4*)out;
    const long long vs = plane_stride / 4;
    if (op == K5_EQ) return launch_op<K5_EQ>(neg_pred, 0, p, vs, depth, pred, sg, ex, o, n_vec, s);
    if (op == K5_LT) return launch_op<K5_LT>(neg_pred, allow_eq, p, vs, depth, pred, sg, ex, o, n_vec, s);
    return launch_op<K5_GT>(neg_pred, allow_eq, p, vs, depth, pred, sg, ex, o, n_vec, s);
}
