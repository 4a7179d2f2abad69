// The card's rate for K4's function, Σ popcount(a & b) over bit pairs,
// by three routes, each from registers at full occupancy with no memory
// traffic (tools/k4_peak.py times them and states the rates):
//
//  mode 0, the tensor cores: independent chains of
//    mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//    (16 x 8 x 256 = 32,768 bit pairs each), K4P_CHAINS a warp;
//  mode 1, the CUDA cores' POPC: acc[m][n] += __popc(a[m] & b[n]) over
//    8 x 8 words a thread (64 LOP3 + 64 POPC + 64 IADD an iteration);
//  mode 2, a Harley–Seal carry-save count on the CUDA cores: 4 pairs of
//    16-word rows a thread, each folded through 15 carry-save adders
//    (two LOP3 each) into one POPC per 16 words.
//
// The CUDA-core loops add a constant to each B word every iteration
// (one IADD a word, 8 per 64 pairs in mode 1, 16 per 64 words in mode
// 2) so that no popcount is loop-invariant; the tensor-core chains carry
// their accumulators, so nothing in them is. Each thread folds its sums
// into out[thread] so that nothing is dead. Not on any served path.

#include <cuda_runtime.h>
#include <stdint.h>

#define K4P_CHAINS 4

__device__ __forceinline__ void mma_b1(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void peak_mma_kernel(long long iters, unsigned* out) {
    const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
    const unsigned a0 = t * 0x9E3779B9u, a1 = a0 ^ 0x55555555u,
                   a2 = a0 + 0x7F4A7C15u, a3 = ~a0;
    const unsigned b0 = t * 0x85EBCA6Bu, b1 = b0 ^ 0x33333333u;
    int acc[K4P_CHAINS][4];
    #pragma unroll
    for (int c = 0; c < K4P_CHAINS; ++c)
        #pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = 0;
    for (long long i = 0; i < iters; ++i) {
        #pragma unroll
        for (int c = 0; c < K4P_CHAINS; ++c) mma_b1(acc[c], a0, a1, a2, a3, b0, b1);
    }
    unsigned v = 0;
    #pragma unroll
    for (int c = 0; c < K4P_CHAINS; ++c)
        #pragma unroll
        for (int e = 0; e < 4; ++e) v ^= (unsigned)acc[c][e];
    out[t] = v;
}

__global__ void peak_popc_kernel(long long iters, unsigned* out) {
    const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
    unsigned a[8], b[8], acc[8][8];
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
        a[i] = (t + i) * 0x9E3779B9u;
        b[i] = (t + 17 * i) * 0x85EBCA6Bu;
    }
    #pragma unroll
    for (int m = 0; m < 8; ++m)
        #pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = 0;
    for (long long i = 0; i < iters; ++i) {
        #pragma unroll
        for (int n = 0; n < 8; ++n) b[n] += 0x6D2B79F5u;
        #pragma unroll
        for (int m = 0; m < 8; ++m)
            #pragma unroll
            for (int n = 0; n < 8; ++n) acc[m][n] += __popc(a[m] & b[n]);
    }
    unsigned v = 0;
    #pragma unroll
    for (int m = 0; m < 8; ++m)
        #pragma unroll
        for (int n = 0; n < 8; ++n) v ^= acc[m][n];
    out[t] = v;
}

// carry-save adder: (hi, lo) = a + b + c, bit by bit
__device__ __forceinline__ void csa(unsigned& hi, unsigned& lo, unsigned a,
                                    unsigned b, unsigned c) {
    const unsigned u = a ^ b;
    hi = (a & b) | (u & c);
    lo = u ^ c;
}

__global__ void peak_harley_seal_kernel(long long iters, unsigned* out) {
    const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
    unsigned a[4][16], b[16];
    #pragma unroll
    for (int w = 0; w < 16; ++w) {
        b[w] = (t + 31 * w) * 0x85EBCA6Bu;
        #pragma unroll
        for (int p = 0; p < 4; ++p) a[p][w] = (t + 16 * p + w) * 0x9E3779B9u;
    }
    unsigned ones[4], twos[4], fours[4], eights[4], cnt[4];
    #pragma unroll
    for (int p = 0; p < 4; ++p) ones[p] = twos[p] = fours[p] = eights[p] = cnt[p] = 0;
    for (long long i = 0; i < iters; ++i) {
        #pragma unroll
        for (int w = 0; w < 16; ++w) b[w] += 0x6D2B79F5u;
        #pragma unroll
        for (int p = 0; p < 4; ++p) {
            unsigned x[16];
            #pragma unroll
            for (int w = 0; w < 16; ++w) x[w] = a[p][w] & b[w];
            unsigned twosA, twosB, foursA, foursB, eightsA, eightsB, sixteens;
            csa(twosA, ones[p], ones[p], x[0], x[1]);
            csa(twosB, ones[p], ones[p], x[2], x[3]);
            csa(foursA, twos[p], twos[p], twosA, twosB);
            csa(twosA, ones[p], ones[p], x[4], x[5]);
            csa(twosB, ones[p], ones[p], x[6], x[7]);
            csa(foursB, twos[p], twos[p], twosA, twosB);
            csa(eightsA, fours[p], fours[p], foursA, foursB);
            csa(twosA, ones[p], ones[p], x[8], x[9]);
            csa(twosB, ones[p], ones[p], x[10], x[11]);
            csa(foursA, twos[p], twos[p], twosA, twosB);
            csa(twosA, ones[p], ones[p], x[12], x[13]);
            csa(twosB, ones[p], ones[p], x[14], x[15]);
            csa(foursB, twos[p], twos[p], twosA, twosB);
            csa(eightsB, fours[p], fours[p], foursA, foursB);
            csa(sixteens, eights[p], eights[p], eightsA, eightsB);
            cnt[p] += __popc(sixteens);
        }
    }
    unsigned v = 0;
    #pragma unroll
    for (int p = 0; p < 4; ++p)
        v ^= 16 * cnt[p] + 8 * __popc(eights[p]) + 4 * __popc(fours[p]) +
             2 * __popc(twos[p]) + __popc(ones[p]);
    out[t] = v;
}

static const void* peak_kernel(int mode) {
    switch (mode) {
        case 0: return (const void*)peak_mma_kernel;
        case 1: return (const void*)peak_popc_kernel;
        case 2: return (const void*)peak_harley_seal_kernel;
        default: return nullptr;
    }
}

// Resident blocks of `threads` threads an SM for `mode`, or -1.
extern "C" int k4_peak_occupancy(int mode, int threads) {
    const void* k = peak_kernel(mode);
    if (!k) return -1;
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, 0) != cudaSuccess)
        return -1;
    return per_sm;
}

// One launch of `mode`'s loop, `iters` iterations a thread; `out` holds
// blocks x threads uint32. Returns cudaGetLastError().
extern "C" int k4_peak_launch(int mode, int blocks, int threads, long long iters,
                              void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    unsigned* o = (unsigned*)out;
    switch (mode) {
        case 0: peak_mma_kernel<<<blocks, threads, 0, s>>>(iters, o); break;
        case 1: peak_popc_kernel<<<blocks, threads, 0, s>>>(iters, o); break;
        case 2: peak_harley_seal_kernel<<<blocks, threads, 0, s>>>(iters, o); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
