// K4: pairwise intersect-count matrix ("popcount-GEMM"), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel behind `pairwise_counts_stack`
// (pilosa_tpu/ops/pallas_kernels.py:373, body `_pairwise_kernel` :318,
// call :361): out[i, j] = Σ_w popcount(a[i, w] & filt[w] & b[j, w]) over
// row stacks a [R1, T] and b [R2, T] of uint32 words (int32 on the
// PyTorch side), T = S·W, filter optional. Counts are exact 64-bit
// (the TPU kernel accumulated int32 behind a 2^31-bit gate).
//
// Bound. Bytes are (R1·T + R2·T + T)·4 read and R1·R2·8 written;
// operations are R1·R2·T·32 bit pairs ANDed and counted. The fastest
// route this card has for them is the tensor cores' 1-bit mma
// (`mma.sync ... m16n8k256 ... b1.b1.s32.and.popc`, 32,768 bit pairs an
// instruction): tools/k4_peak.py measures it beside the CUDA cores' POPC
// (16 words an SM a clock) and a Harley-Seal carry-save count, and K4's
// bound (ops/cuda_build.py, AND_POPC_BIT_PAIRS_PER_SECOND) takes the
// fastest; PERF.md has the three rates. At GroupBy's served shape (5 x
// 4, S = 10) K4 is bound by its 11.8 MB of bytes, and by latency: the
// whole read fits in one batch of loads.
//
// pairwise_small_kernel<RA, RB, U> (R1 = RA, R2 = RB, both 1..8, one
// instantiation per exact shape, so no padding row costs a load, a
// register, a shuffle or an atomic):
//  - the grid is a whole number of blocks per SM, from the occupancy of
//    the instantiation (fewer when the words run out first); when one
//    round of loads covers the words, each block owns one contiguous
//    slice of the word axis, of equal length rounded up to 8 vectors
//    (128 B), and the grid is then trimmed to the slices there are (at
//    5 x 4 x S = 10: 396 blocks planned, 394 slices of 208 vectors, so
//    two SMs run one block fewer); past that, blocks take chunks of
//    K4_THREADS · U vectors in turn, so that the grid sweeps the rows
//    together (a 1 x 1 tile at S = 954 was 3 % slower than its parent
//    with one long slice per block);
//  - a thread issues all of its evict-first 16-byte loads for U vectors
//    of every row (and of the filter) before its first popcount; the
//    ragged tail is clamped to the chunk's last vector and masked out of
//    the sum, so no load waits behind a guard. U = 8 / (RA + RB + 1)
//    vectors, at least 1: 2 at 1 x 1, 1 from 2 x 2 up (a budget of 16
//    vectors in flight was no faster at 5 x 4 or 1 x 1 and slower at
//    2 x 2 warm);
//  - sums are 32-bit in a thread and a warp (a thread counts at most
//    128 bits per vector it reads), 64-bit across warps; then each block
//    adds, per output, its count plus one arrival (bit 48 up) to a
//    per-stream state word with one atomic, and the block whose atomic
//    returns the last arrival writes the total to `out` and zeroes the
//    word. No fence, no ticket and no second pass: one atomic round trip
//    ends a block. `out` is written once and no memset precedes the
//    launch. (Partials per block summed by a last block, and a ticket
//    after atomic sums, were slower: each added round trips to L2.)
// Bound: the bytes, and the latency of one batch of loads. At 5 x 4 x
// S = 10 every block's loads are in flight together; with L2 just
// flushed by a write the last block's data arrives ~7.3 us after entry
// (the flush's dirty lines are written back as the rows come in).
//
// pairwise_mma_kernel (anything larger, R1 or R2 > 8) counts on the
// tensor cores: a block owns a tile of up to 128 A rows x 128 B rows
// (a side's rows split into tiles of equal height; 102 x 102, config 3's
// row chunk at S = 10, is one tile) and takes the tile's stages of
// K4T_KW words in turn with the tile's other blocks (stage slice, slice +
// n_slices, ...), one resident wave of 1 block an SM over all tiles:
//  - a producer warp keeps a K4T_STAGES-deep ring of shared-memory slots
//    full with TMA copies (one box of the tile's A rows, one of its B
//    rows, one of the filter's words a stage), each slot with a full and
//    an empty barrier, so loads stay in flight while the 16 consumer
//    warps count and no warp waits on another's arithmetic. Each word of
//    HBM is read once per tile pair; words past the row's end (a count
//    that is not a multiple of 8, one 256-bit k-step) and rows past R1 or
//    R2 arrive as zeros from the TMA, never padded in HBM;
//  - a consumer warp owns 32 x 32 outputs: per k-step it loads its A and
//    B fragments with ldmatrix (a b1 row of 128 bits is 8 b16 elements;
//    the TMA's 128-byte swizzle puts the 8 rows a matrix reads in 8 bank
//    groups) and issues 8 m16n8k256 mmas into s32 fragments; the filter
//    is ANDed into B's fragment in registers (one bit pattern for every
//    row). The warps of one A band, and of one B band, sit on four SM
//    sub-partitions, so a skinny side (100 x 5) still spreads its mmas
//    over all four tensor cores; a warp whose outputs all lie past R1 or
//    R2 sits the loop out;
//  - a block takes at most 2^22 k-steps, so an s32 sum (256 at most an
//    mma) stays under 2^30; each block ends with one 64-bit atomicAdd an
//    output it owns into `out`, zeroed on the stream first.
// What it replaced, and the designs measured against it (per-thread
// cp.async rings that all warps refilled between two barriers, and
// clusters that summed their partial tiles through distributed shared
// memory before the atomics), are in PERF.md.
//
// Kernel parameters are scalars, raw pointers and the tiled kernel's
// TMA maps (`__grid_constant__`, read by the TMA through their address):
// nothing is indexed at run time, so nothing spills to local memory.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#define K4_THREADS 256
#define K4_WARPS (K4_THREADS / 32)
#define K4_SMALL_MAX 8  // the small kernel takes R1, R2 <= 8
// a state word holds the blocks arrived above this bit, the count below
#define K4_ARRIVAL_SHIFT 48

// the tiled (tensor-core) kernel: one block of 16 warps an SM
#define K4T_CONSUMERS 512  // 16 warps: 4 (A) x 4 (B), each 32 x 32 outputs
#define K4T_THREADS (K4T_CONSUMERS + 32)  // and one warp that feeds them
#define K4T_MT 2       // m16 tiles a warp
#define K4T_NT 4       // n8 tiles a warp
#define K4T_BM 128     // A rows a tile
#define K4T_BN 128     // B rows a tile
#define K4T_KW 32      // words of each row a stage holds: 4 k-steps of 256 bits
#define K4T_ROW_BYTES (K4T_KW * 4)  // 128: one TMA 128-byte swizzle row
#define K4T_STAGES 6
// a slot: A rows, B rows, then the filter's words, 1024-byte aligned
#define K4T_FILT_OFFSET ((K4T_BM + K4T_BN) * K4T_ROW_BYTES)
#define K4T_STAGE_BYTES (K4T_FILT_OFFSET + 1024)
// the ring, its full and empty barriers, and slack to align it to 1024
#define K4T_SMEM (K4T_STAGES * (K4T_STAGE_BYTES + 16) + 1024)
// stages a block may take: 2^22 k-steps of 8 words
#define K4T_MAX_SLICE_STAGES ((1LL << 25) / K4T_KW)

__device__ __forceinline__ unsigned popc4(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
    return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ unsigned warp_sum32(unsigned v) {
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// U: 16-byte vectors a thread loads per row in one round, about 8 in
// flight in all
constexpr int small_unroll(int ra, int rb) {
    return 8 / (ra + rb + 1) > 1 ? 8 / (ra + rb + 1) : 1;
}

template <int RA, int RB, int U>
__global__ void __launch_bounds__(K4_THREADS)
pairwise_small_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                      const uint4* __restrict__ filt, long long n_vec, long long chunk,
                      unsigned long long* __restrict__ state,
                      unsigned long long* __restrict__ out) {
    constexpr int P = RA * RB;
    __shared__ unsigned long long s_warp[K4_WARPS * P];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    unsigned acc[RA][RB];
    #pragma unroll
    for (int m = 0; m < RA; ++m)
        #pragma unroll
        for (int n = 0; n < RB; ++n) acc[m][n] = 0;
    // block b takes chunks b, b + G, b + 2G, ... (one chunk when the grid
    // covers the words in one round); the loop is uniform over the block
    // and its loads are not guarded
    for (long long r0 = (long long)blockIdx.x * chunk; r0 < n_vec;
         r0 += (long long)gridDim.x * chunk) {
        const long long end = min(r0 + chunk, n_vec);
        long long idx[U];
        #pragma unroll
        for (int u = 0; u < U; ++u)
            idx[u] = min(r0 + u * K4_THREADS + tid, end - 1);
        uint4 fv[U], av[RA][U], bv[RB][U];
        if (filt) {
            #pragma unroll
            for (int u = 0; u < U; ++u) fv[u] = __ldcs(filt + idx[u]);
        }
        #pragma unroll
        for (int m = 0; m < RA; ++m)
            #pragma unroll
            for (int u = 0; u < U; ++u) av[m][u] = __ldcs(a + m * n_vec + idx[u]);
        #pragma unroll
        for (int n = 0; n < RB; ++n)
            #pragma unroll
            for (int u = 0; u < U; ++u) bv[n][u] = __ldcs(b + n * n_vec + idx[u]);
        #pragma unroll
        for (int u = 0; u < U; ++u) {
            if (r0 + u * K4_THREADS + tid >= end) continue;  // clamped repeat
            #pragma unroll
            for (int m = 0; m < RA; ++m) {
                const uint4 x = filt ? and4(av[m][u], fv[u]) : av[m][u];
                #pragma unroll
                for (int n = 0; n < RB; ++n) acc[m][n] += popc4(and4(x, bv[n][u]));
            }
        }
    }

    // block partials: 32-bit warp sums, 64-bit across the block's warps
    #pragma unroll
    for (int m = 0; m < RA; ++m)
        #pragma unroll
        for (int n = 0; n < RB; ++n) {
            const unsigned v = warp_sum32(acc[m][n]);
            if (lane == 0) s_warp[warp * P + m * RB + n] = v;
        }
    __syncthreads();
    if (tid < P) {
        unsigned long long v = 0;
        #pragma unroll
        for (int w = 0; w < K4_WARPS; ++w) v += s_warp[w * P + tid];
        // one atomic adds the count and one arrival; the last block to
        // arrive has the total and leaves the state word zero
        const unsigned long long old =
            atomicAdd(state + tid, (1ull << K4_ARRIVAL_SHIFT) + v);
        if ((old >> K4_ARRIVAL_SHIFT) == gridDim.x - 1) {
            out[tid] = (old + v) & ((1ull << K4_ARRIVAL_SHIFT) - 1);
            state[tid] = 0;
        }
    }
}

// ---- the tiled kernel: b1 tensor-core mma fed by TMA -----------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
                 : "memory");
}

// the producer's arrival on a full barrier, with the bytes its copies
// will add to the barrier's transaction count
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
    unsigned done = 0;
    do {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// one TMA copy of the box at (word w, row r) of `map` into shared memory
// at `dst`, completing on `bar`
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, int w,
                                         int r, unsigned bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"((unsigned long long)map), "r"(w), "r"(r), "r"(bar)
        : "memory");
}

// four 8 x 8 b16 matrices (8 rows of 16 bytes each): lane l gives the
// row address of matrix l / 8, row l % 8, and receives, of each matrix,
// the 4 bytes at row l / 4, bytes 4 (l % 4) .. +3
__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned& r0,
                                            unsigned& r1, unsigned& r2,
                                            unsigned& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// d += popcount(A & B) over k: A 16 x 256 bits (row), B 256 x 8 (col)
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a stage's 16-byte chunk c of tile row r (A rows 0..127, B rows
// 128..255): rows of 128 bytes, chunks XOR-swizzled by the row's low 3
// bits as the TMA's 128-byte swizzle lays them, so the 8 rows an ldmatrix
// matrix reads lie in 8 distinct bank groups
__device__ __forceinline__ unsigned chunk_offset(int r, int c) {
    return (unsigned)(r * K4T_ROW_BYTES + ((c ^ (r & 7)) << 4));
}

__global__ void __launch_bounds__(K4T_THREADS, 1)
pairwise_mma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_f, int has_filt,
                    int n_a, int n_b, int tile_a, int tile_b, int tiles_b,
                    unsigned stage_bytes, long long n_slices, long long n_stages,
                    unsigned long long* __restrict__ out) {
    extern __shared__ unsigned char smem_raw[];
    // the ring's slots, 1024-byte aligned as the 128-byte swizzle needs
    const unsigned raw = smem_addr(smem_raw);
    const unsigned sbase = (raw + 1023) & ~1023u;
    unsigned char* smem = smem_raw + (sbase - raw);
    const unsigned full = sbase + K4T_STAGES * K4T_STAGE_BYTES;  // a barrier a slot
    const unsigned empty = full + K4T_STAGES * 8;

    const long long tile = blockIdx.x / n_slices;
    const long long slice = blockIdx.x % n_slices;
    const int a0 = (int)(tile / tiles_b) * tile_a;
    const int b0 = (int)(tile % tiles_b) * tile_b;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // a warp's outputs: K4T_MT m16 tiles x K4T_NT n8 tiles; the warps of
    // one A band, and of one B band, lie on 4 different SM sub-partitions
    // (the warp's sub-partition is warp % 4), so a skinny side still
    // spreads its mmas over all four tensor cores
    const int wm = warp >> 2, wn = ((warp & 3) - wm) & 3;
    const int wa = wm * (K4T_MT * 16), wb = wn * (K4T_NT * 8);
    // the tile's blocks take its stages in turn (slice, slice + n_slices,
    // ...), so the blocks in flight read neighbouring spans of every row
    const long long n_mine = (n_stages - slice + n_slices - 1) / n_slices;
    // rows of the tile that exist: the rest are never multiplied (per
    // m16 / n8 tile, warp-uniform), and a warp with none of them sits out
    const int rows_a = min(tile_a, n_a - a0), rows_b = min(tile_b, n_b - b0);
    const bool busy = warp < K4T_CONSUMERS / 32 && wa < rows_a && wb < rows_b;

    if (tid == 0) {
        int n_busy = 0;  // the warps that release each slot
        for (int w = 0; w < K4T_CONSUMERS / 32; ++w)
            n_busy += (w >> 2) * (K4T_MT * 16) < rows_a &&
                      (((w & 3) - (w >> 2)) & 3) * (K4T_NT * 8) < rows_b;
        for (int s = 0; s < K4T_STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, n_busy);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the producer warp's first thread keeps the ring full: stage j goes
    // to slot j % K4T_STAGES once every busy warp has released the slot's
    // previous stage
    if (tid == K4T_CONSUMERS) {
        for (long long j = 0; j < n_mine; ++j) {
            const int s = (int)(j % K4T_STAGES);
            if (j >= K4T_STAGES)
                mbar_wait(empty + 8 * s, (unsigned)((j / K4T_STAGES - 1) & 1));
            const unsigned dst = sbase + s * K4T_STAGE_BYTES;
            const int w0 = (int)((slice + j * n_slices) * K4T_KW);
            mbar_expect(full + 8 * s, stage_bytes);
            tma_load(dst, &map_a, w0, a0, full + 8 * s);
            tma_load(dst + K4T_BM * K4T_ROW_BYTES, &map_b, w0, b0, full + 8 * s);
            if (has_filt) tma_load(dst + K4T_FILT_OFFSET, &map_f, w0, 0, full + 8 * s);
        }
    }

    int acc[K4T_MT][K4T_NT][4];
    #pragma unroll
    for (int mi = 0; mi < K4T_MT; ++mi)
        #pragma unroll
        for (int ni = 0; ni < K4T_NT; ++ni)
            #pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    // ldmatrix lane roles: matrix q = lane / 8, its row lane % 8
    const int q = lane >> 3, qi = lane & 7;
    const int tig = lane & 3;

    for (long long j = 0; busy && j < n_mine; ++j) {
        const int s = (int)(j % K4T_STAGES);
        mbar_wait(full + 8 * s, (unsigned)((j / K4T_STAGES) & 1));
        const unsigned buf = sbase + s * K4T_STAGE_BYTES;
        const uint32_t* sf = (const uint32_t*)(smem + s * K4T_STAGE_BYTES + K4T_FILT_OFFSET);
        #pragma unroll
        for (int kk = 0; kk < K4T_KW / 8; ++kk) {
            // B fragments, two n8 tiles an ldmatrix: matrices (rows +0..7,
            // words 0..3), (+0..7, 4..7), (+8..15, 0..3), (+8..15, 4..7)
            unsigned bf[K4T_NT][2];
            #pragma unroll
            for (int nj = 0; nj < K4T_NT / 2; ++nj) {
                const int r = wb + nj * 16 + qi + ((q >> 1) << 3);
                ldmatrix_x4(buf + chunk_offset(K4T_BM + r, kk * 2 + (q & 1)),
                            bf[2 * nj][0], bf[2 * nj][1],
                            bf[2 * nj + 1][0], bf[2 * nj + 1][1]);
            }
            if (has_filt) {  // the filter's words tig and 4 + tig of this k-step
                const unsigned f0 = sf[kk * 8 + tig], f1 = sf[kk * 8 + 4 + tig];
                #pragma unroll
                for (int ni = 0; ni < K4T_NT; ++ni) {
                    bf[ni][0] &= f0;
                    bf[ni][1] &= f1;
                }
            }
            #pragma unroll
            for (int mi = 0; mi < K4T_MT; ++mi) {
                // A fragment: matrices (rows +0..7, words 0..3), (+8..15,
                // 0..3), (+0..7, 4..7), (+8..15, 4..7)
                unsigned af[4];
                const int r = wa + mi * 16 + qi + ((q & 1) << 3);
                ldmatrix_x4(buf + chunk_offset(r, kk * 2 + (q >> 1)),
                            af[0], af[1], af[2], af[3]);
                #pragma unroll
                for (int ni = 0; ni < K4T_NT; ++ni)
                    if (wa + mi * 16 < rows_a && wb + ni * 8 < rows_b)
                        mma_and_popc(acc[mi][ni], af, bf[ni][0], bf[ni][1]);
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with slot s
    }

    // outputs of fragment element e of (mi, ni): row g (+8 for e >= 2),
    // column 2 tig (+1 for odd e), g = lane / 4
    const int g = lane >> 2;
    #pragma unroll
    for (int mi = 0; mi < K4T_MT; ++mi)
        #pragma unroll
        for (int ni = 0; ni < K4T_NT; ++ni)
            #pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = wa + mi * 16 + g + (e >> 1) * 8;
                const int c = wb + ni * 8 + tig * 2 + (e & 1);
                if (busy && r < rows_a && c < rows_b && acc[mi][ni][e])
                    atomicAdd(out + (long long)(a0 + r) * n_b + b0 + c,
                              (unsigned long long)(unsigned)acc[mi][ni][e]);
            }
}

// The small kernel's grid for n_vec vectors: a whole number of blocks
// per SM (at most the instantiation's occupancy) while every block gets
// at least one vector per thread, else one block per K4_THREADS vectors.
// Sets *chunk to the vectors a block takes per round: an equal slice,
// a multiple of 8 vectors (128 B), when one round covers the words, else
// K4_THREADS · U (the slice would need more than one batch of loads).
template <int RA, int RB>
static long long small_grid(long long n_vec, long long* chunk) {
    constexpr int U = small_unroll(RA, RB);
    // {SMs, resident blocks per SM}, set once (a thread-safe static)
    static const int2 card = [] {
        int dev = 0, sms = 0, occ = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, pairwise_small_kernel<RA, RB, U>, K4_THREADS, 0);
        return make_int2(sms < 1 ? 132 : sms, occ < 1 ? 1 : occ);
    }();
    const int sms = card.x, occ = card.y;
    const long long wave = (long long)sms * K4_THREADS;
    long long grid;
    if (n_vec >= wave) {
        long long bps = (n_vec + wave - 1) / wave;
        grid = (long long)sms * (bps < occ ? bps : occ);
    } else {
        grid = (n_vec + K4_THREADS - 1) / K4_THREADS;
    }
    long long per = (n_vec + grid - 1) / grid;
    per = (per + 7) / 8 * 8;
    if (per > (long long)K4_THREADS * U) per = (long long)K4_THREADS * U;
    *chunk = per;
    const long long chunks = (n_vec + per - 1) / per;
    return chunks < grid ? chunks : grid;
}

template <int RA, int RB>
static void launch_small(const void* a, const void* b, const void* filt,
                         long long n_vec, unsigned long long* state,
                         unsigned long long* out, cudaStream_t s) {
    long long chunk = 0;
    const long long grid = small_grid<RA, RB>(n_vec, &chunk);
    pairwise_small_kernel<RA, RB, small_unroll(RA, RB)>
        <<<(unsigned)grid, K4_THREADS, 0, s>>>(
            (const uint4*)a, (const uint4*)b, (const uint4*)filt, n_vec, chunk,
            state, out);
}

// Calls f(std::integral_constant<int, RA>, std::integral_constant<int, RB>)
// for 1 <= n_a, n_b <= K4_SMALL_MAX.
template <int RA, typename F>
static void small_shape_b(int n_b, F&& f) {
    using std::integral_constant;
    switch (n_b) {
        case 1: f(integral_constant<int, RA>(), integral_constant<int, 1>()); break;
        case 2: f(integral_constant<int, RA>(), integral_constant<int, 2>()); break;
        case 3: f(integral_constant<int, RA>(), integral_constant<int, 3>()); break;
        case 4: f(integral_constant<int, RA>(), integral_constant<int, 4>()); break;
        case 5: f(integral_constant<int, RA>(), integral_constant<int, 5>()); break;
        case 6: f(integral_constant<int, RA>(), integral_constant<int, 6>()); break;
        case 7: f(integral_constant<int, RA>(), integral_constant<int, 7>()); break;
        default: f(integral_constant<int, RA>(), integral_constant<int, 8>()); break;
    }
}

template <typename F>
static void small_shape(int n_a, int n_b, F&& f) {
    switch (n_a) {
        case 1: small_shape_b<1>(n_b, f); break;
        case 2: small_shape_b<2>(n_b, f); break;
        case 3: small_shape_b<3>(n_b, f); break;
        case 4: small_shape_b<4>(n_b, f); break;
        case 5: small_shape_b<5>(n_b, f); break;
        case 6: small_shape_b<6>(n_b, f); break;
        case 7: small_shape_b<7>(n_b, f); break;
        default: small_shape_b<8>(n_b, f); break;
    }
}

static bool is_small(int n_a, int n_b) {
    return n_a >= 1 && n_b >= 1 && n_a <= K4_SMALL_MAX && n_b <= K4_SMALL_MAX;
}

// cuTensorMapEncodeTiled (from libcuda), looked up once through the
// runtime so the library links against nothing but cudart
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
    static const EncodeTiledFn fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiledFn)p
                                                                     : nullptr;
    }();
    return fn;
}

// A TMA map of `rows` rows of `n_words` uint32 words, copied in boxes of
// K4T_KW words x `box_rows` rows, 128-byte swizzled into shared memory or
// not; words and rows past the ends arrive as zeros.
static bool row_map(CUtensorMap* map, const void* base, long long n_words, int rows,
                    int box_rows, bool swizzle) {
    const EncodeTiledFn enc = encode_tiled();
    if (!enc) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)n_words, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)n_words * 4};
    const cuuint32_t box[2] = {K4T_KW, (cuuint32_t)box_rows};
    const cuuint32_t elem_strides[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(base), dims,
               strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
               swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tiled kernel's blocks that run at once on card `dev` (one an SM),
// found once a card after allowing its shared memory (above the default
// 48 KB); -1 on an error.
static int mma_kernel_slots(int dev) {
    static std::atomic<unsigned long long> ready{0};
    static std::atomic<int> slots[64];
    if (dev < 0 || dev >= 64) return -1;
    if (!(ready.load() >> dev & 1)) {
        if (cudaFuncSetAttribute(pairwise_mma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 K4T_SMEM) != cudaSuccess)
            return -1;
        int n = 0, sms = 0;
        if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pairwise_mma_kernel, K4T_THREADS,
                                                          K4T_SMEM) != cudaSuccess)
            return -1;
        n *= sms;
        if (n < 1) return -1;
        slots[dev] = n;
        ready.fetch_or(1ull << dev);
    }
    return slots[dev].load();
}

// Plain C entry point, bound with ctypes. `a` is [n_a, n_words], `b`
// [n_b, n_words], `filt` [n_words] or NULL (all 16-byte aligned, n_words
// a multiple of 4 and, past 8 x 8, under 2^31); `out` is n_a x n_b
// uint64, row-major. For 1 <= n_a, n_b <= 8 the small kernel writes
// `out`, and `state` is n_a · n_b uint64 that are 0 and that no launch on
// another stream uses; the launch leaves them 0. Otherwise `state` is
// unused, `out` is zeroed on the stream and the tiled kernel adds into it.
// Launches on `stream`. Returns cudaGetLastError() (or the error that
// refused the launch).
extern "C" int pairwise_counts_launch(const void* a, int n_a, const void* b, int n_b,
                                      const void* filt, long long n_words,
                                      void* out, void* state, void* stream) {
    if (n_a < 0 || n_b < 0 || n_words < 0 || n_words % 4 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const long long n_vec = n_words / 4;
    unsigned long long* o = (unsigned long long*)out;
    if (is_small(n_a, n_b) && n_vec > 0) {
        // a warp's 32-bit sums stay below 2^32 while a row is under 2^36
        // words (256 GiB); the grid is far below 2^16 arrivals
        if (!state || n_words >= (1LL << 36)) return (int)cudaErrorInvalidValue;
        small_shape(n_a, n_b, [&](auto ra, auto rb) {
            launch_small<decltype(ra)::value, decltype(rb)::value>(
                a, b, filt, n_vec, (unsigned long long*)state, o, s);
        });
        return (int)cudaGetLastError();
    }
    // the TMA's word coordinate is a signed 32-bit value
    if (n_words >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(
        out, 0, sizeof(unsigned long long) * (size_t)n_a * (size_t)n_b, s);
    if (err != cudaSuccess) return (int)err;
    if (n_a == 0 || n_b == 0 || n_vec == 0) return (int)cudaGetLastError();
    int dev = 0;
    cudaGetDevice(&dev);
    const int slots = mma_kernel_slots(dev);
    if (slots < 0) {
        const int e = (int)cudaGetLastError();
        return e ? e : (int)cudaErrorInvalidConfiguration;
    }
    // a side's rows split into tiles of equal height (a multiple of 8, the
    // swizzle's period, at most 128), so that no tile's blocks wait on a
    // fuller one; a TMA box is one tile's rows
    const int tiles_a = (n_a + K4T_BM - 1) / K4T_BM, tiles_b = (n_b + K4T_BN - 1) / K4T_BN;
    const int tile_a = ((n_a + tiles_a - 1) / tiles_a + 7) / 8 * 8;
    const int tile_b = ((n_b + tiles_b - 1) / tiles_b + 7) / 8 * 8;
    CUtensorMap map_a, map_b, map_f = {};  // map_f is read only with a filter
    if (!row_map(&map_a, a, n_words, n_a, tile_a, true) ||
        !row_map(&map_b, b, n_words, n_b, tile_b, true) ||
        (filt && !row_map(&map_f, filt, n_words, 1, 1, false)))
        return (int)cudaErrorInvalidValue;
    const unsigned stage_bytes = K4T_ROW_BYTES * (tile_a + tile_b + (filt ? 1 : 0));
    const long long n_tiles = (long long)tiles_a * tiles_b;
    const long long n_stages = (n_words + K4T_KW - 1) / K4T_KW;
    // the tiles share one resident wave of blocks (at least one a tile);
    // no block takes more than K4T_MAX_SLICE_STAGES
    long long n_slices = slots / n_tiles;
    const long long min_slices = (n_stages + K4T_MAX_SLICE_STAGES - 1) / K4T_MAX_SLICE_STAGES;
    if (n_slices < min_slices) n_slices = min_slices;
    if (n_slices < 1) n_slices = 1;
    const long long grid = n_tiles * n_slices;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    pairwise_mma_kernel<<<(unsigned)grid, K4T_THREADS, K4T_SMEM, s>>>(
        map_a, map_b, map_f, filt ? 1 : 0, n_a, n_b, tile_a, tile_b, tiles_b, stage_bytes,
        n_slices, n_stages, o);
    return (int)cudaGetLastError();
}
