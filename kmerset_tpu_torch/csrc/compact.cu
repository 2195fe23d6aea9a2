// B3: order-preserving stream compaction of 1-3 lanes of 4- or 8-byte
// elements, on Hopper (sm_90a).
//
// Replaces kmerset_tpu/ops/pallas_compact.py:_make_kernel (with
// _flat_shift_left), driven by _pallas_compact / _compact_call behind
// compact_select_multi.  Contract: out_b[:n_sel] = lane_b[keep] in input
// order, n_sel = sum(keep); out_b[n_sel:] is left unwritten (callers trim
// it).  Unlike the TPU kernel it needs no sorted input, no length that is
// a multiple of its block, and no per-row partition sort: those existed
// because the TPU grid runs in order on one core, DMA slices must be
// 1024-aligned and scatters are slow.  Each lane's element size (4 or 8
// bytes) is a parameter of the scatter pass, so the k = 19/23 count
// compacts its int64 keys beside int32 positions directly, where the TPU
// kernel takes the keys as two int32 lanes (hi, lo).
//
// Three passes over tiles of kTile elements:
//   1. kmerset_compact_count: per-tile count of kept elements
//      (__syncthreads_count per round of 256);
//   2. the caller's exclusive scan of the per-tile counts (a small array:
//      n / 2048 ints; the reference also scans its row counts outside its
//      kernel, pallas_compact.py:240-242);
//   3. kmerset_compact_scatter: each tile re-reads its keep flags, ranks
//      each kept element inside the tile (warp ballot + popc, then a scan
//      of the 8 warp totals in shared memory) and writes every lane to its
//      global slot.
//
// What bounds it: memory.  keep is read twice (1 B each), every lane once
// (4 or 8 B), and the kept prefix written once (4 or 8 B per lane); pass 1
// moves 1 B per element and pass 3 up to 1 + 2 * (the lanes' widths).
// Consecutive threads read consecutive elements, and kept elements of one
// warp land on consecutive addresses, so both loads and stores coalesce.
// A single pass with decoupled look-back would save the second read of
// keep; that is left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kTile = kThreads * kRounds;  // elements per block
constexpr int kMaxLanes = 3;

struct Lanes {
  const void* src[kMaxLanes];
  void* dst[kMaxLanes];
  int width[kMaxLanes];  // bytes per element: 4 or 8
  int n;
};

__device__ __forceinline__ void copy_elem(const Lanes& lanes, int b,
                                          long long i, long long dst) {
  if (lanes.width[b] == 8) {
    ((int64_t*)lanes.dst[b])[dst] = ((const int64_t*)lanes.src[b])[i];
  } else {
    ((int32_t*)lanes.dst[b])[dst] = ((const int32_t*)lanes.src[b])[i];
  }
}

__global__ void compact_count_kernel(const uint8_t* __restrict__ keep,
                                     long long n,
                                     int32_t* __restrict__ block_counts) {
  const long long base = (long long)blockIdx.x * kTile;
  int count = 0;
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    count += __syncthreads_count(i < n && keep[i] != 0);
  }
  if (threadIdx.x == 0) block_counts[blockIdx.x] = count;
}

__global__ void compact_scatter_kernel(const Lanes lanes,
                                       const uint8_t* __restrict__ keep,
                                       long long n,
                                       const int32_t* __restrict__ offsets) {
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * kTile;
  long long dst_base = offsets[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    const bool kept = i < n && keep[i] != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) warp_total[warp] = __popc(mask);
    __syncthreads();
    int before = 0, round_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_total[w];
      before += w < warp ? t : 0;
      round_total += t;
    }
    if (kept) {
      const long long dst =
          dst_base + before + __popc(mask & ((1u << lane) - 1u));
#pragma unroll
      for (int b = 0; b < kMaxLanes; ++b) {  // constant indices: no stack
        if (b < lanes.n) copy_elem(lanes, b, i, dst);
      }
    }
    dst_base += round_total;
    __syncthreads();  // warp_total is rewritten next round
  }
}

long long tiles(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" int kmerset_compact_tile() { return kTile; }

extern "C" int kmerset_compact_count(const void* keep, long long n,
                                     void* block_counts, void* stream) {
  if (n <= 0) return 0;
  compact_count_kernel<<<(unsigned)tiles(n), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)keep, n, (int32_t*)block_counts);
  return (int)cudaGetLastError();
}

// Lane b (b < n_lanes) copies from src_b to dst_b, width_b bytes (4 or 8)
// per element; unused lanes pass null pointers.
extern "C" int kmerset_compact_scatter(const void* src0, const void* src1,
                                       const void* src2, void* dst0,
                                       void* dst1, void* dst2, int width0,
                                       int width1, int width2, int n_lanes,
                                       const void* keep, long long n,
                                       const void* block_offsets,
                                       void* stream) {
  if (n <= 0) return 0;
  if (n_lanes < 1 || n_lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  const Lanes lanes = {{src0, src1, src2}, {dst0, dst1, dst2},
                       {width0, width1, width2}, n_lanes};
  for (int b = 0; b < n_lanes; ++b) {
    if (lanes.width[b] != 4 && lanes.width[b] != 8)
      return (int)cudaErrorInvalidValue;
  }
  compact_scatter_kernel<<<(unsigned)tiles(n), kThreads, 0,
                           (cudaStream_t)stream>>>(
      lanes, (const uint8_t*)keep, n, (const int32_t*)block_offsets);
  return (int)cudaGetLastError();
}
