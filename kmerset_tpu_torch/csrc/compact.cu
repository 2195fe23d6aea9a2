// B3: order-preserving stream compaction of 1-3 lanes of 4- or 8-byte
// elements, on Hopper (sm_90a).
//
// Replaces kmerset_tpu/ops/pallas_compact.py:_make_kernel (with
// _flat_shift_left), driven by _pallas_compact / _compact_call behind
// compact_select_multi.  Contract: out_b[:n_sel] = lane_b[keep] in input
// order, n_sel = the number of nonzero keep bytes; out_b[n_sel:] is left
// unwritten (callers trim it).  Unlike the TPU kernel it needs no sorted
// input, no length that is a multiple of its block, and no per-row
// partition sort: those existed because the TPU grid runs in order on one
// core, DMA slices must be 1024-aligned and scatters are slow.  Each
// lane's element size (4 or 8 bytes) is a parameter, so the k = 19/23
// count compacts its int64 keys beside int32 positions directly, where the
// TPU kernel takes the keys as two int32 lanes (hi, lo).
//
// One pass with decoupled look-back (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016).  Each block
// takes the next tile of kTile = 4096 elements from an atomic counter, so
// every tile it looks back on belongs to a block that is already running,
// and then:
//   1. reads its 16 keep bytes per thread with one 16-byte load and ranks
//      the nonzero ones inside the tile (a warp shuffle scan of the
//      threads' counts, one shared-memory pass over the 8 warp totals);
//   2. publishes the tile's kept count as its aggregate;
//   3. loads every lane with 16-byte loads (each warp a contiguous 512-
//      element span; the rank of each element comes from its owning
//      thread's prefix and flag mask by one shuffle) and writes the kept
//      elements into shared memory at their rank;
//   4. looks back (warp 0) over the status words of the tiles before it,
//      32 at a time, summing aggregates until it meets an inclusive
//      prefix, and publishes its own inclusive prefix; the last tile writes
//      n_sel;
//   5. writes each lane's compacted run from shared memory to its global
//      offset as one contiguous range, with 16-byte stores between a
//      scalar head and tail.
// A status word holds its flag (0 none, 1 aggregate, 2 inclusive prefix) in
// its top two bits and the count below, so one 64-bit release store
// publishes both and an acquire load can never see the flag without the
// count.  The wrapper's one memset clears the tile counter and the status
// words.  Offsets are 64-bit.
//
// What bounds it: memory.  keep is read once (1 B per element), every lane
// once (4 or 8 B) and the kept prefix written once (4 or 8 B per lane);
// the status words add 8 B per 4096 elements.  Shared memory holds one
// tile of every lane (4096 x the summed widths: 16 KB for one int32 lane,
// 32 KB for two, 48 KB for int64 + int32, up to 96 KB for three int64
// lanes, opted in above the default 48 KB).  On one H100 at 2^24 elements
// it reaches 75-77% of that bound for two int32 lanes, one int64 lane or
// int64 + int32, 66% for one int32 lane and 54% for one int32 lane at 5%
// kept, where a fixed cost per call (the memset, the ramp and the tail of
// a 4096-block grid) weighs most.  Wider look-back windows, 512-thread
// tiles and 16-byte shared-memory reads on the store path measured no
// better.
//
// Inputs need no alignment: a view such as keep[1:] or a lane at an odd
// element offset is legal.  When keep or any lane is not 16-byte aligned
// the launch takes the kVec = false instance, which reads bytes and
// elements one by one; elements past n (the ragged last tile, n below a
// tile, n no multiple of 16) are read one by one in both instances.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                  // keep bytes per thread
constexpr int kTile = kThreads * kPer;    // elements per tile
constexpr int kWarpSpan = 32 * kPer;      // elements per warp
constexpr int kMaxLanes = 3;
constexpr int kMaxSmem = kTile * 8 * kMaxLanes;

constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;

struct Lanes {
  const void* src[kMaxLanes];
  void* dst[kMaxLanes];
  int width[kMaxLanes];  // bytes per element: 4 or 8
  int smem[kMaxLanes];   // byte offset of the lane's tile in shared memory
  int n;
};

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Bit j set iff byte j of w is nonzero.
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

// Bit j set iff keep[i + j] != 0, for j < kPer and i + j < n.
template <bool kVec>
__device__ __forceinline__ unsigned flag_mask(const uint8_t* __restrict__ keep,
                                              long long i, long long n) {
  if (kVec && i + kPer <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(keep + i);
    return nonzero4(v.x) | nonzero4(v.y) << 4 | nonzero4(v.z) << 8 |
           nonzero4(v.w) << 12;
  }
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (i + j < n && keep[i + j] != 0) m |= 1u << j;
  }
  return m;
}

__device__ __forceinline__ void load16(const uint32_t* p, uint32_t (&v)[4]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

__device__ __forceinline__ void load16(const uint64_t* p, uint64_t (&v)[2]) {
  const ulonglong2 x = *reinterpret_cast<const ulonglong2*>(p);
  v[0] = x.x, v[1] = x.y;
}

__device__ __forceinline__ void store16(uint32_t* p, const uint32_t* t) {
  *reinterpret_cast<uint4*>(p) = make_uint4(t[0], t[1], t[2], t[3]);
}

__device__ __forceinline__ void store16(uint64_t* p, const uint64_t* t) {
  *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(t[0], t[1]);
}

// Writes the tile's kept elements of one lane into `tile` at their ranks.
// `owner` is each thread's (exclusive rank in the tile << 16) | flag mask.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_lane(const T* __restrict__ src, T* tile,
                                           long long base, long long n,
                                           unsigned owner, int lane,
                                           int warp) {
  constexpr int V = 16 / sizeof(T);             // elements per 16-byte load
  constexpr int kLoads = kWarpSpan / (32 * V);  // 4 (int32) or 8 (int64)
  const int w0 = warp * kWarpSpan;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int q = (j * 32 + lane) * V;  // element offset in the warp's span
    const unsigned o = __shfl_sync(0xffffffffu, owner, q / kPer);
    const int sub = q % kPer;
    const long long g = base + w0 + q;
    T v[V];
    if (kVec && g + V <= n) {
      load16(src + g, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = g + i < n ? src[g + i] : T(0);
    }
    int r = (int)(o >> 16) + __popc(o & ((1u << sub) - 1u));
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if ((o >> (sub + i)) & 1u) tile[r++] = v[i];
    }
  }
}

// out[offset + r] = tile[r] for r < count: consecutive threads on
// consecutive addresses, 16-byte stores from the first 16-byte boundary.
template <typename T>
__device__ __forceinline__ void store_lane(T* __restrict__ dst, const T* tile,
                                           int count, long long offset) {
  constexpr int V = 16 / sizeof(T);
  T* out = dst + offset;
  const int lead = (int)((16 - ((uintptr_t)out & 15)) & 15) / (int)sizeof(T);
  const int head = lead < count ? lead : count;
  const int n_vec = (count - head) / V;
  for (int r = threadIdx.x; r < head; r += kThreads) out[r] = tile[r];
  for (int q = threadIdx.x; q < n_vec; q += kThreads) {
    const int r = head + q * V;
    store16(out + r, tile + r);
  }
  for (int r = head + n_vec * V + threadIdx.x; r < count; r += kThreads) {
    out[r] = tile[r];
  }
}

// The sum of the kept counts of tiles 0 .. tile-1, by warp 0 (all 32
// lanes): lane i reads the status of tile last - i, waiting while it holds
// no flag; the window's lanes up to the nearest inclusive prefix are summed.
__device__ __forceinline__ long long look_back(
    const unsigned long long* status, long long tile, int lane) {
  long long exclusive = 0;
  for (long long last = tile - 1;; last -= 32) {
    const long long i = last - lane;
    unsigned long long w = kPrefix;  // before tile 0: a prefix of 0
    if (i >= 0) {
      do {
        w = load_acquire(status + i);
      } while ((w >> 62) == 0);
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, (w >> 62) == 2);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    long long v = lane <= stop ? (long long)(w & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    exclusive += v;
    if (prefixes) return exclusive;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const Lanes lanes, const uint8_t* __restrict__ keep,
               long long n, unsigned* __restrict__ tile_counter,
               unsigned long long* __restrict__ status,
               int* __restrict__ n_sel) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ int warp_total[kWarps];
  __shared__ unsigned s_tile;
  __shared__ long long s_offset;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kTile;

  // 1. Flags and ranks inside the tile.
  const unsigned mask = flag_mask<kVec>(keep, base + kPer * threadIdx.x, n);
  const int count = __popc(mask);
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_total[w];
    before += w < warp ? t : 0;
    total += t;
  }
  // 2. The tile's aggregate (tile 0's is its inclusive prefix).
  if (threadIdx.x == 0) {
    store_release(status + tile, (tile == 0 ? kPrefix : kAggregate) | total);
  }
  const unsigned owner = ((unsigned)(before + incl - count) << 16) | mask;

  // 3. Every lane's kept elements into shared memory, in order.
#pragma unroll
  for (int b = 0; b < kMaxLanes; ++b) {  // constant indices: no stack
    if (b >= lanes.n) break;
    if (lanes.width[b] == 8) {
      stage_lane<uint64_t, kVec>((const uint64_t*)lanes.src[b],
                                 (uint64_t*)(stage + lanes.smem[b]), base, n,
                                 owner, lane, warp);
    } else {
      stage_lane<uint32_t, kVec>((const uint32_t*)lanes.src[b],
                                 (uint32_t*)(stage + lanes.smem[b]), base, n,
                                 owner, lane, warp);
    }
  }

  // 4. Look-back, then the inclusive prefix.
  if (warp == 0) {
    const long long exclusive = tile > 0 ? look_back(status, tile, lane) : 0;
    if (lane == 0) {
      store_release(status + tile, kPrefix | (exclusive + total));
      if (base + kTile >= n) *n_sel = (int)(exclusive + total);
      s_offset = exclusive;
    }
  }
  __syncthreads();

  // 5. The tile's compacted runs to their global offset.
  const long long offset = s_offset;
#pragma unroll
  for (int b = 0; b < kMaxLanes; ++b) {
    if (b >= lanes.n) break;
    if (lanes.width[b] == 8) {
      store_lane<uint64_t>((uint64_t*)lanes.dst[b],
                           (const uint64_t*)(stage + lanes.smem[b]), total,
                           offset);
    } else {
      store_lane<uint32_t>((uint32_t*)lanes.dst[b],
                           (const uint32_t*)(stage + lanes.smem[b]), total,
                           offset);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool kVec>
int launch(const Lanes& lanes, const uint8_t* keep, long long n,
           long long tiles, unsigned long long* scratch, int* n_sel,
           int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      compact_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  compact_kernel<kVec><<<(unsigned)tiles, kThreads, smem, stream>>>(
      lanes, keep, n, reinterpret_cast<unsigned*>(scratch), scratch + 1,
      n_sel);
  return (int)cudaGetLastError();
}

}  // namespace

// Lane b (b < n_lanes) copies from src_b to dst_b, width_b bytes (4 or 8)
// per element; unused lanes pass null pointers.  `scratch` holds
// scratch_words 8-byte words, at least 1 + ceil(n / 4096): the tile counter,
// then one status word per tile; it is cleared here.  n_sel is one int32 on
// the device.
extern "C" int kmerset_compact(const void* src0, const void* src1,
                               const void* src2, void* dst0, void* dst1,
                               void* dst2, int width0, int width1, int width2,
                               int n_lanes, const void* keep, long long n,
                               void* scratch, long long scratch_words,
                               void* n_sel, void* stream) {
  if (n <= 0) return 0;
  if (n_lanes < 1 || n_lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (scratch_words < 1 + tiles) return (int)cudaErrorInvalidValue;
  Lanes lanes = {{src0, src1, src2}, {dst0, dst1, dst2},
                 {width0, width1, width2}, {0, 0, 0}, n_lanes};
  bool vec = aligned16(keep);
  int smem = 0;
  for (int b = 0; b < n_lanes; ++b) {
    if (lanes.width[b] != 4 && lanes.width[b] != 8)
      return (int)cudaErrorInvalidValue;
    lanes.smem[b] = smem;
    smem += kTile * lanes.width[b];
    vec = vec && aligned16(lanes.src[b]);
  }
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * (1 + tiles), s);
  if (err != cudaSuccess) return (int)err;
  auto* words = (unsigned long long*)scratch;
  auto* keep8 = (const uint8_t*)keep;
  return vec ? launch<true>(lanes, keep8, n, tiles, words, (int*)n_sel, smem, s)
             : launch<false>(lanes, keep8, n, tiles, words, (int*)n_sel, smem,
                             s);
}
