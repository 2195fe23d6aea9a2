// B1 and B2: fused window pack + canonical min, on Hopper (sm_90a).
//
// B1 (k <= 15) replaces kmerset_tpu/ops/pallas_pack.py:34 (_kernel, called
// through _call and canonical_windows_pallas from ops/count.py:
// _single_windows); B2 (15 < k <= 31) replaces pallas_pack.py:85
// (_pair_kernel, through _pair_call and canonical_windows_pair_pallas from
// ops/count.py:_pair_windows) for k <= 23, and the reference's XLA
// ops/count.py:_int64_windows above.  Both are one template on the key
// type.
// For every window start p < L - k + 1 it writes
//     fwd = codes[p] .. codes[p+k-1], 2 bits per base, first base highest
//     rc  = 3-codes[p+k-1] .. 3-codes[p], the reverse complement, same order
//     out = min(fwd, rc)   (or fwd alone when canonical == 0)
// B1 writes an int32 of 2k <= 30 bits.  B2 writes one int64 of 2k <= 62
// bits, below its sentinel 2^62.  Up to k = 23 the TPU kernel wrote (hi,
// lo) int32 lanes instead: the key is (hi << 2*klo) | lo, the reference's
// own combination (ops/count.py:canonical_windows), and its integer order
// is the lanes' lexicographic order, so the TPU kernel's (hi, lo) strand
// compare is the plain min here and one int64 sort replaces the two-key
// sort.  Two steps of the
// reference pipeline are fused in: the codes are read in their 2-bit
// packed upload form (four bases per byte, low bits first:
// ops/count.py:_unpack2), and a window whose `valid` byte is 0 gets the
// sort sentinel: 2^31-1 for B1 (ops/count.py _S_SENT), 2^62 for B2
// (ops/count.py SENTINEL, in place of the hi lane's _HI_SENT).
//
// What bounds it: memory.  Per window it reads 0.25 B of packed codes and
// 1 B of validity and writes 4 B (B1) or 8 B (B2) of key: 5.25 or 9.25 B,
// so 2^24 windows take at least 0.0263 or 0.0463 ms at 3.35 TB/s.  The
// arithmetic is a dozen integer operations per window, independent of k.
//
// The design, against what held the first version (one thread per window,
// 256-window blocks, a k-step loop over shared-memory bytes, 1-byte valid
// loads and 4-byte stores) at ~21% of that bound:
// - O(1) work per window.  The packed codes are low bits first, so the
//   span x = (bits >> 2p) & mask(2k) of window p holds codes[p] in its
//   lowest pair.  The reverse complement is ~x & mask(2k); the forward key
//   is x's 2-bit pairs in reverse order: __brev, a swap of the two bits of
//   every pair, and a shift right by (word bits - 2k).  A window's span
//   starts at bit 2*(p mod 16) <= 30 of one 32-bit word of 16 codes and
//   ends at most 30 + 62 = 92 <= 96 bits past that word's start at k = 31,
//   so two funnel shifts (amounts 2*(p mod 16) < 32) over three
//   consecutive words of the staged tile give x.  At k = 31, mask(62) =
//   2^62 - 1, the forward key's shift is 64 - 62 = 2, and every key and
//   its reverse complement stay below the sentinel 2^62.
// - Wide accesses.  A thread makes 16 B of keys per step (4 int32 keys or
//   2 int64 keys, consecutive windows) and writes them with one 16-byte
//   store; the 32 threads of a warp write 512 contiguous bytes.  Its valid
//   bytes come from shared memory as one 4- or 2-byte word.
// - More bytes in flight.  A block covers a tile of kTile = 4096 windows.
//   A persistent grid (as many blocks as fit on the SMs at once) walks the
//   tiles, and each block stages its next tile's packed bytes and valid
//   bytes into shared memory with 16-byte cp.async copies, double
//   buffered, while it computes and stores the current one.
// - Edges.  Copies past the end of `packed` or `valid` are zero-filled
//   (cp.async's source size), so a ragged last tile, n below one tile and
//   packed lengths that are not a multiple of 16 need no special path; the
//   16-byte halo past each tile's packed bytes (64 codes) holds the k - 1
//   <= 30 codes that cross into the next tile.  The last group of a ragged
//   tile is stored key by key.  The wrapper (ops/pack.py) requires `packed`, `valid` and
//   `out` 16-byte aligned.
// Tensor cores play no part: this is bit arithmetic on a memory-bound
// stream.  Shifts are on unsigned keys: a signed right shift would be
// arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;                    // windows per tile
constexpr int kHaloBytes = 16;                 // >= 8 B read past the tile
constexpr int kPackedBytes = kTile / 4 + kHaloBytes;
constexpr int kPackedChunks = kPackedBytes / 16;
constexpr int kValidChunks = kTile / 16;

__device__ __forceinline__ void cp_async16(void* smem, const uint8_t* gmem,
                                           long long avail) {
  // Copies min(avail, 16) bytes and zero-fills the rest of the 16; with
  // nothing available, reads nothing (the source is then never touched).
  const int src = avail >= 16 ? 16 : (avail > 0 ? (int)avail : 0);
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct __align__(16) Stage {
  uint8_t packed[kPackedBytes];
  uint8_t valid[kTile];
};

__device__ __forceinline__ void stage_tile(Stage& s, long long tile,
                                           const uint8_t* __restrict__ packed,
                                           long long n_bytes,
                                           const uint8_t* __restrict__ valid,
                                           long long n) {
  const long long b0 = tile * (kTile / 4);
  const long long v0 = tile * kTile;
  for (int c = threadIdx.x; c < kPackedChunks; c += kThreads) {
    const long long off = b0 + 16LL * c;
    cp_async16(s.packed + 16 * c, off < n_bytes ? packed + off : packed,
               n_bytes - off);
  }
  if (valid != nullptr) {
    for (int c = threadIdx.x; c < kValidChunks; c += kThreads) {
      const long long off = v0 + 16LL * c;
      cp_async16(s.valid + 16 * c, off < n ? valid + off : valid, n - off);
    }
  }
}

// Window keys of the span word x (codes[p] in its lowest pair).
__device__ __forceinline__ uint32_t fwd_key(uint32_t x, int k) {
  uint32_t y = __brev(x);
  y = ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
  return y >> (32 - 2 * k);
}

__device__ __forceinline__ uint64_t fwd_key(uint64_t x, int k) {
  uint64_t y = __brevll(x);
  y = ((y >> 1) & 0x5555555555555555ull) | ((y & 0x5555555555555555ull) << 1);
  return y >> (64 - 2 * k);
}

template <typename Key>
__device__ __forceinline__ Key span(uint32_t w0, uint32_t w1, uint32_t w2,
                                    int sh);

template <>
__device__ __forceinline__ uint32_t span<uint32_t>(uint32_t w0, uint32_t w1,
                                                   uint32_t, int sh) {
  return __funnelshift_r(w0, w1, sh);  // 2k <= 30 bits: the low word holds x
}

template <>
__device__ __forceinline__ uint64_t span<uint64_t>(uint32_t w0, uint32_t w1,
                                                   uint32_t w2, int sh) {
  return ((uint64_t)__funnelshift_r(w1, w2, sh) << 32) |
         __funnelshift_r(w0, w1, sh);
}

__device__ __forceinline__ void store16(uint32_t* dst, const uint32_t* keys) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(keys[0], keys[1], keys[2], keys[3]);
}

__device__ __forceinline__ void store16(uint64_t* dst, const uint64_t* keys) {
  *reinterpret_cast<ulonglong2*>(dst) = make_ulonglong2(keys[0], keys[1]);
}

template <typename Key>
__global__ void __launch_bounds__(kThreads)
pack_canonical_kernel(const uint8_t* __restrict__ packed, long long L, int k,
                      int canonical, const uint8_t* __restrict__ valid,
                      Key sentinel, Key* __restrict__ out, long long n) {
  constexpr int kPer = 16 / sizeof(Key);       // keys per 16-byte store
  constexpr int kSteps = kTile / (kThreads * kPer);
  __shared__ Stage stage[2];
  const long long n_bytes = (L + 3) >> 2;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const Key mask = (Key(1) << (2 * k)) - 1;

  long long tile = blockIdx.x;
  int buf = 0;
  if (tile < n_tiles) stage_tile(stage[0], tile, packed, n_bytes, valid, n);
  cp_async_commit();
  for (; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      stage_tile(stage[buf ^ 1], next, packed, n_bytes, valid, n);
    cp_async_commit();
    cp_async_wait_prior1();  // this tile's copies (all but the newest group)
    __syncthreads();
    const Stage& s = stage[buf];
    const uint32_t* words = reinterpret_cast<const uint32_t*>(s.packed);
    const long long base = tile * kTile;
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const int q = (step * kThreads + threadIdx.x) * kPer;  // local window
      const long long p = base + q;
      if (p >= n) break;
      const int w = q >> 4;
      const uint32_t w0 = words[w], w1 = words[w + 1], w2 = words[w + 2];
      uint32_t vbits = 0xffffffffu;
      if (valid != nullptr) {
        vbits = kPer == 4
                    ? *reinterpret_cast<const uint32_t*>(s.valid + q)
                    : *reinterpret_cast<const uint16_t*>(s.valid + q);
      }
      Key keys[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const Key x = span<Key>(w0, w1, w2, 2 * ((q & 15) + j)) & mask;
        const Key fwd = fwd_key(x, k);
        const Key rc = ~x & mask;
        Key key = canonical && rc < fwd ? rc : fwd;
        if (((vbits >> (8 * j)) & 0xffu) == 0) key = sentinel;
        keys[j] = key;
      }
      if (p + kPer <= n) {
        store16(out + p, keys);
      } else {
        for (int j = 0; j < kPer && p + j < n; ++j) out[p + j] = keys[j];
      }
    }
    __syncthreads();  // the next iteration stages into this buffer
  }
}

template <typename Key>
int launch(const void* packed, long long L, int k, int canonical,
           const void* valid, Key sentinel, void* out, long long n,
           void* stream) {
  if (n <= 0) return 0;
  static int grid_max = 0;
  if (grid_max == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pack_canonical_kernel<Key>, kThreads, 0);
    grid_max = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long n_tiles = (n + kTile - 1) / kTile;
  const int grid = (int)(n_tiles < grid_max ? n_tiles : grid_max);
  pack_canonical_kernel<Key><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, L, k, canonical, (const uint8_t*)valid,
      sentinel, (Key*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// B1: int32 keys, k <= 15.
extern "C" int kmerset_pack_canonical(const void* packed, long long L, int k,
                                      int canonical, const void* valid,
                                      void* out, long long n_out,
                                      void* stream) {
  return launch<uint32_t>(packed, L, k, canonical, valid, 0x7fffffffu, out,
                          n_out, stream);
}

// B2: int64 keys, k <= 31 (the wrapper sends only 15 < k here).
extern "C" int kmerset_pack_canonical64(const void* packed, long long L,
                                        int k, int canonical,
                                        const void* valid, void* out,
                                        long long n_out, void* stream) {
  return launch<uint64_t>(packed, L, k, canonical, valid, 1ull << 62, out,
                          n_out, stream);
}

extern "C" const char* kmerset_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
