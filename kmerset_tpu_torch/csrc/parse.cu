// P1: FASTA text -> the count's 2-bit codes and fragment ends, on Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: it takes over the host's FASTA parse and
// 2-bit pack (native/kmerio.c kmerio_parse_fasta and kmerio_pack2, behind
// core/native.parse_fasta_bytes and native.pack2), which are serial loops
// over every byte.  Its rules are the C parser's: lines alternate between
// a header and a sequence; a line of even index that is empty or does not
// start with '>' is an error; a byte of a sequence line other than
// A/C/G/T/N is an error; an odd number of lines is an error; a last line
// without a newline still counts, and a file that ends in "\n\n" ends in an
// empty line.  A fragment is cut at every N and at every line end.
//
// Two kernels.
//
// parse: one pass with decoupled look-back (Merrill and Garland, as B3 in
// csrc/compact.cu).  Each block takes the next tile of kTile = 16384 bytes
// from an atomic counter and
//   1. loads its 64 bytes per thread with four 16-byte loads, and the byte
//      before and after them (the halo: a line start, a fragment end);
//   2. scans the threads' newline counts, so that every byte knows the
//      parity of its line relative to the tile's start;
//   3. counts, per thread and for each relative parity, the ACGT bytes and
//      the fragment ends (an ACGT byte whose next byte is not one), and
//      records the errors each start parity would make; one 64-bit shuffle
//      scan of the four counts, 16 bits each, ranks them in the tile;
//   4. publishes the tile's aggregate: its newline parity and the four
//      counts, 15 bits each, in one status word;
//   5. looks back (warp 0) over the tiles before it, folding their
//      aggregates in order until it meets an inclusive prefix: the tile's
//      start parity, codes and ends before it.  Which bytes are codes
//      follows from the parity, so an aggregate carries both parities'
//      counts and the fold picks one by the parity of what lies before;
//   6. publishes its inclusive prefix (the codes and ends in two arrays,
//      then the parity and the flag by one release store), stages its codes
//      in shared memory at their rank and writes them to their offset as
//      one contiguous range with 16-byte stores, and writes its fragment
//      ends (code positions, offsets[1:]) to the ends array after a 0.
// A tile that finds an error for its start parity sets info[2]; the last
// tile writes info[0] (codes), info[1] (fragment ends) and info[3] (the
// parity of the number of lines), which the wrapper reads in one download.
//
// pack: codes -> 4 a byte, first code in the low bits (kmerio_pack2's
// layout); each thread reads 16 codes (one 16-byte load where the codes
// are aligned, else byte loads: a chunk's slice of the stream starts
// anywhere) and writes one 32-bit word.
//
// What bounds them: memory.  parse reads each byte once and writes each
// code once (and 8 B a fragment end); the status words and prefixes add
// 24 B per 16384 bytes.  pack reads each code once and writes a quarter
// byte.  A tile's steps wait on one another (its loads, three barriers,
// the look-back's loads from L2), so a tile's fixed latency is paid per
// tile: 64 bytes a thread keep the tiles few (95K at 1.56 GB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 64;                // bytes per thread
constexpr int kTile = kThreads * kPer;  // bytes per tile

constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr int kParityBit = 61;
constexpr int kField = 15;  // bits of a count in an aggregate (<= 16384)
constexpr unsigned long long kFieldMask = (1ull << kField) - 1;

constexpr uint8_t kNewline = '\n';
constexpr uint8_t kSep = 4;  // N
constexpr uint8_t kBad = 5;  // any other byte of a sequence line

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

__device__ __forceinline__ long long load_relaxed(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.global.s64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// 0..3 for A, C, G, T; kSep for N; kBad for any other byte.
__device__ __forceinline__ uint8_t base_code(uint8_t b) {
  switch (b) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    case 'N': return kSep;
    default: return kBad;
  }
}

__device__ __forceinline__ bool is_acgt(uint8_t b) {
  return b == 'A' || b == 'C' || b == 'G' || b == 'T';
}

// Where a tile starts: the parity of the newlines before it, and the
// codes and fragment ends before it.
struct Start {
  int parity;
  long long codes, ends;
};

// Count f of an aggregate word: 0, 1 the ACGT bytes at relative parity 0,
// 1; 2, 3 the fragment ends at relative parity 0, 1.
__device__ __forceinline__ long long field(unsigned long long w, int f) {
  return (long long)((w >> (kField * f)) & kFieldMask);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
parse_kernel(const uint8_t* __restrict__ buf, long long n,
             uint8_t* __restrict__ codes, long long* __restrict__ ends,
             unsigned* __restrict__ tile_counter,
             unsigned long long* __restrict__ status,
             long long* __restrict__ prefix_codes,
             long long* __restrict__ prefix_ends,
             long long* __restrict__ info) {
  __shared__ __align__(16) uint8_t stage[kTile];
  __shared__ int warp_nl[kWarps];
  __shared__ unsigned long long warp_sums[kWarps];
  __shared__ unsigned s_tile;
  __shared__ int s_parity;
  __shared__ long long s_codes, s_ends;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long tile_base = tile * kTile;
  const long long base = tile_base + (long long)kPer * threadIdx.x;

  // 1. The thread's bytes, 4 a word (byte j of the thread is B(j)), and its
  // halo; bytes past n are never read and hold newlines.
  uint32_t words[kPer / 4];
  const int m = base >= n ? 0 : (n - base < kPer ? (int)(n - base) : kPer);
  if (kVec && m == kPer) {
#pragma unroll
    for (int v = 0; v < kPer / 16; ++v) {
      const uint4 x = *reinterpret_cast<const uint4*>(buf + base + 16 * v);
      words[4 * v] = x.x, words[4 * v + 1] = x.y;
      words[4 * v + 2] = x.z, words[4 * v + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < kPer / 4; ++v) {
      uint32_t x = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = 4 * v + j;
        x |= (uint32_t)(at < m ? buf[base + at] : kNewline) << (8 * j);
      }
      words[v] = x;
    }
  }
#define B(j) ((uint8_t)(words[(j) / 4] >> (8 * ((j) % 4))))
  const uint8_t before = (m > 0 && base > 0) ? buf[base - 1] : kNewline;
  const uint8_t after = base + kPer < n ? buf[base + kPer] : kNewline;

  // 2. Newlines: each byte's line parity relative to the tile's start.
  int nl = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) nl += (j < m && B(j) == kNewline);
  int incl = nl;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_nl[warp] = incl;
  __syncthreads();
  int nl_before = incl - nl, nl_total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    nl_before += w < warp ? warp_nl[w] : 0;
    nl_total += warp_nl[w];
  }
  const int q = nl_total & 1;

  // 3. Codes and ends by relative parity (fields 0, 1: codes at r = 0, 1;
  // 2, 3: ends), and the errors by start parity (bit P: a tile that starts
  // at line parity P is malformed).  A byte at relative parity r lies on a
  // line of parity P ^ r: a sequence line where that is 1.
  unsigned long long mine = 0;
  unsigned bad = 0;
  {
    int r = nl_before & 1;
    uint8_t prev = before;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j < m) {
        const uint8_t c = B(j);
        if (prev == kNewline && c != '>') bad |= 1u << r;  // header at P == r
        if (c == kNewline) {
          r ^= 1;
        } else {
          const uint8_t code = base_code(c);
          if (code == kBad) bad |= 1u << (r ^ 1);  // sequence at P == r ^ 1
          if (code < 4) {
            mine += 1ull << (16 * r);
            // A byte past n reads as a newline: the file's end cuts too.
            if (!is_acgt(j + 1 < kPer ? B(j + 1) : after))
              mine += 1ull << (16 * (2 + r));
          }
        }
        prev = c;
      }
    }
  }
  unsigned long long sums = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long t = __shfl_up_sync(0xffffffffu, sums, o);
    if (lane >= o) sums += t;
  }
  if (lane == 31) warp_sums[warp] = sums;
  const int bad0 = __syncthreads_or(bad & 1u);
  const int bad1 = __syncthreads_or(bad & 2u);
  unsigned long long rank = sums - mine, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    rank += w < warp ? warp_sums[w] : 0;
    total += warp_sums[w];
  }
  long long t_cnt[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) t_cnt[f] = (long long)((total >> (16 * f)) & 0xffff);

  // 4-5. The aggregate, the look-back, the inclusive prefix.
  if (warp == 0) {
    Start start = {0, 0, 0};
    if (tile == 0) {
      // Tile 0 starts the file: parity 0, nothing before it.
    } else {
      if (lane == 0) {
        store_release(status + tile,
                      kAggregate | (unsigned long long)q << kParityBit |
                          (unsigned long long)t_cnt[0] |
                          (unsigned long long)t_cnt[1] << kField |
                          (unsigned long long)t_cnt[2] << (2 * kField) |
                          (unsigned long long)t_cnt[3] << (3 * kField));
      }
      // acc: what the tiles after the window's oldest read add, relative to
      // their start (parity, codes and ends at relative parity 0 and 1).
      int acc_q = 0;
      long long acc[4] = {0, 0, 0, 0};
      for (long long last = tile - 1;; last -= 32) {
        const long long i = last - lane;
        unsigned long long w = kPrefix;  // before tile 0: a prefix of 0
        long long pc = 0, pe = 0;
        if (i >= 0) {
          do {
            w = load_acquire(status + i);
          } while ((w >> 62) == 0);
          if ((w >> 62) == 2) {
            pc = load_relaxed(prefix_codes + i);
            pe = load_relaxed(prefix_ends + i);
          }
        }
        const unsigned prefixes = __ballot_sync(0xffffffffu, (w >> 62) == 2);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 32;
        // Fold the aggregates of lanes 0 .. stop-1 (newest first) in front
        // of acc: a tile with parity qa in front shifts acc's parities.
        for (int j = 0; j < stop; ++j) {
          const unsigned long long a = __shfl_sync(0xffffffffu, w, j);
          const int qa = (int)((a >> kParityBit) & 1);
          long long nxt[4];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            nxt[x] = field(a, x) + acc[x ^ qa];
            nxt[2 + x] = field(a, 2 + x) + acc[2 + (x ^ qa)];
          }
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[f] = nxt[f];
          acc_q ^= qa;
        }
        if (prefixes) {
          const unsigned long long p = __shfl_sync(0xffffffffu, w, stop);
          const long long c = __shfl_sync(0xffffffffu, pc, stop);
          const long long e = __shfl_sync(0xffffffffu, pe, stop);
          const int pp = (int)((p >> kParityBit) & 1);
          start.parity = pp ^ acc_q;
          start.codes = c + acc[pp ^ 1];
          start.ends = e + acc[2 + (pp ^ 1)];
          break;
        }
      }
    }
    if (lane == 0) {
      const int P = start.parity;
      const long long c = start.codes + t_cnt[P ^ 1];
      const long long e = start.ends + t_cnt[2 + (P ^ 1)];
      prefix_codes[tile] = c;
      prefix_ends[tile] = e;
      store_release(status + tile,
                    kPrefix | (unsigned long long)(P ^ q) << kParityBit);
      if (tile_base + kTile >= n) {
        info[0] = c;
        info[1] = e;
        // The lines: the newlines, and one more where the last byte is no
        // newline.
        info[3] = (P ^ q) ^ (buf[n - 1] != kNewline ? 1 : 0);
      }
      if (tile == 0) ends[0] = 0;
      s_parity = P;
      s_codes = start.codes;
      s_ends = start.ends;
    }
  }
  __syncthreads();
  const int P = s_parity;
  if (threadIdx.x == 0 && ((P == 0 && bad0) || (P == 1 && bad1))) info[2] = 1;

  // 6. The codes into shared memory at their rank, the ends to global.
  {
    const int want = P ^ 1;  // the relative parity of the sequence lines
    int at = (int)((rank >> (16 * want)) & 0xffff);
    long long e_at = s_ends + (long long)((rank >> (16 * (2 + want))) & 0xffff);
    int r = nl_before & 1;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j < m) {
        const uint8_t c = B(j);
        if (c == kNewline) {
          r ^= 1;
        } else if (r == want) {
          const uint8_t code = base_code(c);
          if (code < 4) {
            stage[at++] = code;
            if (!is_acgt(j + 1 < kPer ? B(j + 1) : after))
              ends[1 + e_at++] = s_codes + at;
          }
        }
      }
    }
  }
  __syncthreads();
  const int count = (int)t_cnt[P ^ 1];
  uint8_t* out = codes + s_codes;
  const int lead = (int)((16 - ((uintptr_t)out & 15)) & 15);
  const int head = lead < count ? lead : count;
  const int n_vec = (count - head) / 16;
  for (int r = threadIdx.x; r < head; r += kThreads) out[r] = stage[r];
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const int r = head + 16 * v;
    uint32_t w[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      w[x] = (uint32_t)stage[r + 4 * x] | (uint32_t)stage[r + 4 * x + 1] << 8 |
             (uint32_t)stage[r + 4 * x + 2] << 16 |
             (uint32_t)stage[r + 4 * x + 3] << 24;
    }
    *reinterpret_cast<uint4*>(out + r) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int r = head + 16 * n_vec + threadIdx.x; r < count; r += kThreads) {
    out[r] = stage[r];
  }
#undef B
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint8_t* __restrict__ codes, long long L,
            uint8_t* __restrict__ out) {
  const long long words = (L + 15) / 16;
  for (long long w = blockIdx.x * (long long)kThreads + threadIdx.x; w < words;
       w += (long long)gridDim.x * kThreads) {
    const long long i = 16 * w;
    uint32_t word = 0;
    if (kVec && i + 16 <= L) {
      const uint4 v = *reinterpret_cast<const uint4*>(codes + i);
      const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        word |= ((x[j / 4] >> (8 * (j % 4))) & 3u) << (2 * j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (i + j < L) word |= (uint32_t)(codes[i + j] & 3) << (2 * j);
      }
    }
    if (i + 16 <= L) {
      *reinterpret_cast<uint32_t*>(out + 4 * w) = word;
    } else {
      const long long bytes = (L - i + 3) / 4;
      for (long long j = 0; j < bytes; ++j) out[4 * w + j] = (uint8_t)(word >> (8 * j));
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// buf: n bytes of FASTA text.  codes: room for n bytes.  ends: room for
// 1 + (n + 1) / 2 int64 (ends[0] = 0, then each fragment's end).
// scratch: 1 + 3 * tiles 8-byte words, tiles = ceil(n / 16384) (the tile
// counter, the status words, the prefixes' codes and ends); info: 4 int64
// (codes, fragment ends, malformed, the lines' parity).  Both are cleared
// here.
extern "C" int kmerset_parse_fasta(const void* buf, long long n, void* codes,
                                   void* ends, void* scratch,
                                   long long scratch_words, void* info,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(info, 0, 4 * sizeof(long long), s);
  if (err != cudaSuccess || n <= 0) return (int)err;
  const long long tiles = (n + kTile - 1) / kTile;
  if (scratch_words < 1 + 3 * tiles) return (int)cudaErrorInvalidValue;
  err = cudaMemsetAsync(scratch, 0, 8 * (1 + tiles), s);
  if (err != cudaSuccess) return (int)err;
  auto* words = (unsigned long long*)scratch;
  auto* prefixes = (long long*)scratch + 1 + tiles;
  const auto* in = (const uint8_t*)buf;
  if (aligned16(buf)) {
    parse_kernel<true><<<(unsigned)tiles, kThreads, 0, s>>>(
        in, n, (uint8_t*)codes, (long long*)ends, (unsigned*)words, words + 1,
        prefixes, prefixes + tiles, (long long*)info);
  } else {
    parse_kernel<false><<<(unsigned)tiles, kThreads, 0, s>>>(
        in, n, (uint8_t*)codes, (long long*)ends, (unsigned*)words, words + 1,
        prefixes, prefixes + tiles, (long long*)info);
  }
  return (int)cudaGetLastError();
}

// codes: L codes (0..3), any alignment; out: ceil(L / 4) bytes, 4-byte
// aligned.
extern "C" int kmerset_pack_codes(const void* codes, long long L, void* out,
                                  void* stream) {
  if (L <= 0) return 0;
  const long long words = (L + 15) / 16;
  long long blocks = (words + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  const cudaStream_t s = (cudaStream_t)stream;
  if (aligned16(codes)) {
    pack_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)codes, L, (uint8_t*)out);
  } else {
    pack_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)codes, L, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
