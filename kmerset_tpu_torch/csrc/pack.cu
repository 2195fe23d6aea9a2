// B1: fused window pack + canonical min for k <= 15, on Hopper (sm_90a).
//
// Replaces kmerset_tpu/ops/pallas_pack.py:_kernel (called through _call and
// canonical_windows_pallas from ops/count.py:_single_windows).  For every
// window start p < L - k + 1 it writes
//     fwd = codes[p] .. codes[p+k-1], 2 bits per base, first base highest
//     rc  = 3-codes[p+k-1] .. 3-codes[p], the reverse complement, same order
//     out = min(fwd, rc)   (or fwd alone when canonical == 0)
// as an int32 of 2k <= 30 bits.  Two steps of the reference pipeline are
// fused in: the codes are read in their 2-bit packed upload form (four
// bases per byte, low bits first: ops/count.py:_unpack2), and a window whose
// `valid` byte is 0 gets the sort sentinel 2^31-1 (ops/count.py:257).
//
// What bounds it: memory.  Per window it reads 0.25 B of packed codes and
// 1 B of validity and writes 4 B of key; the k-step shift loop is a few
// dozen integer operations, far below the card's rate for that traffic.
// The TPU kernel spent its effort on log-doubling over a 2^17-window VMEM
// tile because its vector unit has no cheap per-lane loop; here each thread
// owns one window, and a block stages its 256 windows' codes plus the
// k-1 halo in shared memory once, so every packed byte is read from device
// memory once per block (plus a 4-byte halo) instead of k times.
// Shifts are on uint32: a signed right shift would be arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // windows per block
constexpr int kHaloCodes = 32;                 // >= k - 1, a multiple of 4
constexpr int kTileCodes = kThreads + kHaloCodes;
constexpr int kTileBytes = kTileCodes / 4;
constexpr uint32_t kSentinel = 0x7fffffffu;    // ops/count.py _S_SENT

__global__ void pack_canonical_kernel(const uint8_t* __restrict__ packed,
                                      long long L, int k, int canonical,
                                      const uint8_t* __restrict__ valid,
                                      int32_t* __restrict__ out,
                                      long long n_out) {
  __shared__ uint8_t codes[kTileCodes];
  const long long b0 = (long long)blockIdx.x * kThreads;  // multiple of 4
  const long long n_bytes = (L + 3) >> 2;
  if (threadIdx.x < kTileBytes) {
    const long long bi = (b0 >> 2) + threadIdx.x;
    const uint8_t v = bi < n_bytes ? packed[bi] : 0;
    uint8_t* c = codes + 4 * threadIdx.x;
    c[0] = v & 3;
    c[1] = (v >> 2) & 3;
    c[2] = (v >> 4) & 3;
    c[3] = (v >> 6) & 3;
  }
  __syncthreads();
  const long long p = b0 + threadIdx.x;
  if (p >= n_out) return;
  uint32_t fwd = 0, rc = 0;
  const uint8_t* w = codes + threadIdx.x;
  for (int j = 0; j < k; ++j) {
    const uint32_t c = w[j];
    fwd = (fwd << 2) | c;
    rc |= (3u - c) << (2 * j);
  }
  uint32_t key = canonical ? (rc < fwd ? rc : fwd) : fwd;
  if (valid != nullptr && valid[p] == 0) key = kSentinel;
  out[p] = (int32_t)key;
}

}  // namespace

extern "C" int kmerset_pack_canonical(const void* packed, long long L, int k,
                                      int canonical, const void* valid,
                                      void* out, long long n_out,
                                      void* stream) {
  if (n_out <= 0) return 0;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  pack_canonical_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)packed, L, k, canonical, (const uint8_t*)valid,
      (int32_t*)out, n_out);
  return (int)cudaGetLastError();
}

extern "C" const char* kmerset_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
