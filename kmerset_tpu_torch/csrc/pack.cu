// B1 and B2: fused window pack + canonical min, on Hopper (sm_90a).
//
// B1 (k <= 15) replaces kmerset_tpu/ops/pallas_pack.py:_kernel (called
// through _call and canonical_windows_pallas from ops/count.py:
// _single_windows); B2 (15 < k <= 23) replaces pallas_pack.py:_pair_kernel
// (through _pair_call and canonical_windows_pair_pallas from
// ops/count.py:_pair_windows).  Both are one template on the key type.
// For every window start p < L - k + 1 it writes
//     fwd = codes[p] .. codes[p+k-1], 2 bits per base, first base highest
//     rc  = 3-codes[p+k-1] .. 3-codes[p], the reverse complement, same order
//     out = min(fwd, rc)   (or fwd alone when canonical == 0)
// B1 writes an int32 of 2k <= 30 bits.  B2 writes one int64 of 2k <= 46
// bits where the TPU kernel wrote (hi, lo) int32 lanes: the key is
// (hi << 2*klo) | lo, the reference's own combination (ops/count.py:
// canonical_windows), and its integer order is the lanes' lexicographic
// order, so the TPU kernel's (hi, lo) strand compare is the plain min here
// and one int64 sort replaces the two-key sort.  Two steps of the
// reference pipeline are fused in: the codes are read in their 2-bit
// packed upload form (four bases per byte, low bits first:
// ops/count.py:_unpack2), and a window whose `valid` byte is 0 gets the
// sort sentinel: 2^31-1 for B1 (ops/count.py _S_SENT), 2^62 for B2
// (ops/count.py SENTINEL, in place of the hi lane's _HI_SENT).
//
// What bounds it: memory.  Per window it reads 0.25 B of packed codes and
// 1 B of validity and writes 4 B (B1) or 8 B (B2) of key; the k-step
// shift loop is a few dozen integer operations, far below the card's rate
// for that traffic.  The TPU kernels spent their effort on log-doubling
// over a 2^17-window VMEM tile because its vector unit has no cheap
// per-lane loop; here each thread owns one window, and a block stages its
// 256 windows' codes plus the k-1 halo in shared memory once, so every
// packed byte is read from device memory once per block (plus an 8-byte
// halo) instead of k times.  Shifts are on unsigned keys: a signed right
// shift would be arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // windows per block
constexpr int kHaloCodes = 32;                 // >= k - 1 = 22, a multiple of 4
constexpr int kTileCodes = kThreads + kHaloCodes;
constexpr int kTileBytes = kTileCodes / 4;

template <typename Key>
__global__ void pack_canonical_kernel(const uint8_t* __restrict__ packed,
                                      long long L, int k, int canonical,
                                      const uint8_t* __restrict__ valid,
                                      Key sentinel, Key* __restrict__ out,
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
  Key fwd = 0, rc = 0;
  const uint8_t* w = codes + threadIdx.x;
  for (int j = 0; j < k; ++j) {
    const Key c = w[j];
    fwd = (fwd << 2) | c;
    rc |= (Key(3) - c) << (2 * j);
  }
  Key key = canonical ? (rc < fwd ? rc : fwd) : fwd;
  if (valid != nullptr && valid[p] == 0) key = sentinel;
  out[p] = key;
}

template <typename Key>
int launch(const void* packed, long long L, int k, int canonical,
           const void* valid, Key sentinel, void* out, long long n_out,
           void* stream) {
  if (n_out <= 0) return 0;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  pack_canonical_kernel<Key><<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)packed, L, k, canonical, (const uint8_t*)valid,
      sentinel, (Key*)out, n_out);
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

// B2: int64 keys, k <= 23 (the wrapper sends only 15 < k here).
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
