// J1: the canonical path cover's candidate overlap edges, on Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It replaces the host's edge discovery of the
// canonical path cover (core/spss.py:_candidate_port_edges_canonical and
// _dedup_port_edges through core/native.overlap_edges and dedup_edges:
// native/kmerio.c kmerio_overlap_edges_fp / kmerio_overlap_edges_part, a
// hash multimap of the unitigs' first and last k-mers probed 16 times a
// unitig, then kmerio_dedup_edges, a hash pass that keeps each undirected
// edge's first occurrence).  The JAX package's counterpart is the mesh's
// XLA join (kmerset_tpu/parallel/), which this does not copy.
//
// Contract: the edges (pa, pb) that overlap_edges followed by the dedup
// give, element for element.  Ports: 2i is the right side of unitig i,
// 2i + 1 its left side.  P[i] and S[i] are the unitig's first and last
// k-mers.  Discovery order is pass-major: for c = 0..3, "next(S[i], c) ==
// P[j]" (A_c: ports 2i, 2j + 1) then "rc(next(S[i], c)) == S[j]" (B_c:
// 2i, 2j); then for c = 0..3, "prev(P[i], c) == S[j]" (C_c: 2i + 1, 2j)
// then "rc(prev(P[i], c)) == P[j]" (D_c: 2i + 1, 2j + 1).  Within a pass
// unitig-minor, within one probe ascending j, j == i skipped.
//
// The dedup needs no table.  Each edge {a, b} is found exactly twice, once
// from each end, and the mirror's pass is known from the probing unitig's
// own key: the mirror of A_c is C_c' (later: A is kept, C dropped); the
// mirror of B_c from i is B_c' from j with c' = 3 - (first base of S[i]);
// the mirror of D_c is D_c' with c' = 3 - (last base of P[i]).  So an edge
// of B or D is kept when c < c', dropped when c > c', and kept where c ==
// c' when j > i.  The kept matches of one probe are a contiguous run of the
// table sorted by (key, id): [lo, hi) for "all", the ids above i for "j >
// i".  Only the 12 passes A, B, D are probed.
//
// Two launches per set, over a grid of (unitig blocks, 12 passes):
//   1. overlap_count: each probe's kept matches, by binary search in the
//      stably sorted P or S (torch.sort beside it).  Between 1 and 2 the
//      wrapper scans the 12n counts in (pass, i) order (torch.cumsum) and
//      downloads the total.
//   2. overlap_fill: each probe searches again and writes its kept edges
//      at its offset, so the output comes in discovery order with no sort
//      of the hits, whatever the multiplicity.  Ports are int32 (n < 2^30),
//      a in [0, m) and b in [m, 2m) of one buffer, one download.
//
// What bounds it: launches and the latency of the dependent loads of the
// binary searches, not bytes.  At the assembly cell's shape (132,264
// unitigs, 235,252 kept edges) the inputs and outputs are about 15 MB,
// 5 us at 3.35 TB/s; the tables (2 MB) sit in L2, and 12 probes a unitig
// of two searches of 17 steps each run all at once, one thread a probe.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPasses = 12;  // A_c, B_c for c = 0..3, then D_c

__device__ __forceinline__ uint64_t rc_kmer(uint64_t x, int k) {
  x = ~x;
  x = ((x >> 1) & 0x5555555555555555ULL) | ((x & 0x5555555555555555ULL) << 1);
  return __brevll(x) >> (64 - 2 * k);
}

// First position in keys[lo, hi) whose key is not below q (upper: above q).
__device__ __forceinline__ long long bound(const int64_t* __restrict__ keys,
                                           long long lo, long long hi,
                                           int64_t q, bool upper) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const int64_t v = keys[mid];
    if (v < q || (upper && v == q))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The kept run [s, e) of probe (g, i) in its table, the ports it writes,
// and whether unitig i itself lies in the run (to be skipped).
struct Probe {
  const int64_t* ord;
  long long s, e;
  int32_t src, bit;
  bool self;
};

__device__ __forceinline__ Probe probe(int g, long long i,
                                       const int64_t* __restrict__ P,
                                       const int64_t* __restrict__ S,
                                       long long n, int k,
                                       const int64_t* __restrict__ p_keys,
                                       const int64_t* __restrict__ p_ord,
                                       const int64_t* __restrict__ s_keys,
                                       const int64_t* __restrict__ s_ord) {
  const uint64_t kmask = (1ULL << (2 * k)) - 1;
  const int top = 2 * (k - 1);
  Probe pr;
  int64_t q;
  int mode;  // 0: none kept, 1: all but i, 2: the ids above i
  bool in_p;
  if (g < 8) {
    const int c = g >> 1;
    const uint64_t nx = (((uint64_t)S[i] << 2) | (uint64_t)c) & kmask;
    pr.src = (int32_t)(2 * i);
    if (!(g & 1)) {  // A_c
      q = (int64_t)nx;
      in_p = true;
      pr.bit = 1;
      mode = 1;
    } else {  // B_c
      q = (int64_t)rc_kmer(nx, k);
      in_p = false;
      pr.bit = 0;
      const int cm = 3 - (int)(((uint64_t)S[i] >> top) & 3);
      mode = c < cm ? 1 : (c > cm ? 0 : 2);
    }
  } else {  // D_c
    const int c = g - 8;
    const uint64_t pv = ((uint64_t)P[i] >> 2) | ((uint64_t)c << top);
    q = (int64_t)rc_kmer(pv, k);
    in_p = true;
    pr.src = (int32_t)(2 * i + 1);
    pr.bit = 1;
    const int cm = 3 - (int)((uint64_t)P[i] & 3);
    mode = c < cm ? 1 : (c > cm ? 0 : 2);
  }
  const int64_t* keys = in_p ? p_keys : s_keys;
  pr.ord = in_p ? p_ord : s_ord;
  pr.s = pr.e = 0;
  pr.self = false;
  if (mode == 0) return pr;
  const long long lo = bound(keys, 0, n, q, false);
  pr.e = bound(keys, lo, n, q, true);
  pr.s = lo;
  if (mode == 1) {
    pr.self = (in_p ? P[i] : S[i]) == q;
  } else {  // ids ascend within the run: the first above i
    long long a = lo, b = pr.e;
    while (a < b) {
      const long long mid = (a + b) >> 1;
      if (pr.ord[mid] <= i)
        a = mid + 1;
      else
        b = mid;
    }
    pr.s = a;
  }
  return pr;
}

__global__ void overlap_count(const int64_t* __restrict__ P,
                              const int64_t* __restrict__ S, long long n,
                              int k, const int64_t* __restrict__ p_keys,
                              const int64_t* __restrict__ p_ord,
                              const int64_t* __restrict__ s_keys,
                              const int64_t* __restrict__ s_ord,
                              int64_t* __restrict__ counts) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = blockIdx.y;
  const Probe pr = probe(g, i, P, S, n, k, p_keys, p_ord, s_keys, s_ord);
  counts[g * n + i] = pr.e - pr.s - (pr.self ? 1 : 0);
}

__global__ void overlap_fill(const int64_t* __restrict__ P,
                             const int64_t* __restrict__ S, long long n, int k,
                             const int64_t* __restrict__ p_keys,
                             const int64_t* __restrict__ p_ord,
                             const int64_t* __restrict__ s_keys,
                             const int64_t* __restrict__ s_ord,
                             const int64_t* __restrict__ ends, long long m,
                             int32_t* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = blockIdx.y;
  const Probe pr = probe(g, i, P, S, n, k, p_keys, p_ord, s_keys, s_ord);
  long long at = ends[g * n + i] - (pr.e - pr.s - (pr.self ? 1 : 0));
  for (long long r = pr.s; r < pr.e; ++r) {
    const int64_t j = pr.ord[r];
    if (j == i) continue;
    out[at] = pr.src;
    out[m + at] = (int32_t)(2 * j + pr.bit);
    ++at;
  }
}

dim3 grid(long long n) {
  return dim3((unsigned)((n + kThreads - 1) / kThreads), kPasses);
}

}  // namespace

// P, S: n int64 first and last k-mers; p_keys, p_ord (s_keys, s_ord): P
// (S) sorted stably and the ids in that order, int64; counts: 12 n int64,
// the kept matches of probe (g, i) at g n + i.
extern "C" int kmerset_overlap_count(const void* P, const void* S, long long n,
                                     int k, const void* p_keys,
                                     const void* p_ord, const void* s_keys,
                                     const void* s_ord, void* counts,
                                     void* stream) {
  if (n <= 0) return 0;
  overlap_count<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)P, (const int64_t*)S, n, k, (const int64_t*)p_keys,
      (const int64_t*)p_ord, (const int64_t*)s_keys, (const int64_t*)s_ord,
      (int64_t*)counts);
  return (int)cudaGetLastError();
}

// ends: the inclusive scan of overlap_count's counts, ends[12 n - 1] == m;
// out: 2 m int32, the kept edges' a ports then their b ports.
extern "C" int kmerset_overlap_fill(const void* P, const void* S, long long n,
                                    int k, const void* p_keys,
                                    const void* p_ord, const void* s_keys,
                                    const void* s_ord, const void* ends,
                                    long long m, void* out, void* stream) {
  if (n <= 0) return 0;
  overlap_fill<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)P, (const int64_t*)S, n, k, (const int64_t*)p_keys,
      (const int64_t*)p_ord, (const int64_t*)s_keys, (const int64_t*)s_ord,
      (const int64_t*)ends, m, (int32_t*)out);
  return (int)cudaGetLastError();
}
