// W1: the canonical unitig walk and emission, on Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It replaces the host C walk of the canonical
// SPSS build (native/kmerio.c: kmerio_chain_pairs, kmerio_chain_emit and
// kmerio_emit_kmer_chains, driven by core/spss.py:get_unitigs_canonical
// through core/native.chain_walk_kept and emit_kmer_chains), which needed
// the graph front-end's successor array (16 B per k-mer) on the host.  The
// JAX package's counterpart is the mesh's XLA pointer doubling and
// render_chains (kmerset_tpu/parallel/), which this does not copy: here
// the front-end's own device arrays are walked where they lie, and only
// the finished strings leave the card.
//
// Contract: the strings are exactly those of the host walk, in its order.
// Node u = (entity << 1) | o (o = 0 reads the k-mer forward and leaves by
// its right side, o = 1 reads its reverse complement); succ[u] is the next
// node or -1 at a terminal exit; a chain's mirror is e^1 -> ... -> s^1.
// Three launches per set, in order:
//   1. walk_measure: one thread per start follows succ to the chain's end
//      and records (end, length).  A walk past n_nodes + 1 nodes (a cycle
//      reached from a start) or to a node out of range sets *bad, the
//      host walk's refusal (kmerio_chain_pairs returns -1 there).
//   2. walk_rank: one block of 64 threads per 64 consecutive starts, the
//      host walk's interleave batch.  Each thread finds its mirror's start
//      by binary search (starts are the right exits ascending, then the
//      left exits ascending), checks that the mirror's walk ends at its
//      own start's mirror with the same length (else *bad: the host walk
//      would not pair them), and records the pair if it holds the lower
//      position, as the host walk does: mirrors in one batch finish on the
//      same step and the lower lane records first; a mirror in an earlier
//      batch marked this start seen.  The recording start keeps the
//      orientation whose first k-mer is >= its last (the reference's skip
//      rule, lib/core/spss.h:511,555).  Within the batch the recorded
//      chains are ranked by (length, lane), the order in which the host
//      walk's lanes finish, with the bytes of the strings ranked before;
//      thread 0 writes the batch's chain count and bytes.  Between 2 and 3
//      the wrapper scans those per batch (torch.cumsum).
//   3. walk_emit: one thread per recorded chain walks it again from its
//      kept start and writes its string (k codes for the first node, the
//      last code of each following node) at its offset; the walk must stop
//      exactly at the measured length (else *bad, kmerio_chain_emit's
//      check).  Threads past the starts write the isolated k-mers, k codes
//      each, after the chains.  Every entity written is marked covered, so
//      that the wrapper can tell whether pure cycles are left for the host.
//
// What bounds it: the latency of the longest chain's dependent loads, not
// bytes.  The walks read succ and A at random; counted once, their inputs
// and outputs are 125 MB on an E. coli-sized set (4.6M k-mers at k = 15),
// 0.037 ms at 3.35 TB/s, while one chain of L nodes is L loads one after
// another at a DRAM latency each.  The design hides that latency the way the host walk
// could not: every start is walked at once (one thread each, 236,728
// starts in one wave on that set), so the time is that of the longest
// chain and not of the sum.  The ranking is 64 shared-memory comparisons
// per thread; the writes are byte stores, each thread's contiguous.  On
// one H100 on that set (longest chain 433 nodes): measure 0.297 ms, 0.69
// us a step of the longest chain; rank 0.033 ms; emit 0.459 ms; the
// plain PyTorch version 238 ms; the host C walk it replaces about 0.23 s.
// A set whose chains are long pays that latency twice (measure and emit)
// for every node of its longest chain, whatever its size: below
// ops/backend.WALK_MIN_KMERS k-mers the host walk is taken.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 64;     // the host walk's interleave width
constexpr int kThreads = 256;  // per block of walk_measure and walk_emit

__global__ void walk_measure(const int64_t* __restrict__ succ,
                             long long n_nodes,
                             const int64_t* __restrict__ starts, long long ns,
                             int64_t* __restrict__ ends,
                             int64_t* __restrict__ lens, int* bad) {
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= ns) return;
  int64_t u = starts[p], last = u;
  long long len = 0;
  while (u >= 0) {
    if (u >= n_nodes || len > n_nodes) {
      *bad = 1;
      break;
    }
    last = u;
    ++len;
    u = succ[u];
  }
  ends[p] = last;
  lens[p] = len;
}

// Position of x in the ascending starts[lo, hi), or -1.
__device__ __forceinline__ long long find_start(
    const int64_t* __restrict__ starts, long long lo, long long hi, int64_t x) {
  const long long end = hi;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (starts[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < end && starts[lo] == x ? lo : -1;
}

__global__ void walk_rank(const int64_t* __restrict__ A,
                          const int64_t* __restrict__ starts, long long ns,
                          long long n_right, const int64_t* __restrict__ ends,
                          const int64_t* __restrict__ lens, int k, int* bad,
                          int* __restrict__ rank, int64_t* __restrict__ kept,
                          int64_t* __restrict__ before,
                          int64_t* __restrict__ batch_count,
                          int64_t* __restrict__ batch_bytes) {
  __shared__ int64_t s_len[kLanes];
  __shared__ int s_rec[kLanes];
  const int t = threadIdx.x;
  const long long p = (long long)blockIdx.x * kLanes + t;
  int rec = 0;
  int64_t len = 0;
  if (p < ns) {
    const int64_t s = starts[p], e = ends[p], m = e ^ 1;
    len = lens[p];
    const long long pm =
        (m & 1) ? find_start(starts, n_right, ns, m)
                : find_start(starts, 0, n_right, m);
    if (pm >= 0 && (ends[pm] != (s ^ 1) || lens[pm] != len)) *bad = 1;
    rec = pm < 0 || p <= pm;
    if (rec) kept[p] = A[s >> 1] >= A[e >> 1] ? s : m;
  }
  s_len[t] = len;
  s_rec[t] = rec;
  __syncthreads();
  if (p < ns) {
    int r = -1;
    int64_t b = 0;
    if (rec) {
      r = 0;
      for (int j = 0; j < kLanes; ++j) {
        if (s_rec[j] && (s_len[j] < len || (s_len[j] == len && j < t))) {
          ++r;
          b += s_len[j] + k - 1;
        }
      }
    }
    rank[p] = r;
    before[p] = b;
  }
  if (t == 0) {
    long long c = 0, b = 0;
    for (int j = 0; j < kLanes; ++j) {
      if (s_rec[j]) {
        ++c;
        b += s_len[j] + k - 1;
      }
    }
    batch_count[blockIdx.x] = c;
    batch_bytes[blockIdx.x] = b;
  }
}

// The k codes of the k-mer v, read forward or as its reverse complement.
__device__ __forceinline__ void put_kmer(uint8_t* out, uint64_t v, int k,
                                         bool flip) {
  for (int j = 0; j < k; ++j)
    out[j] = flip ? (uint8_t)(3 - ((v >> (2 * j)) & 3))
                  : (uint8_t)((v >> (2 * (k - 1 - j))) & 3);
}

__global__ void walk_emit(
    const int64_t* __restrict__ A, const int64_t* __restrict__ succ,
    long long n_nodes, int k, long long ns, const int* __restrict__ rank,
    const int64_t* __restrict__ kept, const int64_t* __restrict__ lens,
    const int64_t* __restrict__ before,
    const int64_t* __restrict__ batch_first,
    const int64_t* __restrict__ batch_at, const int64_t* __restrict__ iso,
    long long n_iso, long long n_chains, long long chain_bytes,
    uint8_t* __restrict__ codes, int64_t* __restrict__ offsets,
    uint8_t* __restrict__ covered, int* bad) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i == 0) offsets[0] = 0;
  if (i < ns) {
    const int r = rank[i];
    if (r < 0) return;
    const long long b = i / kLanes;
    const long long at = batch_at[b] + before[i];
    const long long len = lens[i];
    uint8_t* out = codes + at;
    int64_t u = kept[i];
    put_kmer(out, (uint64_t)A[u >> 1], k, u & 1);
    covered[u >> 1] = 1;
    out += k;
    const int top = 2 * (k - 1);
    for (long long t = 1; t < len; ++t) {
      u = succ[u];
      if (u < 0 || u >= n_nodes) {
        *bad = 1;
        return;
      }
      const uint64_t v = (uint64_t)A[u >> 1];
      *out++ = (u & 1) ? (uint8_t)(3 - ((v >> top) & 3)) : (uint8_t)(v & 3);
      covered[u >> 1] = 1;
    }
    if (succ[u] >= 0) *bad = 1;  // longer than measured
    offsets[batch_first[b] + r + 1] = at + len + k - 1;
  } else if (i < ns + n_iso) {
    const long long j = i - ns;
    const int64_t e = iso[j];
    put_kmer(codes + chain_bytes + j * k, (uint64_t)A[e], k, false);
    covered[e] = 1;
    offsets[n_chains + j + 1] = chain_bytes + (j + 1) * k;
  }
}

unsigned blocks(long long n, int per) { return (unsigned)((n + per - 1) / per); }

}  // namespace

// succ: n_nodes int64; starts, ends, lens: ns int64; bad: one int32.
extern "C" int kmerset_walk_measure(const void* succ, long long n_nodes,
                                    const void* starts, long long ns,
                                    void* ends, void* lens, void* bad,
                                    void* stream) {
  if (ns <= 0) return 0;
  walk_measure<<<blocks(ns, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)succ, n_nodes, (const int64_t*)starts, ns,
      (int64_t*)ends, (int64_t*)lens, (int*)bad);
  return (int)cudaGetLastError();
}

// A: the set, int64; starts[0, n_right) the right exits, starts[n_right,
// ns) the left exits, each ascending; rank: ns int32; kept, before: ns
// int64; batch_count, batch_bytes: ceil(ns / 64) int64.
extern "C" int kmerset_walk_rank(const void* A, const void* starts,
                                 long long ns, long long n_right,
                                 const void* ends, const void* lens, int k,
                                 void* bad, void* rank, void* kept,
                                 void* before, void* batch_count,
                                 void* batch_bytes, void* stream) {
  if (ns <= 0) return 0;
  walk_rank<<<blocks(ns, kLanes), kLanes, 0, (cudaStream_t)stream>>>(
      (const int64_t*)A, (const int64_t*)starts, ns, n_right,
      (const int64_t*)ends, (const int64_t*)lens, k, (int*)bad, (int*)rank,
      (int64_t*)kept, (int64_t*)before, (int64_t*)batch_count,
      (int64_t*)batch_bytes);
  return (int)cudaGetLastError();
}

// batch_first, batch_at: the exclusive scans of walk_rank's batch counts
// and bytes; iso: n_iso int64 entities; codes: chain_bytes + n_iso * k
// bytes; offsets: n_chains + n_iso + 1 int64; covered: one byte per entity,
// zeroed by the caller.
extern "C" int kmerset_walk_emit(
    const void* A, const void* succ, long long n_nodes, int k, long long ns,
    const void* rank, const void* kept, const void* lens, const void* before,
    const void* batch_first, const void* batch_at, const void* iso,
    long long n_iso, long long n_chains, long long chain_bytes, void* codes,
    void* offsets, void* covered, void* bad, void* stream) {
  const long long n = ns + n_iso > 0 ? ns + n_iso : 1;
  walk_emit<<<blocks(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)A, (const int64_t*)succ, n_nodes, k, ns,
      (const int*)rank, (const int64_t*)kept, (const int64_t*)lens,
      (const int64_t*)before, (const int64_t*)batch_first,
      (const int64_t*)batch_at, (const int64_t*)iso, n_iso, n_chains,
      chain_bytes, (uint8_t*)codes, (int64_t*)offsets, (uint8_t*)covered,
      (int*)bad);
  return (int)cudaGetLastError();
}
