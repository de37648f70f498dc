// Median-normalise + incremental harmonic stack: the periodicity search's
// scorer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of pulsarutils_tpu/ops/harmonic_pallas.py:
// _build_harmonic_kernel (pallas_call at :124).  For every row p of a raw
// power spectrum (rows, nbins) float32 (DC bin zeroed) it computes
//
//   med   = median(p[1:])          NumPy's convention: (lo + hi) * 0.5 of
//                                  the two middle order statistics
//   norm  = p / (med > 0 ? med / ln2 : 1)          IEEE divides
//   acc_h[i] = sum_{j=1..h} (i*j < nbins ? norm[i*j] : 0)   j ascending
//
// and at each depth h in `depths` (a prefix of 1, 2, 4, 8, 16) the peak
// value and the FIRST argmax of acc_h * band, band = 1 on bins [lo, hi) and
// 0 elsewhere — bins outside the band count as 0.0, so an all-zero band
// returns bin 0, as the argmax of the plain version does.  Outputs vals
// (rows, ndepth) float32 and bins (rows, ndepth) int32.  The false-alarm
// and sigma chain runs afterwards in PyTorch (ops/harmonic_cuda.py).
//
// The stack follows the precision policy of the Pallas kernel (a template
// parameter of both kernels, so the f32 code is unchanged):
// - kF32: acc = acc + v;
// - kCompensated (the policies f32_compensated and split_f32, which the
//   Pallas kernel treats alike): a TwoSum carry beside each accumulator,
//     s = acc + v; bp = s - acc; comp = comp + ((acc - (s - bp)) + (v - bp));
//     acc = s
//   in that association, every add written __fadd_rn / __fsub_rn so that
//   nvcc neither reassociates nor contracts it, each depth scoring
//   (acc + comp) * band;
// - kBf16 (bf16_operand_f32_accum): each normalised bin rounded to
//   bfloat16 (round to nearest even) before the gather, the first
//   harmonic's too, and added in float32.
// The median and the normalise are the same under every policy.
//
// What bounds it on an H100: memory.  The least traffic is one read of the
// row (4 bytes a bin) against ~60 float32 operations a bin.
//
// Two branches, chosen by the host (ops/harmonic_cuda.py: choose_cluster).
//
// The cluster branch (harmonic_cluster_kernel) reads each row from device
// memory once.  A row is cut into `cluster` slices of `slice` bins (a
// multiple of 32), one per block of a thread-block cluster; each block
// copies its slice into shared memory with cp.async.  Persistent clusters,
// as many as the card holds at once, walk the rows, and a block copies its
// next row's slice in behind the current row's harmonic stack.
// - The median is an exact radix select over the slices.  A first pass of
//   11 bits: each block histograms its own keys (warp-aggregated where a
//   warp's keys agree, as on zero-padded rows), the cluster sums the
//   histograms through distributed shared memory (each block sums
//   1/cluster of the bins from every block, then gathers the other
//   shares), and every block picks the same bucket.  Each block then keeps
//   its keys in that bucket (at most kCand, else it scans its slice again)
//   and its least key above it, and two more passes (11 and 10 bits) run
//   over those; the upper middle value needs a min across the blocks only
//   when the lower one ends its run of equal keys.
// - Each block divides its slice by the median in place (one IEEE divide a
//   bin, not one a harmonic) and writes, for every harmonic j, the part of
//   D_j[i] = norm[i*j] whose bins i*j it holds into the cluster's scratch
//   in device memory: consecutive i to consecutive words, so the stack's
//   strided gather becomes coalesced reads, most from L2.
// - The stack: chunk c of 32 bins goes to block c % cluster and warp
//   c / cluster % 16, which takes its chunks in batches sized by the
//   harmonics the batch's first bin has in range (1 chunk of 16 harmonics,
//   2 of 8, 4 of 4, 8 of 2 or 8 of 1), every load of a batch in flight
//   together.  Each thread walks its bins in ascending order with a strict
//   > per depth, and the reductions (warps, blocks, then the cluster) take
//   the larger value, then the smaller bin, so ties resolve to the first
//   index.
// The host picks the cluster size: a row must fit the cluster's shared
// memory, two blocks an SM where a size allows it, and more blocks a row
// when a launch has too few rows to fill the card.  Sizes above 8 are
// non-portable cluster sizes (cudaFuncAttributeNonPortableClusterSizeAllowed,
// set once a device; the host asks cudaOccupancyMaxActiveClusters once a
// shape and launches at most that many clusters).  A slice is stored in
// chunks of 32 with a pad word after each (bin q at q + q / 32),
// so the stride-j reads that write D_j meet at most two to a bank (one for
// j = 1, 2, 4, 8, 16), where unpadded they would meet gcd(j, 32) to a bank.
//
// The global branch (harmonic_global_kernel), for rows too long for 16
// blocks' shared memory: one block per row, the row read from global
// memory for every radix pass and every harmonic:
// - the median by the same radix select over a 2048-bin shared-memory
//   histogram (warp-aggregated when a warp's keys agree, as on zero-padded
//   rows), then one more pass for the upper middle value only when the
//   lower one's run of equal keys ends at it;
// - the stack reads p[i*j] and divides in the kernel (no normalised copy
//   is written).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 2048;           // histogram bins (11 bits)
constexpr int kMaxDepths = 5;         // HARMONIC_SUMS = 1, 2, 4, 8, 16
constexpr unsigned kFull = 0xffffffffu;
// float32(ln 2), the JAX package's _LN2 rounded as its weak-typed divide does
constexpr float kLn2 = 0.693147182464599609375f;

// the stack's precision policies (ops/harmonic_cuda.py: POLICY_CODES)
constexpr int kF32 = 0;
constexpr int kCompensated = 1;
constexpr int kBf16 = 2;

// A normalised bin as the stack adds it under policy P.
template <int P>
__device__ __forceinline__ float operand(float v) {
  if (P == kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// acc += v under policy P; comp is the TwoSum carry of kCompensated.
template <int P>
__device__ __forceinline__ void stack_add(float& acc, float& comp, float v) {
  if (P == kCompensated) {
    const float s = __fadd_rn(acc, v);
    const float bp = __fsub_rn(s, acc);
    comp = __fadd_rn(comp, __fadd_rn(__fsub_rn(acc, __fsub_rn(s, bp)),
                                     __fsub_rn(v, bp)));
    acc = s;
  } else {
    acc = acc + v;
  }
}

// The value a depth scores under policy P.
template <int P>
__device__ __forceinline__ float stacked(float acc, float comp) {
  return P == kCompensated ? __fadd_rn(acc, comp) : acc;
}

__device__ __forceinline__ unsigned to_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Exclusive prefix sum of one value per thread over the block; `total`
// receives the sum.  Uses sh[kWarps].
__device__ int block_exclusive_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  __syncthreads();
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += sh[w];
    all += sh[w];
  }
  *total = all;
  return before + inc - v;
}

// The rank-`k` smallest key (0-based) among p[1 .. nbins-1].  Returns the
// key; `run_left` receives how many keys equal to it rank above k.
__device__ unsigned radix_select(const float* __restrict__ p, int nbins,
                                 int k, int* hist, int* sh, int* shared_out,
                                 int* run_left) {
  unsigned prefix = 0u, pmask = 0u;
  const int lane = threadIdx.x & 31;
  int last_count = 0;
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    // bits 31..21, 20..10, 9..0
    const int shift = pass == 0 ? 21 : pass == 1 ? 10 : 0;
    const unsigned bmask = pass == 2 ? 0x3ffu : 0x7ffu;
    for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0;
    __syncthreads();
    // every lane of a warp runs each round, so the warp vote is safe
    for (int base = 1; base < nbins; base += kThreads) {
      const int i = base + threadIdx.x;
      bool valid = false;
      int bin = 0;
      if (i < nbins) {
        const unsigned key = to_key(__ldg(p + i));
        valid = (key & pmask) == prefix;
        bin = (int)((key >> shift) & bmask);
      }
      const unsigned voters = __ballot_sync(kFull, valid);
      if (voters == 0u) continue;
      const int leader = __ffs(voters) - 1;
      const int b0 = __shfl_sync(kFull, bin, leader);
      if (__all_sync(kFull, !valid || bin == b0)) {
        if (lane == leader) atomicAdd(&hist[b0], __popc(voters));
      } else if (valid) {
        atomicAdd(&hist[bin], 1);
      }
    }
    __syncthreads();
    // each thread owns kBins / kThreads consecutive bins
    constexpr int kPer = kBins / kThreads;
    int mine = 0;
    for (int q = 0; q < kPer; ++q) mine += hist[threadIdx.x * kPer + q];
    int total;
    int below = block_exclusive_scan(mine, sh, &total);
    if (k >= below && k < below + mine) {
      for (int q = 0; q < kPer; ++q) {
        const int c = hist[threadIdx.x * kPer + q];
        if (k < below + c) {
          shared_out[0] = threadIdx.x * kPer + q;
          shared_out[1] = below;
          shared_out[2] = c;
          break;
        }
        below += c;
      }
    }
    __syncthreads();
    const int b = shared_out[0];
    k -= shared_out[1];
    last_count = shared_out[2];
    prefix |= (unsigned)b << shift;
    pmask |= bmask << shift;
    __syncthreads();
  }
  *run_left = last_count - 1 - k;
  return prefix;
}

__device__ unsigned block_min_key_above(const float* __restrict__ p,
                                        int nbins, unsigned floor_key,
                                        unsigned* shu) {
  unsigned best = UINT_MAX;
  for (int i = 1 + threadIdx.x; i < nbins; i += kThreads) {
    const unsigned key = to_key(__ldg(p + i));
    if (key > floor_key && key < best) best = key;
  }
  for (int o = 16; o > 0; o >>= 1)
    best = min(best, __shfl_down_sync(kFull, best, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) shu[warp] = best;
  __syncthreads();
  unsigned all = UINT_MAX;
  for (int w = 0; w < kWarps; ++w) all = min(all, shu[w]);
  return all;
}

struct Peak {
  float v;
  int i;
};

__device__ __forceinline__ Peak better_of(Peak a, Peak b) {
  if (b.v > a.v || (b.v == a.v && b.i < a.i)) return b;
  return a;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
harmonic_global_kernel(const float* __restrict__ power,
                       float* __restrict__ vals, int* __restrict__ bins,
                       int nbins, int ndepth, int lo, int hi) {
  __shared__ int hist[kBins];
  __shared__ int sh[kWarps];
  __shared__ int shared_out[3];
  __shared__ unsigned shu[kWarps];
  __shared__ Peak red[kWarps][kMaxDepths];

  const int row = blockIdx.x;
  const float* p = power + (size_t)row * nbins;
  const int n = nbins - 1;  // the median runs over p[1:]

  // the two middle order statistics, lower and upper
  int run_left;
  const unsigned key_lo = radix_select(p, nbins, (n - 1) / 2, hist, sh,
                                       shared_out, &run_left);
  unsigned key_hi = key_lo;
  if (n % 2 == 0 && run_left == 0)
    key_hi = block_min_key_above(p, nbins, key_lo, shu);
  const float med = (from_key(key_lo) + from_key(key_hi)) * 0.5f;
  const float div = med > 0.f ? __fdiv_rn(med, kLn2) : 1.f;

  // incremental harmonic stack, bins in ascending order per thread; the
  // unrolled j loop makes every depth index a constant (registers)
  Peak best[kMaxDepths];
#pragma unroll
  for (int d = 0; d < kMaxDepths; ++d) best[d] = Peak{-INFINITY, 0};
  const int hmax = 1 << (ndepth - 1);
  for (int i = threadIdx.x; i < nbins; i += kThreads) {
    const float band = (i >= lo && i < hi) ? 1.f : 0.f;
    float acc = 0.f, comp = 0.f;
#pragma unroll
    for (int j = 1; j <= 16; ++j) {
      if (j > hmax) break;
      const int idx = i * j;
      const float v =
          idx < nbins ? operand<P>(__fdiv_rn(__ldg(p + idx), div)) : 0.f;
      stack_add<P>(acc, comp, v);
      if ((j & (j - 1)) == 0) {  // j = 1, 2, 4, 8, 16: a scored depth
        const int d = j >= 16 ? 4 : j >= 8 ? 3 : j >= 4 ? 2 : j >= 2 ? 1 : 0;
        const float h = stacked<P>(acc, comp) * band;
        if (h > best[d].v) best[d] = Peak{h, i};
      }
    }
  }
  // block reduction per depth: larger value, then smaller bin
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 0; d < kMaxDepths; ++d) {
    Peak b = best[d];
    for (int o = 16; o > 0; o >>= 1) {
      Peak other{__shfl_down_sync(kFull, b.v, o),
                 __shfl_down_sync(kFull, b.i, o)};
      b = better_of(b, other);
    }
    if (lane == 0) red[warp][d] = b;
  }
  __syncthreads();
  if (threadIdx.x < ndepth) {
    const int d = threadIdx.x;
    Peak b = red[0][d];
    for (int w = 1; w < kWarps; ++w) b = better_of(b, red[w][d]);
    vals[(size_t)row * ndepth + d] = b.v;
    bins[(size_t)row * ndepth + d] = b.i;
  }
}

// ---------------------------------------------------------------------------
// The cluster branch
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 16;
constexpr int kMaxHarmonic = 16;
// shared memory a block may take on an H100 (227 KB)
constexpr int kSmemPerBlock = 232448;
// keys of the first pass's bucket a block keeps for the later passes; a
// block with more scans its slice instead
constexpr int kCand = 3072;

// The fixed part of a cluster block's shared memory; the slice follows it.
struct ClusterShared {
  int hist[kBins];  // this block's histogram of the pass
  int full[kBins];  // the cluster's histogram: this block's share, then all
  unsigned cand[kCand];  // this block's keys in the first pass's bucket
  int sh[kWarps];
  int sel[3];
  int ncand;         // keys in cand, or -1: the later passes scan the slice
  unsigned above;    // this block's least key above the first bucket
  unsigned min_key;  // this block's least key above the lower middle
  unsigned min_all;  // the cluster's
  int offs[kMaxHarmonic];  // where each harmonic's array starts
  Peak peak[kMaxDepths];  // this block's peaks, read by rank 0
  Peak red[kWarps][kMaxDepths];
};

// Where local bin q of a slice sits: chunks of 32 bins, one pad word after
// each.
__host__ __device__ constexpr int padded(int q) { return q + (q >> 5); }

__host__ __device__ constexpr size_t cluster_smem_bytes(int slice) {
  return sizeof(ClusterShared) + sizeof(float) * (size_t)(padded(slice) + 1);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(gmem)
               : "memory");
}

// This block's histogram of one pass: bins (key >> shift) & bmask of its
// keys whose masked bits equal `prefix`.  The keys are the slice's (the
// row's DC bin, local bin 0 of rank 0, left out) where `count` < 0, else
// the `count` candidates.  A warp whose keys share a bin (a run of equal
// values) adds once.
__device__ void block_histogram(const float* s, int len, bool dc,
                                ClusterShared& cs, int count,
                                unsigned prefix, unsigned pmask, int shift,
                                unsigned bmask) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < kBins; b += kThreads) cs.hist[b] = 0;
  __syncthreads();
  const bool from_slice = count < 0;
  const int n = from_slice ? len : count;
  // q0 is uniform, so every lane of a warp runs each round
  for (int q0 = 0; q0 < n; q0 += kThreads) {
    const int q = q0 + threadIdx.x;
    bool valid = false;
    int bin = 0;
    if (q < n && (!from_slice || q > 0 || !dc)) {
      const unsigned key = from_slice ? to_key(s[padded(q)]) : cs.cand[q];
      valid = (key & pmask) == prefix;
      bin = (int)((key >> shift) & bmask);
    }
    const unsigned voters = __ballot_sync(kFull, valid);
    if (voters == 0u) continue;
    const int leader = __ffs(voters) - 1;
    const int b0 = __shfl_sync(kFull, bin, leader);
    if (__all_sync(kFull, !valid || bin == b0)) {
      if (lane == leader) atomicAdd(&cs.hist[b0], __popc(voters));
    } else if (valid) {
      atomicAdd(&cs.hist[bin], 1);
    }
  }
}

// Sums the blocks' histograms over the cluster and finds the bucket of
// rank k: cs.sel = {bucket, keys below it, keys in it}, the same in every
// block.  Each block sums 1/cluster of the bins from every block, then
// gathers the other shares.  No block rewrites its histogram or its share
// before every block has passed the next call's first cluster barrier, by
// which time every block is done reading them.
__device__ void cluster_bucket(cooperative_groups::cluster_group& cluster,
                               ClusterShared& cs, int k) {
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int share = (kBins + nblk - 1) / nblk;
  cluster.sync();  // every block's histogram is complete
  const int b_end = min(kBins, (rank + 1) * share);
  for (int b = rank * share + threadIdx.x; b < b_end; b += kThreads) {
    int part[kMaxCluster];  // every block's count in flight at once
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      part[r] = r < nblk ? cluster.map_shared_rank(cs.hist, r)[b] : 0;
    int total = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) total += part[r];
    cs.full[b] = total;
  }
  cluster.sync();  // every share is summed
  int gathered[kBins / kThreads];  // in flight at once
#pragma unroll
  for (int q = 0; q < kBins / kThreads; ++q) {
    const int b = threadIdx.x + q * kThreads;
    gathered[q] = cluster.map_shared_rank(cs.full, b / share)[b];
  }
#pragma unroll
  for (int q = 0; q < kBins / kThreads; ++q) {
    const int b = threadIdx.x + q * kThreads;
    if (b / share != rank) cs.full[b] = gathered[q];
  }
  __syncthreads();
  // each thread owns kBins / kThreads consecutive bins
  constexpr int kPer = kBins / kThreads;
  int mine = 0;
  for (int q = 0; q < kPer; ++q) mine += cs.full[threadIdx.x * kPer + q];
  int total;
  int below = block_exclusive_scan(mine, cs.sh, &total);
  if (k >= below && k < below + mine) {
    for (int q = 0; q < kPer; ++q) {
      const int c = cs.full[threadIdx.x * kPer + q];
      if (k < below + c) {
        cs.sel[0] = threadIdx.x * kPer + q;
        cs.sel[1] = below;
        cs.sel[2] = c;
        break;
      }
      below += c;
    }
  }
  __syncthreads();
}

// The cluster-wide least of one key a thread; the same in every block.
__device__ unsigned cluster_min(cooperative_groups::cluster_group& cluster,
                                unsigned v, ClusterShared& cs) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_down_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* shu = reinterpret_cast<unsigned*>(cs.sh);
  if (lane == 0) shu[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned all = UINT_MAX;
    for (int w = 0; w < kWarps; ++w) all = min(all, shu[w]);
    cs.min_key = all;
  }
  cluster.sync();  // every block's least key is written
  if (threadIdx.x == 0) {
    unsigned all = UINT_MAX;
    for (int r = 0; r < (int)cluster.num_blocks(); ++r)
      all = min(all, *cluster.map_shared_rank(&cs.min_key, r));
    cs.min_all = all;
  }
  __syncthreads();
  return cs.min_all;
}

// NumPy's median of the cluster's keys of p[1:] (lower and upper middle
// order statistics, averaged), by an exact radix select: a first pass of
// 11 bits over the slices; each block then keeps its keys in the chosen
// bucket (and its least key above the bucket) and the two later passes
// (11 and 10 bits) run over those alone, or over the slice where a block
// holds more than kCand of them.  The upper middle value needs one more
// look only when the lower one ends its run of equal keys.
__device__ float cluster_median(cooperative_groups::cluster_group& cluster,
                                const float* s, int len, bool dc, int nbins,
                                ClusterShared& cs) {
  const int lane = threadIdx.x & 31;
  const int n = nbins - 1;
  int k = (n - 1) / 2;
  block_histogram(s, len, dc, cs, -1, 0u, 0u, 21, 0x7ffu);
  cluster_bucket(cluster, cs, k);
  const unsigned b1 = (unsigned)cs.sel[0];
  k -= cs.sel[1];
  int last_count = cs.sel[2];
  // this block's keys in the bucket: compacted, or scanned again
  const int mine = cs.hist[b1];
  if (threadIdx.x == 0) {
    cs.ncand = mine <= kCand ? 0 : -1;
    cs.above = UINT_MAX;
  }
  __syncthreads();
  if (mine <= kCand) {
    unsigned above = UINT_MAX;
    for (int q0 = 0; q0 < len; q0 += kThreads) {
      const int q = q0 + threadIdx.x;
      bool in = false;
      unsigned key = 0u;
      if (q < len && (q > 0 || !dc)) {
        key = to_key(s[padded(q)]);
        const unsigned b = key >> 21;
        in = b == b1;
        if (b > b1) above = min(above, key);
      }
      const unsigned voters = __ballot_sync(kFull, in);
      if (voters == 0u) continue;
      const int leader = __ffs(voters) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(&cs.ncand, __popc(voters));
      at = __shfl_sync(kFull, at, leader);
      if (in) cs.cand[at + __popc(voters & ((1u << lane) - 1u))] = key;
    }
    for (int o = 16; o > 0; o >>= 1)
      above = min(above, __shfl_down_sync(kFull, above, o));
    if (lane == 0) atomicMin(&cs.above, above);
    __syncthreads();
  }
  const int count = cs.ncand;
  unsigned prefix = b1 << 21, pmask = 0x7ffu << 21;
#pragma unroll 1
  for (int pass = 1; pass < 3; ++pass) {
    const int shift = pass == 1 ? 10 : 0;
    const unsigned bmask = pass == 1 ? 0x7ffu : 0x3ffu;
    block_histogram(s, len, dc, cs, count, prefix, pmask, shift, bmask);
    cluster_bucket(cluster, cs, k);
    k -= cs.sel[1];
    last_count = cs.sel[2];
    prefix |= (unsigned)cs.sel[0] << shift;
    pmask |= bmask << shift;
  }
  const unsigned key_lo = prefix;
  unsigned key_hi = key_lo;
  if (n % 2 == 0 && last_count - 1 - k == 0) {  // the same in every block
    unsigned best = UINT_MAX;
    if (count < 0) {
      for (int q = threadIdx.x; q < len; q += kThreads) {
        const unsigned key = to_key(s[padded(q)]);
        if ((q > 0 || !dc) && key > key_lo) best = min(best, key);
      }
    } else {
      for (int q = threadIdx.x; q < count; q += kThreads)
        if (cs.cand[q] > key_lo) best = min(best, cs.cand[q]);
      best = min(best, cs.above);
    }
    key_hi = cluster_min(cluster, best, cs);
  }
  return (from_key(key_lo) + from_key(key_hi)) * 0.5f;
}

// The stack of G of a warp's chunks (chunks c0, c0 + cstep, ... of 32
// bins), reading harmonics 1..J of each (no more are in range for any of
// them) from the harmonic arrays D_j[i] = norm[i*j] at `scr`: all G x J
// loads in flight together, then the adds in ascending j (0 for a
// harmonic out of range) and each depth's running peak over the bins in
// ascending order.  Harmonics J+1..hmax would add 0, which changes neither
// a finite acc (never -0) nor its TwoSum carry: they are skipped.
template <int P, int G, int J>
__device__ __forceinline__ void stack_batch(const float* __restrict__ scr,
                                            const int* offs, int c0,
                                            int cstep, int nbins, int lo,
                                            int hi, int hmax, Peak* best) {
  const int lane = threadIdx.x & 31;
  float v[G][J];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int i = ((c0 + g * cstep) << 5) + lane;
#pragma unroll
    for (int j = 1; j <= J; ++j) {
      const bool in_range =
          j <= hmax && (unsigned)i * (unsigned)j < (unsigned)nbins;
      // a harmonic out of range reads D_j[0] and counts as 0
      const float t = __ldcg(scr + offs[j - 1] + (in_range ? i : 0));
      v[g][j - 1] = in_range ? t : 0.f;
    }
  }
  float acc[G], comp[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = comp[g] = 0.f;
#pragma unroll
  for (int j = 1; j <= kMaxHarmonic; ++j) {
    if (j > hmax) break;
    if (j <= J) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        stack_add<P>(acc[g], comp[g], v[g][j <= J ? j - 1 : 0]);
    }
    if ((j & (j - 1)) == 0) {  // j = 1, 2, 4, 8, 16: a scored depth
      const int d = j >= 16 ? 4 : j >= 8 ? 3 : j >= 4 ? 2 : j >= 2 ? 1 : 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int i = ((c0 + g * cstep) << 5) + lane;
        const float h =
            stacked<P>(acc[g], comp[g]) * ((i >= lo && i < hi) ? 1.f : 0.f);
        if (i < nbins && h > best[d].v) best[d] = Peak{h, i};
      }
    }
  }
}

// Persistent clusters: cluster `slot` takes rows slot, slot + nslots, ...
// (nslots = gridDim.x / cluster); block `rank` holds bins [rank * slice,
// rank * slice + slice) of the row, and `scratch` holds each cluster's
// harmonic arrays at slot * scr_len.
template <int P>
__global__ void __launch_bounds__(kThreads, 2)
harmonic_cluster_kernel(const float* __restrict__ power,
                        float* __restrict__ vals, int* __restrict__ bins,
                        float* __restrict__ scratch, int rows, int nbins,
                        int ndepth, int lo, int hi, int slice,
                        int scr_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  ClusterShared& cs = *reinterpret_cast<ClusterShared*>(smem);
  float* s = reinterpret_cast<float*>(smem + sizeof(ClusterShared));
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int slot = blockIdx.x / nblk;
  const int nslots = gridDim.x / nblk;
  const int base = rank * slice;
  const int len = max(0, min(slice, nbins - base));
  const bool dc = rank == 0;  // local bin 0 is the row's DC bin
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hmax = 1 << (ndepth - 1);
  float* scr = scratch + (size_t)slot * scr_len;
  // where harmonic j's array D_j[i] = norm[i*j], i < ceil(nbins / j),
  // starts in the scratch
  if (threadIdx.x == 0) {
    int at = 0;
    for (int j = 1; j <= kMaxHarmonic; ++j) {
      cs.offs[j - 1] = at;
      at += (nbins + j - 1) / j;
    }
  }
  // queues the copy of row r's bins of this block into the slice
  auto load_slice = [&](int r) {
    const float* src = power + (size_t)r * nbins + base;
    for (int q = threadIdx.x; q < len; q += kThreads)
      cp_async4(s + padded(q), src + q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (slot < rows) load_slice(slot);
  for (int row = slot; row < rows; row += nslots) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const float med = cluster_median(cluster, s, len, dc, nbins, cs);
    const float div = med > 0.f ? __fdiv_rn(med, kLn2) : 1.f;
    for (int q = threadIdx.x; q < len; q += kThreads)
      s[padded(q)] = operand<P>(__fdiv_rn(s[padded(q)], div));
    __syncthreads();
    // harmonic j of bin i is bin i*j of some slice: this block writes
    // D_j[i] for the i*j it holds, consecutive i to consecutive words
    for (int j = 1; j <= hmax; ++j) {
      const int i_lo = (base + j - 1) / j;
      const int i_hi = (base + len + j - 1) / j;
      float* dj = scr + cs.offs[j - 1];
      for (int i = i_lo + threadIdx.x; i < i_hi; i += kThreads)
        dj[i] = s[padded(i * j - base)];
    }
    __threadfence();
    cluster.sync();  // every block's arrays are written; the slice is free
    if (row + nslots < rows) load_slice(row + nslots);  // behind the stack

    Peak best[kMaxDepths];
#pragma unroll
    for (int d = 0; d < kMaxDepths; ++d) best[d] = Peak{-INFINITY, 0};
    // chunk c of 32 bins goes to block c % cluster and warp c / cluster
    // % kWarps; a warp takes its chunks in batches sized by the
    // harmonics the batch's first bin has in range, so that about 16
    // loads a lane are in flight together
    const int chunks = (nbins + 31) >> 5;
    const int cstep = nblk * kWarps;
    int c = rank + nblk * warp;
    while (c < chunks) {
      const int first = c << 5;
      const int jw = first == 0 ? hmax : min(hmax, (nbins - 1) / first);
      if (jw > 8) {
        stack_batch<P, 1, 16>(scr, cs.offs, c, cstep, nbins, lo, hi, hmax,
                           best);
        c += cstep;
      } else if (jw > 4) {
        stack_batch<P, 2, 8>(scr, cs.offs, c, cstep, nbins, lo, hi, hmax,
                          best);
        c += 2 * cstep;
      } else if (jw > 2) {
        stack_batch<P, 4, 4>(scr, cs.offs, c, cstep, nbins, lo, hi, hmax,
                          best);
        c += 4 * cstep;
      } else if (jw == 2) {
        stack_batch<P, 8, 2>(scr, cs.offs, c, cstep, nbins, lo, hi, hmax,
                          best);
        c += 8 * cstep;
      } else {
        stack_batch<P, 8, 1>(scr, cs.offs, c, cstep, nbins, lo, hi, hmax,
                          best);
        c += 8 * cstep;
      }
    }
    // reductions per depth (larger value, then smaller bin): warps, then
    // the block, then rank 0 over the cluster
#pragma unroll
    for (int d = 0; d < kMaxDepths; ++d) {
      Peak b = best[d];
      for (int o = 16; o > 0; o >>= 1) {
        Peak other{__shfl_down_sync(kFull, b.v, o),
                   __shfl_down_sync(kFull, b.i, o)};
        b = better_of(b, other);
      }
      if (lane == 0) cs.red[warp][d] = b;
    }
    __syncthreads();
    if (threadIdx.x < ndepth) {
      const int d = threadIdx.x;
      Peak b = cs.red[0][d];
      for (int w = 1; w < kWarps; ++w) b = better_of(b, cs.red[w][d]);
      cs.peak[d] = b;
    }
    cluster.sync();  // every block's peaks are written
    if (rank == 0 && threadIdx.x < ndepth) {
      const int d = threadIdx.x;
      Peak b = cs.peak[d];
      for (int r = 1; r < nblk; ++r)
        b = better_of(b, cluster.map_shared_rank(cs.peak, r)[d]);
      vals[(size_t)row * ndepth + d] = b.v;
      bins[(size_t)row * ndepth + d] = b.i;
    }
    // no block rewrites its peaks or its arrays, or leaves, while another
    // may still read them
    cluster.sync();
  }
}

// Bins each block of a `cluster`-block row holds: a multiple of 32.
int slice_bins(int nbins, int cluster) {
  return ((nbins + cluster - 1) / cluster + 31) / 32 * 32;
}

// Floats of one cluster's harmonic arrays: ceil(nbins / j), j = 1..hmax.
int scratch_floats(int nbins, int ndepth) {
  int at = 0;
  for (int j = 1; j <= (1 << (ndepth - 1)); ++j) at += (nbins + j - 1) / j;
  return at;
}

// The largest slice a cluster block holds.
constexpr int max_slice() {
  int lo = 0, hi = kSmemPerBlock;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (cluster_smem_bytes(mid) <= (size_t)kSmemPerBlock) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Sets policy P's cluster kernel attributes on `device` (the current
// device) once: the most shared memory a block may take, and cluster sizes
// above 8.  0 or a cudaError_t.
template <int P>
int configure_cluster_kernel(int device) {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (done.load() & bit) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      harmonic_cluster_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemPerBlock);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(harmonic_cluster_kernel<P>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit);
  return 0;
}

// Policy P's cluster launch configuration; 0 or a cudaError_t.
template <int P>
int cluster_config(int nbins, int cluster, int clusters, int device,
                   cudaStream_t stream, cudaLaunchConfig_t* config,
                   cudaLaunchAttribute* attr) {
  const int slice = slice_bins(nbins, cluster);
  if (slice > max_slice()) return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem_bytes(slice);
  const int err = configure_cluster_kernel<P>(device);
  if (err != 0) return err;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3((unsigned)(clusters * cluster));
  config->blockDim = dim3(kThreads);
  config->dynamicSmemBytes = smem;
  config->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
  return 0;
}

// harmonic_launch under policy P.
template <int P>
int launch(const float* power, float* vals, int* bins, float* scratch,
           int rows, int nbins, int ndepth, int lo, int hi, int cluster,
           int clusters, int device, cudaStream_t stream) {
  if (cluster == 1) {
    harmonic_global_kernel<P><<<rows, kThreads, 0, stream>>>(
        power, vals, bins, nbins, ndepth, lo, hi);
    return (int)cudaGetLastError();
  }
  if (clusters < 1 || (long long)clusters * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  const int got = cluster_config<P>(nbins, cluster, clusters, device, stream,
                                    &config, attr);
  if (got != 0) return got;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, harmonic_cluster_kernel<P>, power, vals, bins, scratch, rows,
      nbins, ndepth, lo, hi, slice_bins(nbins, cluster),
      scratch_floats(nbins, ndepth));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// harmonic_active_clusters under policy P.
template <int P>
int active_clusters(int nbins, int cluster, int device) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  const int got = cluster_config<P>(nbins, cluster, 1, device, 0, &config,
                                    attr);
  if (got != 0) return -got;
  int active = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &active, harmonic_cluster_kernel<P>, &config);
  return err == cudaSuccess ? active : -(int)err;
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) of `device`; returns the
// cudaError_t of the launch (0 on success).  No synchronisation.
// `policy`: the stack's precision policy code (0 f32, 1 compensated, 2
// bf16).  `cluster` 1 takes the global branch (one block a row); 2..16 the
// cluster branch with that many blocks a row, each holding
// slice_bins(nbins, cluster) bins, over `clusters` clusters that walk the
// rows, with `scratch` (clusters x scratch_floats floats) for their
// harmonic arrays.  The caller takes `clusters` from
// harmonic_active_clusters (at most that many); a cluster the card cannot
// run fails in cudaLaunchKernelEx.
int harmonic_launch(const float* power, float* vals, int* bins,
                    float* scratch, int rows, int nbins, int ndepth, int lo,
                    int hi, int cluster, int clusters, int policy,
                    int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndepth < 1 || ndepth > kMaxDepths || nbins < 2 || rows < 1 ||
      cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (policy) {
    case kF32:
      return launch<kF32>(power, vals, bins, scratch, rows, nbins, ndepth,
                          lo, hi, cluster, clusters, device, st);
    case kCompensated:
      return launch<kCompensated>(power, vals, bins, scratch, rows, nbins,
                                  ndepth, lo, hi, cluster, clusters, device,
                                  st);
    case kBf16:
      return launch<kBf16>(power, vals, bins, scratch, rows, nbins, ndepth,
                           lo, hi, cluster, clusters, device, st);
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `cluster` blocks holding a row of `nbins` bins the
// card runs at once under `policy` (0: none), or a negative cudaError_t.
int harmonic_active_clusters(int nbins, int cluster, int policy,
                             int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  if (cluster < 2 || cluster > kMaxCluster ||
      slice_bins(nbins, cluster) > max_slice())
    return 0;
  switch (policy) {
    case kF32: return active_clusters<kF32>(nbins, cluster, device);
    case kCompensated:
      return active_clusters<kCompensated>(nbins, cluster, device);
    case kBf16: return active_clusters<kBf16>(nbins, cluster, device);
  }
  return 0;
}

const char* harmonic_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The compile-time geometry, so the host checks it planned the same:
// threads a block, depths, the largest cluster, the fixed shared memory of
// a cluster block and the largest slice it holds.
void harmonic_geometry(int* threads, int* max_depths, int* max_cluster,
                       int* fixed_smem, int* slice_max) {
  *threads = kThreads;
  *max_depths = kMaxDepths;
  *max_cluster = kMaxCluster;
  *fixed_smem = (int)sizeof(ClusterShared);
  *slice_max = max_slice();
}

}  // extern "C"
