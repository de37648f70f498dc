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
// What bounds it on an H100: memory.  The least traffic is one read of the
// row (4 bytes a bin) against ~60 float32 operations a bin.
//
// Design.  One block per row; a row (up to 2^19 + 1 floats) does not fit in
// shared memory, so it stays in global memory and is read several times:
// - the median by an exact radix select on order-preserving 32-bit keys of
//   the floats (non-negative powers keep their bit order; the key map also
//   orders negatives), 11 + 11 + 10 bits in three passes with a 2048-bin
//   shared-memory histogram (warp-aggregated when a warp's keys agree, as
//   on zero-padded rows), then one more pass for the upper middle value
//   only when the lower one's run of equal keys ends at it;
// - the stack reads p[i*j] and divides in the kernel (no normalised copy
//   is written); each thread walks its bins in ascending order with a
//   strict > per depth, and a block reduction takes the larger value,
//   then the smaller bin, so ties resolve to the first index.

#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(kThreads)
harmonic_kernel(const float* __restrict__ power, float* __restrict__ vals,
                int* __restrict__ bins, int nbins, int ndepth, int lo,
                int hi) {
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
    float acc = 0.f;
#pragma unroll
    for (int j = 1; j <= 16; ++j) {
      if (j > hmax) break;
      const int idx = i * j;
      const float v = idx < nbins ? __fdiv_rn(__ldg(p + idx), div) : 0.f;
      acc = acc + v;
      if ((j & (j - 1)) == 0) {  // j = 1, 2, 4, 8, 16: a scored depth
        const int d = j >= 16 ? 4 : j >= 8 ? 3 : j >= 4 ? 2 : j >= 2 ? 1 : 0;
        const float h = acc * band;
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

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) of `device`; returns the
// cudaError_t of the launch (0 on success).  No synchronisation.
int harmonic_launch(const float* power, float* vals, int* bins, int rows,
                    int nbins, int ndepth, int lo, int hi, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndepth < 1 || ndepth > kMaxDepths || nbins < 2 || rows < 1)
    return (int)cudaErrorInvalidValue;
  harmonic_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      power, vals, bins, nbins, ndepth, lo, hi);
  return (int)cudaGetLastError();
}

const char* harmonic_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The compile-time geometry, so the host checks it planned the same.
void harmonic_geometry(int* threads, int* max_depths) {
  *threads = kThreads;
  *max_depths = kMaxDepths;
}

}  // extern "C"
