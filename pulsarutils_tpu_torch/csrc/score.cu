// One-pass boxcar scorer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of pulsarutils_tpu/ops/score_pallas.py:
// _build_score_kernel (pallas_call at :256).  For every row x of a plane
// (rows, T) float32 it computes, with m the row mean:
//
//   max  = max_t (x - m)                std = std(x)   (population)
//   snr  = best over widths w = 1, 2, 4, 8 (strict >, widths ascending) of
//          max(B_w) / std(B_w), B_w the floor(T / w) aligned block sums of
//          x - m; window = that w; peak = w * (first argmax of B_w)
//   cert = max over w = 2, 3, 4 of max_t S_w(t) / (std * sqrt(w)), S_w the
//          sliding sums of x - m over windows that wrap circularly at T
//
// — the semantics of score_profiles_stacked + cert_profile_scores (the
// plain PyTorch versions in pulsarutils_tpu_torch/ops/search.py) — and
// writes them as doubles to out (5 or 6, rows): max, std, snr, window,
// peak, cert.  Window and peak are exact integers in a double.  The TPU
// kernel needed a time tile dividing T and sent the rows past a multiple
// of 8 to another scorer; this kernel takes every T >= 8 and every row
// count.
//
// What bounds it on an H100: ~16 adds and compares per sample against 4
// bytes read per sample, below the card's flop/byte balance: memory
// traffic, the plane read once.
//
// Design.  One block per row; each thread walks aligned groups of 8
// samples (a width-8 block never straddles two groups) in ascending order,
// keeping its partial sums in double and its maxima with the first index
// on ties; a block reduction combines the threads (larger value, then
// smaller index).  Numerics: raw float32 block sums cancel at a large DC
// offset, so every value is centred first, on c = the mean of the row's
// first kCentre samples.  The plain version subtracts the row mean rounded
// once to float32, m32 (its float64 mean, rounded); the kernel recovers it
// from the residual mean(x - c), accumulated in double, as m32 = c +
// mean(x - c) rounded, and moves every maximum by the constant d = c - m32
// at the end: B_w(x - m32) = B_w(x - c) + w * d.  At a DC offset both
// sides are exact multiples of the offset's ulp, so the maxima agree bit
// for bit.  Within a group the block sums associate as the plain
// version's pyramid does: w2 = x0 + x1, w4 = w2 + w2', w8 = w4 + w4'; the
// sliding sums as s2 = x0 + x1, s3 = s2 + x2, s4 = s2 + (x2 + x3).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCentre = 4096;  // samples whose mean centres the row

struct Best {
  float v;
  long long i;
};

__device__ __forceinline__ void take(Best& b, float v, long long i) {
  if (v > b.v) {  // ascending i per thread: strict > keeps the first
    b.v = v;
    b.i = i;
  }
}

__device__ __forceinline__ Best combine(Best a, Best b) {
  if (b.v > a.v || (b.v == a.v && b.i < a.i)) return b;
  return a;
}

__device__ double block_sum(double v, double* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < kWarps; ++w) total += sh[w];
  return total;
}

__device__ Best block_best(Best b, float* shv, long long* shi) {
  for (int o = 16; o > 0; o >>= 1) {
    Best other;
    other.v = __shfl_down_sync(0xffffffffu, b.v, o);
    other.i = __shfl_down_sync(0xffffffffu, b.i, o);
    b = combine(b, other);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    shv[warp] = b.v;
    shi[warp] = b.i;
  }
  __syncthreads();
  Best total = {shv[0], shi[0]};
  for (int w = 1; w < kWarps; ++w) total = combine(total, Best{shv[w], shi[w]});
  return total;
}

__device__ float block_max(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float total = sh[0];
  for (int w = 1; w < kWarps; ++w) total = fmaxf(total, sh[w]);
  return total;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ plane, double* __restrict__ out,
             int rows, int nsamples, int with_cert) {
  __shared__ double sh_d[kWarps];
  __shared__ float sh_f[kWarps];
  __shared__ long long sh_i[kWarps];

  const int row = blockIdx.x;
  const float* x = plane + (size_t)row * nsamples;
  const int tid = threadIdx.x;

  // the centring constant: the mean of the first kCentre samples
  const int n0 = nsamples < kCentre ? nsamples : kCentre;
  double part = 0.0;
  for (int j = tid; j < n0; j += kThreads) part += __ldg(x + j);
  const float c = (float)(block_sum(part, sh_d) / n0);

  // partial sums (width 1, 2, 4, 8) and their squares, in double
  double sum[4] = {0.0, 0.0, 0.0, 0.0};
  double ssq[4] = {0.0, 0.0, 0.0, 0.0};
  Best best[4];
  for (int k = 0; k < 4; ++k) best[k] = Best{-INFINITY, LLONG_MAX};
  float cm[3] = {-INFINITY, -INFINITY, -INFINITY};  // sliding 2, 3, 4

  const int ngroups = (nsamples + 7) / 8;
  for (int g = tid; g < ngroups; g += kThreads) {
    const int base = 8 * g;
    const int n_in = nsamples - base < 8 ? nsamples - base : 8;
    float v[11];
    if (kVec && n_in == 8) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(x + base));
      const float4 b = __ldg(reinterpret_cast<const float4*>(x + base + 4));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = j < n_in ? __ldg(x + base + j) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] -= c;

    if (n_in == 8) {
      float s1 = 0.f, q1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1 += v[j];
        q1 += v[j] * v[j];
        take(best[0], v[j], base + j);
      }
      float b2[4], b4[2];
      float s2 = 0.f, q2 = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        b2[k] = v[2 * k] + v[2 * k + 1];
        s2 += b2[k];
        q2 += b2[k] * b2[k];
        take(best[1], b2[k], base / 2 + k);
      }
      float s4 = 0.f, q4 = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        b4[k] = b2[2 * k] + b2[2 * k + 1];
        s4 += b4[k];
        q4 += b4[k] * b4[k];
        take(best[2], b4[k], base / 4 + k);
      }
      const float b8 = b4[0] + b4[1];
      take(best[3], b8, base / 8);
      sum[0] += s1; ssq[0] += q1;
      sum[1] += s2; ssq[1] += q2;
      sum[2] += s4; ssq[2] += q4;
      sum[3] += b8; ssq[3] += (double)b8 * b8;
    } else {
      // the ragged last group: only the blocks that fit in T count
      for (int j = 0; j < n_in; ++j) {
        sum[0] += v[j];
        ssq[0] += (double)v[j] * v[j];
        take(best[0], v[j], base + j);
      }
      for (int k = 0; 2 * k + 2 <= n_in; ++k) {
        const float b2 = v[2 * k] + v[2 * k + 1];
        sum[1] += b2;
        ssq[1] += (double)b2 * b2;
        take(best[1], b2, base / 2 + k);
      }
      if (n_in >= 4) {
        const float b4 = (v[0] + v[1]) + (v[2] + v[3]);
        sum[2] += b4;
        ssq[2] += (double)b4 * b4;
        take(best[2], b4, base / 4);
      }
    }

    if (with_cert) {
      // the three samples after the group, wrapping circularly at T
#pragma unroll
      for (int j = 8; j < 11; ++j) {
        int u = base + j;
        while (u >= nsamples) u -= nsamples;
        v[j] = __ldg(x + u) - c;
      }
      if (n_in < 8) {
        for (int j = n_in; j < 8; ++j) {
          int u = base + j;
          while (u >= nsamples) u -= nsamples;
          v[j] = __ldg(x + u) - c;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < n_in) {
          const float s2 = v[j] + v[j + 1];
          cm[0] = fmaxf(cm[0], s2);
          cm[1] = fmaxf(cm[1], s2 + v[j + 2]);
          cm[2] = fmaxf(cm[2], s2 + (v[j + 2] + v[j + 3]));
        }
      }
    }
  }

  double tot_sum[4], tot_ssq[4];
  Best tot_best[4];
  for (int k = 0; k < 4; ++k) {
    tot_sum[k] = block_sum(sum[k], sh_d);
    tot_ssq[k] = block_sum(ssq[k], sh_d);
    tot_best[k] = block_best(best[k], sh_f, sh_i);
  }
  float tot_cm[3];
  for (int k = 0; k < 3; ++k) tot_cm[k] = block_max(cm[k], sh_f);

  if (tid == 0) {
    const double t = (double)nsamples;
    const double m = tot_sum[0] / t;  // mean(x - c)
    const float m32 = (float)((double)c + m);  // the row mean in float32
    const double d = (double)c - (double)m32;  // x - m32 = (x - c) + d
    const double var = tot_ssq[0] / t - m * m;
    const double sd = sqrt(var > 0.0 ? var : 0.0);
    const float stdf = (float)sd;
    float best_snr = 0.f;
    int best_w = 0;
    long long best_p = 0;
    for (int k = 0; k < 4; ++k) {
      const int w = 1 << k;
      const double nb = (double)(nsamples / w);
      const double mean_w = tot_sum[k] / nb;
      const double var_w = tot_ssq[k] / nb - mean_w * mean_w;
      const double top = (double)tot_best[k].v + w * d;
      const float snr = (float)(top / sqrt(var_w > 0.0 ? var_w : 0.0));
      if (snr > best_snr) {
        best_snr = snr;
        best_w = w;
        best_p = tot_best[k].i * w;
      }
    }
    out[row] = (double)(float)((double)tot_best[0].v + d);
    out[rows + row] = (double)stdf;
    out[2 * rows + row] = (double)best_snr;
    out[3 * rows + row] = (double)best_w;
    out[4 * rows + row] = (double)best_p;
    if (with_cert) {
      float cert = -INFINITY;
      for (int k = 0; k < 3; ++k) {
        const int w = k + 2;
        const float s = (float)(((double)tot_cm[k] + w * d)
                                / ((double)stdf * sqrt((double)w)));
        cert = fmaxf(cert, s);
      }
      out[5 * rows + row] = (double)cert;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) of `device`; returns the
// cudaError_t of the launch (0 on success).  No synchronisation.
int score_launch(const float* plane, double* out, int rows, int nsamples,
                 int with_cert, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // float4 loads need every row start 16-byte aligned
  const bool vec = nsamples % 4 == 0 &&
                   reinterpret_cast<size_t>(plane) % 16 == 0;
  if (vec) {
    score_kernel<true><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        plane, out, rows, nsamples, with_cert);
  } else {
    score_kernel<false><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        plane, out, rows, nsamples, with_cert);
  }
  return (int)cudaGetLastError();
}

const char* score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The compile-time geometry, so the host checks it planned the same.
void score_geometry(int* threads, int* centre) {
  *threads = kThreads;
  *centre = kCentre;
}

}  // extern "C"
