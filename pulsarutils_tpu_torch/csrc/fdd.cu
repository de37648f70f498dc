// Fourier-domain dedispersion: the rotate-accumulate recurrence, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of pulsarutils_tpu/ops/fourier_pallas.py:
// _build_fdd_kernel (pallas_call at :159).  For one superblock of trials it
// computes, per rfft bin f,
//
//   out[n, f] (+)= sum_c u[c, f] * step[c, f]^n      n = 0 .. superblock-1
//
// with u = spec * rot0 (the channel spectrum at the superblock's anchor
// phase) and step the constant per-trial phase ramp, complex64 stored as
// interleaved float32 (re, im) pairs: float2.  rot_0 = u, rot_{n+1} =
// rot_n * step, channels summed in ascending order; with `accumulate` the
// channel sum is added to the output already there (acc + sum, as the JAX
// package adds a channel block's contribution to its accumulator).  The
// plain PyTorch version (ops/fourier_cuda.py: fdd_superblock_spectra_plain)
// sums channels in PyTorch's order, so the two agree to float32 tolerance.
//
// What bounds it on an H100: per (trial, channel, bin) one complex multiply
// (2 FMUL + 2 FFMA) and one complex add (2 FADD): 6 float32 instructions
// against 16 bytes of input per (channel, bin) reused by every trial — the
// instruction issue rate, not memory, once a superblock holds more than a
// few trials.
//
// Design.  One thread per bin, bins across the block (coalesced float2
// loads); the rotation state and TRIAL_BLOCK trials' accumulators live in
// registers, not in global memory per trial.  A superblock larger than
// TRIAL_BLOCK runs as several trial blocks (blockIdx.y); each re-derives
// its starting phasor rot_{n0} from u and step by n0 repeated
// multiplications, in the plain version's order — extra multiplies
// instead of a superblock of accumulators (64 trials would need 128
// registers a thread).  The next channel's u and step are loaded before
// the current channel's trials run, to hide the load latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTrials = 32;  // accumulators held in registers per thread

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kThreads)
fdd_kernel(const float2* __restrict__ u, const float2* __restrict__ step,
           float2* __restrict__ out, int nchan, int nbin, int superblock,
           int accumulate) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= nbin) return;
  const int n0 = blockIdx.y * kTrials;
  const int nt = min(kTrials, superblock - n0);
  const size_t stride = (size_t)nbin;

  float2 acc[kTrials];
#pragma unroll
  for (int k = 0; k < kTrials; ++k) acc[k] = make_float2(0.f, 0.f);

  float2 u_next = __ldg(u + f);
  float2 s_next = __ldg(step + f);
  for (int c = 0; c < nchan; ++c) {
    const float2 uc = u_next;
    const float2 sc = s_next;
    if (c + 1 < nchan) {
      u_next = __ldg(u + (size_t)(c + 1) * stride + f);
      s_next = __ldg(step + (size_t)(c + 1) * stride + f);
    }
    float2 rot = uc;
    for (int k = 0; k < n0; ++k) rot = cmul(rot, sc);
#pragma unroll
    for (int k = 0; k < kTrials; ++k) {
      acc[k].x += rot.x;
      acc[k].y += rot.y;
      rot = cmul(rot, sc);
    }
  }
#pragma unroll
  for (int k = 0; k < kTrials; ++k) {
    if (k < nt) {
      float2* o = out + (size_t)(n0 + k) * stride + f;
      if (accumulate) {
        const float2 prev = *o;
        *o = make_float2(prev.x + acc[k].x, prev.y + acc[k].y);
      } else {
        *o = acc[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) of `device`; returns the
// cudaError_t of the launch (0 on success).  No synchronisation.
int fdd_launch(const void* u, const void* step, void* out, int nchan,
               int nbin, int superblock, int accumulate, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nbin + kThreads - 1) / kThreads,
                  (superblock + kTrials - 1) / kTrials);
  fdd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(u), static_cast<const float2*>(step),
      static_cast<float2*>(out), nchan, nbin, superblock, accumulate);
  return (int)cudaGetLastError();
}

const char* fdd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The compile-time geometry, so the host checks it planned the same.
void fdd_geometry(int* threads, int* trial_block) {
  *threads = kThreads;
  *trial_block = kTrials;
}

}  // extern "C"
