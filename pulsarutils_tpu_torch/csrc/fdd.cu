// Fourier-domain dedispersion: the phasor build and the rotate-accumulate
// recurrence of one superblock, fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of pulsarutils_tpu/ops/fourier_pallas.py:
// _build_fdd_kernel (pallas_call at :159) together with the phasor build
// the JAX package runs around it in XLA (pulsarutils_tpu/ops/fourier.py,
// limb_phase and `sp * rot0`).  For one superblock of trials it computes,
// per rfft bin f,
//
//   out[n, f] = sum_c u[c, f] * step[c, f]^n        n = 0 .. superblock-1
//   u[c, f]   = spec[c, f] * exp(2 pi i f A_c)      (the anchor phase)
//   step[c, f] = exp(2 pi i f B_c)                  (the per-trial ramp)
//
// complex64 stored as interleaved float32 (re, im) pairs: float2.  The
// phase slopes arrive as integer limbs: A_c in three 12-bit limbs (3,
// nchan) and B_c in four (4, nchan), int32.  rot_0 = u, rot_{n+1} =
// rot_n * step, channels summed in ascending order from zero.
//
// The phasors are built in registers with the arithmetic of the plain
// version (ops/fourier.py: limb_phase): the limb products k * m are formed
// as unsigned 32-bit products and masked (they wrap mod 2^32, a multiple of
// each mask's modulus: the values of the int64-and-mask form and of the JAX
// package's wrapping int32 products); the float32 sum runs in the plain
// version's order with __fmul_rn / __fadd_rn, so nothing is contracted
// into an FMA; th * 2pi is one float32 multiply, then sincosf (never the
// __sincosf intrinsic; no fast-math).  The plain version
// (ops/fourier_cuda.py: fdd_fused_plain) sums channel
// blocks and adds them, and its cos/sin are PyTorch's, so the two agree to
// float32 tolerance, not bit for bit.
//
// What bounds it on an H100: per (trial, channel, bin) one complex multiply
// (2 FMUL + 2 FFMA) and one complex add (2 FADD): 6 float32 instructions
// against 8 bytes of spectrum per (channel, bin) reused by every trial; the
// phasor build adds about 80 instructions per (channel, bin), once.  Issue
// rate, not memory.
//
// Design.  One thread per bin, bins across the block (coalesced float2
// loads), all channels in one launch: the 64 trials' accumulators and the
// rotation live in registers, so nothing is re-derived and no accumulator
// goes through device memory between channel blocks.  The limbs are staged
// in shared memory kLimbChunk channels at a time (every thread of a block
// reads the same channel's limbs).  The next channel's spectrum is loaded
// before the current channel's trials run.  A superblock above 64 trials
// runs as several trial blocks (blockIdx.y), each re-deriving its start
// rot_{n0} by n0 multiplications in the plain version's order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTrials = 64;       // accumulators held in registers per thread
constexpr int kLimbChunk = 256;   // channels of limbs staged at once
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(2 pi i k A) from the limbs m0..m2 (and m3 when four), as limb_phase.
template <int kLimbs>
__device__ __forceinline__ float2 limb_phasor(unsigned k, float kf,
                                              const int* m) {
  float th = __fmul_rn(__uint2float_rn((k * (unsigned)m[0]) & 0xFFFu),
                       1.0f / 4096.0f);
  th = __fadd_rn(th, __fmul_rn(__uint2float_rn((k * (unsigned)m[1]) &
                                               0xFFFFFFu),
                               1.0f / 16777216.0f));
  th = __fadd_rn(th, __fmul_rn(__fmul_rn(kf, (float)m[2]),
                               0x1p-36f));
  if (kLimbs > 3) {
    // k * m3 / 2^48 < 2^-16: no wrap possible, float32 is ample
    th = __fadd_rn(th, __fmul_rn(__fmul_rn(kf, (float)m[3]),
                                 0x1p-48f));
  }
  float s, c;
  sincosf(__fmul_rn(th, kTwoPi), &s, &c);
  return make_float2(c, s);
}

__global__ void __launch_bounds__(kThreads)
fdd_kernel(const float2* __restrict__ spec, const int* __restrict__ anchor,
           const int* __restrict__ step, float2* __restrict__ out, int nchan,
           int nbin, int superblock) {
  __shared__ int s_limb[kLimbChunk][8];  // 3 anchor, 4 step limbs, 1 pad
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const bool live = f < nbin;
  const unsigned k = static_cast<unsigned>(f);
  const float kf = static_cast<float>(f);
  const int n0 = blockIdx.y * kTrials;
  const int nt = min(kTrials, superblock - n0);
  const size_t stride = (size_t)nbin;

  float2 acc[kTrials];
#pragma unroll
  for (int n = 0; n < kTrials; ++n) acc[n] = make_float2(0.f, 0.f);

  for (int c0 = 0; c0 < nchan; c0 += kLimbChunk) {
    const int nc = min(kLimbChunk, nchan - c0);
    __syncthreads();  // the previous chunk's limbs are consumed
    for (int i = threadIdx.x; i < 7 * nc; i += kThreads) {
      const int l = i / nc;
      const int c = i - l * nc;
      s_limb[c][l] = l < 3 ? __ldg(anchor + (size_t)l * nchan + c0 + c)
                           : __ldg(step + (size_t)(l - 3) * nchan + c0 + c);
    }
    __syncthreads();
    if (!live) continue;
    float2 sp_next = __ldg(spec + (size_t)c0 * stride + f);
    for (int cc = 0; cc < nc; ++cc) {
      const float2 sp = sp_next;
      if (cc + 1 < nc) sp_next = __ldg(spec + (size_t)(c0 + cc + 1) * stride + f);
      const int* m = s_limb[cc];
      float2 rot = cmul(sp, limb_phasor<3>(k, kf, m));
      const float2 st = limb_phasor<4>(k, kf, m + 3);
      for (int n = 0; n < n0; ++n) rot = cmul(rot, st);
#pragma unroll
      for (int n = 0; n < kTrials; ++n) {
        acc[n].x += rot.x;
        acc[n].y += rot.y;
        rot = cmul(rot, st);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int n = 0; n < kTrials; ++n) {
    if (n < nt) out[(size_t)(n0 + n) * stride + f] = acc[n];
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) of `device`; returns the
// cudaError_t of the launch (0 on success).  No synchronisation.
int fdd_launch(const void* spec, const int* anchor, const int* step,
               void* out, int nchan, int nbin, int superblock, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nbin + kThreads - 1) / kThreads,
                  (superblock + kTrials - 1) / kTrials);
  fdd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(spec), anchor, step,
      static_cast<float2*>(out), nchan, nbin, superblock);
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
