// Direct-sweep incoherent dedispersion for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of pulsarutils_tpu/ops/pallas_dedisperse.py:
// _build_kernel_rows (pallas_call at :208, the default layout="rows") and
// _build_kernel (pallas_call at :265, layout="flat").  Both compute
//
//     out[d, t] = sum over c ascending of x[c, (t + off[d, c]) mod T]
//
// with x (nchan, T) float32, off (ndm, nchan) int32 and out (ndm, T) float32.
// Their 8-sublane row view, lane/sublane rotates and blends exist only
// because Mosaic forbids unaligned vector loads; a GPU reads unaligned
// shared memory directly, so none of that is carried over.
//
// What bounds it on an H100: the work is ndm*nchan*T float32 adds against at
// least 4*(nchan*T + ndm*T) bytes, about ndm*nchan/(4*(nchan+ndm)) adds per
// byte (86 at 514 trials x 1024 channels), far above the card's ~20 flop/byte
// balance point.  So it is bound by CUDA-core add issue, not by memory.
//
// Design.  Each block owns kTrialBlock trials x kTimeTile samples and keeps
// every output in a register accumulator: each output is ONE sequential
// float32 sum over the channels in ascending order, starting from zero, so
// the plane is bit-identical to the plain PyTorch version (no split over
// channels, no atomics, no tree reduction).  Channels are taken kChanBlock
// at a time.  The offsets arrive rebased (the host maps them to a signed
// form and subtracts their minimum, so a block's offsets do not straddle the
// wrap at T); the rebase constant is folded into the store index as
// store_shift.  Within a block of trials one channel's offsets differ by
// little (at most ~kTrialBlock + 1 samples on the plan's one-sample grid), so
// the block stages each channel's window [tile start + min offset, + tile +
// spread) in shared memory with circular indexing, and every add reads the
// window at its trial's relative offset.  Where the host finds the spread too
// large for the shared-memory budget (use_smem == 0), the same kernel reads
// the input straight from global memory instead.
//
// What limits this version: one shared-memory load per add.  Shared memory
// delivers one 32-lane load per clock per SM against four 32-lane adds, so
// the kernel runs at about a quarter of the add rate at best.  Reusing each
// loaded value across trials in registers is the next step.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 2;                     // samples per thread
constexpr int kTimeTile = kThreads * kPerThread;  // samples per block
constexpr int kTrialBlock = 32;                   // trials per block
constexpr int kChanBlock = 16;                    // channels per staging step

__global__ void __launch_bounds__(kThreads, 2)
dedisperse_kernel(const float* __restrict__ x, const int* __restrict__ off,
                  float* __restrict__ out, int nchan, int nsamples, int ndm,
                  int store_shift, int win, int use_smem) {
  extern __shared__ float window[];  // kChanBlock * win floats (smem branch)
  __shared__ __align__(16) int s_off[kChanBlock][kTrialBlock];
  __shared__ int s_base[kChanBlock];

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * kTimeTile;
  const int d0 = blockIdx.y * kTrialBlock;
  const int nd = min(kTrialBlock, ndm - d0);

  float acc[kTrialBlock][kPerThread];
#pragma unroll
  for (int d = 0; d < kTrialBlock; ++d)
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) acc[d][v] = 0.0f;

  for (int c0 = 0; c0 < nchan; c0 += kChanBlock) {
    const int nc = min(kChanBlock, nchan - c0);
    __syncthreads();  // the previous step's window and offsets are consumed
    for (int i = tid; i < kChanBlock * kTrialBlock; i += kThreads) {
      const int cc = i / kTrialBlock;
      const int dd = i % kTrialBlock;
      int value = 0;
      if (cc < nc) {
        // padding trials repeat the block's first: within the spread
        const int d = d0 + (dd < nd ? dd : 0);
        value = off[(size_t)d * nchan + c0 + cc];
      }
      s_off[cc][dd] = value;
    }
    __syncthreads();

    if (use_smem) {
      if (tid < kChanBlock) {
        int m = s_off[tid][0];
        for (int dd = 1; dd < kTrialBlock; ++dd) m = min(m, s_off[tid][dd]);
        s_base[tid] = m;
      }
      __syncthreads();
      for (int i = tid; i < kChanBlock * kTrialBlock; i += kThreads) {
        s_off[i / kTrialBlock][i % kTrialBlock] -= s_base[i / kTrialBlock];
      }
      for (int cc = 0; cc < nc; ++cc) {
        const float* row = x + (size_t)(c0 + cc) * nsamples;
        // one division per channel; the window then wraps by subtraction
        const int start = (int)(((long long)u0 + s_base[cc]) % nsamples);
        float* w = window + cc * win;
        for (int j = tid; j < win; j += kThreads) {
          int s = start + j;
          while (s >= nsamples) s -= nsamples;
          w[j] = __ldg(row + s);
        }
      }
      __syncthreads();
      for (int cc = 0; cc < nc; ++cc) {
        const float* w = window + cc * win + tid;
#pragma unroll
        for (int d4 = 0; d4 < kTrialBlock; d4 += 4) {
          const int4 r = *reinterpret_cast<const int4*>(&s_off[cc][d4]);
          const int rel[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int v = 0; v < kPerThread; ++v)
              acc[d4 + q][v] += w[rel[q] + v * kThreads];
        }
      }
    } else {
      for (int cc = 0; cc < nc; ++cc) {
        const float* row = x + (size_t)(c0 + cc) * nsamples;
#pragma unroll
        for (int dd = 0; dd < kTrialBlock; ++dd) {
          const int r = s_off[cc][dd];  // in [0, nsamples)
#pragma unroll
          for (int v = 0; v < kPerThread; ++v) {
            // u < nsamples + kTimeTile, so s < 2 * nsamples + kTimeTile
            int s = u0 + tid + v * kThreads - nsamples + r;
            while (s < 0) s += nsamples;
            while (s >= nsamples) s -= nsamples;
            acc[dd][v] += __ldg(row + s);
          }
        }
      }
    }
  }

#pragma unroll
  for (int dd = 0; dd < kTrialBlock; ++dd) {
    if (dd >= nd) break;
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) {
      const int u = u0 + tid + v * kThreads;
      if (u < nsamples) {
        int t = u + store_shift;
        if (t >= nsamples) t -= nsamples;
        out[(size_t)(d0 + dd) * nsamples + t] = acc[dd][v];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) of `device`; returns the
// cudaError_t of the launch (0 on success).  No synchronisation.
int dedisperse_launch(const float* x, const int* off, float* out, int nchan,
                      int nsamples, int ndm, int store_shift, int win,
                      int use_smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = use_smem ? (size_t)kChanBlock * win * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(dedisperse_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((nsamples + kTimeTile - 1) / kTimeTile,
                  (ndm + kTrialBlock - 1) / kTrialBlock);
  dedisperse_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, off, out, nchan, nsamples, ndm, store_shift, win, use_smem);
  return (int)cudaGetLastError();
}

const char* dedisperse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The compile-time tiling, so the host plans launches with the same numbers.
void dedisperse_geometry(int* trial_block, int* time_tile, int* chan_block) {
  *trial_block = kTrialBlock;
  *time_tile = kTimeTile;
  *chan_block = kChanBlock;
}

}  // extern "C"
