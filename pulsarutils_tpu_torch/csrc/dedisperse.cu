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
// Shared memory delivers one 32-lane load per clock per SM against four
// 32-lane adds, so a design with one shared-memory load per add cannot pass
// a quarter of that bound.
//
// Design.  Each block owns D trials (a template parameter: 8 for a launch of
// at most 8 trials, else 16; the host chooses) x kTile samples, and keeps
// every output in a register accumulator: each output is ONE sequential
// float32 sum over the channels in ascending order, starting from zero, so
// the plane is bit-identical to the plain PyTorch version (no split over
// channels, no atomics, no tree reduction).
//
// - Reuse across trials.  On the plan's one-sample grid a channel's offset
//   moves by at most about one sample from one trial to the next, so
//   neighbouring trials often read the same window position.  The host
//   marks, per (trial block, channel), the trials whose offset differs from
//   the previous trial's (a warp-uniform bitmask; trial 0 always set).  A
//   thread loads its kPerThread window values only at a marked trial and
//   otherwise adds the values it holds in registers.  The marks come from the offsets
//   passed, so rows in any order (the hybrid's rescore) stay exact; only the
//   share of loads changes.
// - Asynchronous staging.  Channels are taken kChanBlock at a time through a
//   ring of three shared-memory stages filled with cp.async: the windows
//   [tile start + the channel's least offset, + tile + the channel's
//   largest relative offset in the block) and the block's per-channel plan
//   rows.  Each channel copies its own span, so a launch whose window
//   bounds many blocks (the hybrid's rows planned on the card, sized by the
//   whole plan's spread) copies what each block needs, not the bound.  A
//   window that crosses T is copied in two pieces (no wrap per element).
//   One barrier per channel block: stage s+2 is issued after the barrier
//   that ends every thread's reading of stage s-1, which used the same
//   buffer.
// - Where the host finds the spread too large for the shared-memory budget
//   (use_smem == 0), the same kernel reads the input straight from global
//   memory with the same marks.
//
// The plan rows: meta[(blk * nchan + c) * (D + 3) + ...] = {base, mask, top,
// rel[0 .. D)}: the channel's least rebased offset in the block, the change
// mask (bit d for trial d), the largest of rel (the channel's span beyond
// the tile), and each trial's offset minus base.  The offsets
// arrive rebased (the host maps them to a signed form and subtracts their
// minimum, so they lie in [0, T)); the rebase constant is folded into the
// store index as store_shift.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 8;                   // samples a thread
constexpr int kTile = kThreads * kPerThread;    // samples a block
constexpr int kChanBlock = 4;                   // channels a stage
constexpr int kStages = 3;

// plan ints per (trial block, channel): base, mask, top, d relative offsets
__host__ __device__ constexpr int meta_width(int d) { return d + 3; }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// trials_on_x: trial blocks along the grid's x and time tiles along y
// (the blocks of one tile run together and share its input windows in
// L2), else the other way round (when the tiles outnumber grid.y's 65535).
template <int D>
__global__ void __launch_bounds__(kThreads)
dedisperse_kernel(const float* __restrict__ x, const int* __restrict__ meta,
                  float* __restrict__ out, int nchan, int nsamples, int ndm,
                  int store_shift, int win, int use_smem, int trials_on_x) {
  static_assert(D <= 32, "one 32-bit change mask a channel");
  constexpr int P = kPerThread;
  constexpr int CB = kChanBlock;
  constexpr int M = meta_width(D);
  extern __shared__ __align__(16) int smem[];
  int* s_meta = smem;                                  // [kStages][CB][M]
  float* s_win = reinterpret_cast<float*>(smem + kStages * CB * M);
                                                       // [kStages][CB][win]

  const int tid = threadIdx.x;
  const int blk = trials_on_x ? blockIdx.x : blockIdx.y;
  const int u0 = (trials_on_x ? blockIdx.y : blockIdx.x) * kTile;
  const int d0 = blk * D;
  const int nd = min(D, ndm - d0);
  const int* gmeta = meta + (size_t)blk * nchan * M;
  const int nsteps = (nchan + CB - 1) / CB;

  float acc[D][P];
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int v = 0; v < P; ++v) acc[d][v] = 0.0f;

  // Queue the copies of channel block `step` into its stage.
  auto stage = [&](int step) {
    const int buf = step % kStages;
    const int c0 = step * CB;
    const int nc = min(CB, nchan - c0);
    const int* gm = gmeta + (size_t)c0 * M;
    int* sm = s_meta + buf * CB * M;
    for (int i = tid; i < nc * M; i += kThreads) cp_async4(sm + i, gm + i);
    if (!use_smem) return;
    // each channel's least offset and its own span: the tile plus its
    // largest relative offset in this block (at most win, the launch's)
    int base[CB], span[CB];
#pragma unroll
    for (int cc = 0; cc < CB; ++cc) {
      base[cc] = cc < nc ? __ldg(gm + cc * M) : 0;
      span[cc] = cc < nc ? min(win, kTile + __ldg(gm + cc * M + 2)) : 0;
    }
    float* sw = s_win + (size_t)buf * CB * win;
#pragma unroll
    for (int cc = 0; cc < CB; ++cc) {
      if (cc >= nc) break;
      const float* row = x + (size_t)(c0 + cc) * nsamples;
      int start = u0 + base[cc];  // u0 < T and base < T
      if (start >= nsamples) start -= nsamples;
      const int n = span[cc];
      const int n1 = min(n, nsamples - start);  // the piece before T
      float* w = sw + cc * win;
      for (int j = tid; j < n1; j += kThreads) cp_async4(w + j, row + start + j);
      // the rest from the row's start (past T again only when n > T)
      for (int j = n1 + tid; j < n; j += kThreads) {
        int i = j - n1;
        while (i >= nsamples) i -= nsamples;
        cp_async4(w + j, row + i);
      }
    }
  };

  stage(0);
  cp_async_commit();
  if (nsteps > 1) stage(1);
  cp_async_commit();

  float cur[P];
#pragma unroll
  for (int v = 0; v < P; ++v) cur[v] = 0.0f;

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_all_but_one();  // this thread's copies of stage s landed
    __syncthreads();              // everyone's; and stage s-1 is consumed
    if (s + 2 < nsteps) stage(s + 2);
    cp_async_commit();            // possibly empty: keeps the group count

    const int buf = s % kStages;
    const int c0 = s * CB;
    const int nc = min(CB, nchan - c0);
    const int* sm = s_meta + buf * CB * M;
    if (use_smem) {
      const float* sw = s_win + (size_t)buf * CB * win + tid;
      for (int cc = 0; cc < nc; ++cc) {
        const int* m = sm + cc * M;
        const unsigned mask = static_cast<unsigned>(m[1]);
        const float* w = sw + cc * win;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if ((mask >> d) & 1u) {
            const float* p = w + m[3 + d];
#pragma unroll
            for (int v = 0; v < P; ++v) cur[v] = p[v * kThreads];
          }
#pragma unroll
          for (int v = 0; v < P; ++v) acc[d][v] += cur[v];
        }
      }
    } else {
      for (int cc = 0; cc < nc; ++cc) {
        const int* m = sm + cc * M;
        const unsigned mask = static_cast<unsigned>(m[1]);
        const float* row = x + (size_t)(c0 + cc) * nsamples;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if ((mask >> d) & 1u) {
            const int r = m[0] + m[3 + d];  // in [0, 2T)
#pragma unroll
            for (int v = 0; v < P; ++v) {
              // u < T + tile, so the index is below 3T + tile
              int i = u0 + tid + v * kThreads + r;
              while (i >= nsamples) i -= nsamples;
              cur[v] = __ldg(row + i);
            }
          }
#pragma unroll
          for (int v = 0; v < P; ++v) acc[d][v] += cur[v];
        }
      }
    }
  }

#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d >= nd) break;
#pragma unroll
    for (int v = 0; v < P; ++v) {
      const int u = u0 + tid + v * kThreads;
      if (u < nsamples) {
        int t = u + store_shift;
        if (t >= nsamples) t -= nsamples;
        out[(size_t)(d0 + d) * nsamples + t] = acc[d][v];
      }
    }
  }
}

template <int D>
size_t smem_bytes(int win, int use_smem) {
  return sizeof(int) * (size_t)kStages * kChanBlock *
         (meta_width(D) + (use_smem ? win : 0));
}

template <int D>
int launch(const float* x, const int* meta, float* out, int nchan,
           int nsamples, int ndm, int store_shift, int win, int use_smem,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(win, use_smem);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dedisperse_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int ntiles = (nsamples + kTile - 1) / kTile;
  const int nblocks = (ndm + D - 1) / D;
  const int trials_on_x = ntiles <= 65535;
  const dim3 grid(trials_on_x ? nblocks : ntiles,
                  trials_on_x ? ntiles : nblocks);
  dedisperse_kernel<D><<<grid, kThreads, smem, stream>>>(
      x, meta, out, nchan, nsamples, ndm, store_shift, win, use_smem,
      trials_on_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) of `device`; returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for a
// trial block that was not compiled.  No synchronisation.
int dedisperse_launch(const float* x, const int* meta, float* out, int nchan,
                      int nsamples, int ndm, int store_shift, int win,
                      int use_smem, int trial_block, int device,
                      void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (trial_block) {
    case 8:
      return launch<8>(x, meta, out, nchan, nsamples, ndm, store_shift, win,
                       use_smem, s);
    case 16:
      return launch<16>(x, meta, out, nchan, nsamples, ndm, store_shift, win,
                        use_smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* dedisperse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The compiled tiling, so the host plans launches with the same numbers.
void dedisperse_geometry(int* time_tile, int* chan_block, int* stages) {
  *time_tile = kTile;
  *chan_block = kChanBlock;
  *stages = kStages;
}

}  // extern "C"
