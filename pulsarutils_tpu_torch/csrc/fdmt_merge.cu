// FDMT merge passes for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels:
//
// * _build_merge_kernel (pulsarutils_tpu/ops/fdmt.py, pallas_call at :480),
//   one tree level:
//       out[r, t] = s[ih[r], (t + sh[r]) mod T] + s[il[r], (t + sl[r]) mod T]
//   (sh is nonzero only in the leaf level, whose parents are raw channels);
// * _build_merge4_kernel (pulsarutils_tpu/ops/fdmt.py, pallas_call at :565),
//   the last two deep levels fused: out[r, t] = (A + B) + (C + D),
//   A..D = s[idx_p[r], (t + s_p[r]) mod T] for the four composed parents of
//   compose_iterations;
// * _build_head_kernel (pulsarutils_tpu/ops/fdmt_resident.py, pallas_call
//   at :386), the first kHeadLevels levels in one pass with the
//   intermediate states held on chip (head_kernel below).
//
// with the state s (rows_in, T) float32, int32 tables and out (rows_out, T)
// float32.  The TPU kernels stitch 8-sublane row chunks and rotate lanes
// because Mosaic has no unaligned loads; a GPU reads any address, so each
// output sample simply reads its parents at (t + shift) mod T.
//
// What bounds it on an H100: one add per parent per output sample against
// 4 bytes read per parent sample and 4 written, far below the card's
// flop/byte balance.  So it is bound by memory traffic.  The least traffic
// reads each input state once and writes each output once.
//
// Design.  One block owns one output row and a tile of kTimeTile samples;
// its tables are read once per block (four or eight int32 words).  Threads
// take consecutive samples, so every load and store is coalesced except at
// the single wrap point of each parent row.  Rows of one band share their
// parents and run in neighbouring blocks, so the parents' second reads hit
// L2.  Each output is one add per level (high + low), or the pairwise
// (A + B) + (C + D) of the fused pass, exactly as the plain PyTorch
// version adds them, so the two agree bit for bit.  Parent rows at or
// beyond rows_valid are the zero channels above the band (the leaf level
// of a channel count that is not a power of two): they read as 0.0f, the
// value the plain version's padding holds.  The host reduces every shift
// into [0, T), so one conditional subtraction wraps an index.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                     // samples per thread
constexpr int kTimeTile = kThreads * kPerThread;  // samples per block
constexpr int kMaxRowBlocks = 65535;              // grid.y limit

__device__ __forceinline__ float parent(const float* __restrict__ s, int row,
                                        int rows_valid, int t, int shift,
                                        int nsamples) {
  if (row >= rows_valid) return 0.0f;
  int u = t + shift;
  if (u >= nsamples) u -= nsamples;
  return __ldg(s + (size_t)row * nsamples + u);
}

// tab: (4, rows_out) int32 = idx_high, idx_low, shift_high, shift_low
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ s, const int* __restrict__ tab,
             float* __restrict__ out, int rows_valid, int rows_out,
             int nsamples) {
  const int t0 = blockIdx.x * kTimeTile + threadIdx.x;
  for (int r = blockIdx.y; r < rows_out; r += gridDim.y) {
    const int ih = tab[r];
    const int il = tab[rows_out + r];
    const int sh = tab[2 * rows_out + r];
    const int sl = tab[3 * rows_out + r];
    float* o = out + (size_t)r * nsamples;
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) {
      const int t = t0 + v * kThreads;
      if (t < nsamples) {
        const float high = parent(s, ih, rows_valid, t, sh, nsamples);
        const float low = parent(s, il, rows_valid, t, sl, nsamples);
        o[t] = high + low;
      }
    }
  }
}

// tab: (8, rows_out) int32 = idx_0..idx_3, shift_0..shift_3
__global__ void __launch_bounds__(kThreads)
merge4_kernel(const float* __restrict__ s, const int* __restrict__ tab,
              float* __restrict__ out, int rows_valid, int rows_out,
              int nsamples) {
  const int t0 = blockIdx.x * kTimeTile + threadIdx.x;
  for (int r = blockIdx.y; r < rows_out; r += gridDim.y) {
    int idx[4], sft[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      idx[p] = tab[p * rows_out + r];
      sft[p] = tab[(4 + p) * rows_out + r];
    }
    float* o = out + (size_t)r * nsamples;
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) {
      const int t = t0 + v * kThreads;
      if (t < nsamples) {
        float x[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          x[p] = parent(s, idx[p], rows_valid, t, sft[p], nsamples);
        o[t] = (x[0] + x[1]) + (x[2] + x[3]);
      }
    }
  }
}

dim3 grid_for(int rows_out, int nsamples) {
  const int rb = rows_out < kMaxRowBlocks ? rows_out : kMaxRowBlocks;
  return dim3((nsamples + kTimeTile - 1) / kTimeTile, rb);
}

// ---------------------------------------------------------------------------
// The fused head: levels 0 .. kHeadLevels-1 in one launch.
//
// Level l only combines rows inside bands of 2^(l+1) channels, so the first
// kHeadLevels levels split into independent groups of kHeadGroup channels.
// Run level by level, those levels write and re-read ~75% of the
// transform's state traffic; the head reads the data once and writes only
// the last head level's rows.
//
// The TPU kernel keeps one group's whole sub-tree (~5 MB) in VMEM.  An SM
// has 227 KB, too little for one group's two ping-pong states (~250 rows at
// the 1024-channel headline) over a useful time tile.  So one group and one
// time tile go to a cluster of kCluster blocks, each holding its rows of
// every level in its shared memory.
//
// Ownership follows the bands.  Block b stages the kInRows = 16 input
// channels of band b, and owns every row of levels 0-3, whose sub-bands (2,
// 4, 8, 16 channels) lie inside band b: those levels read only the block's
// own rows, with no cluster barrier between them.  A row of levels 4-6
// (sub-bands of 2, 4, 8 bands) goes to the block that holds one of its two
// parents (the one with fewer rows so far), and reads the other parent, if
// another block holds it, through distributed shared memory: at most one
// remote read an output, the traffic that bounds these levels.  The host
// plans it all (ops/fdmt.py: HeadPlan): per level, block and row, the two
// parents as owner << 16 | local row and their shifts, and the last
// level's output rows; each level's barrier is the block's own where
// neither it nor the level before reads another block, else the cluster's
// (levels 4, 5, 6 and the end at the 1024-channel headline: four cluster
// barriers a tile).  A block copies its tables into shared memory at the
// start, beside the input it stages with cp.async (16 bytes a copy where
// T and the data's address allow it).
//
// Time: the cluster's output is samples [t0, t0 + tile) of the last head
// level.  Level l computes width[l] = tile + (shifts of the levels after
// it) columns, column j standing for time (t0 + j) mod T, and reads its
// parents at column j + shift; the input is staged over tile + halo
// columns, wrapping at T.  Shifts are the plan's own (nonnegative, no
// reduction mod T): a column offset inside the tile's window.
//
// Numerics: every output is high + low of the same two parent values as
// the per-level merge, so the head equals levels 0..kHeadLevels-1 of
// merge_kernel bit for bit.  Channels at or beyond rows_valid stage as 0.
//
// What bounds it: the data read once (nchan x T) and the last head level
// written once, against on-chip work of ~3 shared-memory accesses per
// intermediate sample.  The halo columns are recomputed by neighbouring
// tiles; the host takes the widest tile the shared-memory budget holds
// and runs the head only where the halo is at most the tile.

constexpr int kHeadLevels = 7;
constexpr int kHeadGroup = 1 << kHeadLevels;  // channels per group
constexpr int kCluster = 8;                   // blocks per group tile
constexpr int kHeadThreads = 512;
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kInRows = kHeadGroup / kCluster;  // input rows per block
constexpr int kSegment = 256;                   // columns per warp item
constexpr int kLaneCols = kSegment / 32;        // columns per lane per item

// The launch parameters, passed from the host as one int array in this
// order (fdmt_head_params_len gives its length).
struct HeadParams {
  int nsamples;    // T
  int rows_valid;  // data rows; group channels at or beyond read as 0
  int n_groups;
  int tiles;       // time tiles per group
  int tile;        // output samples per tile
  int stride;      // floats per row in shared memory (tile + halo, up to
                   // a multiple of 4), all of them staged
  int buf0_rows;   // rows of buffer 0 (the input, odd levels' outputs)
  int buf1_rows;   // rows of buffer 1 (even levels' outputs)
  int rows[kHeadLevels];   // most rows a block owns at level l (R_l)
  int width[kHeadLevels];  // columns level l computes
  int tab[kHeadLevels];    // offset of level l's (n_groups, kCluster, 4,
                           // R_l) table: ph, pl, sh, sl
  int counts;              // offset of the (kHeadLevels, n_groups,
                           // kCluster) rows each block owns
  int outs;                // offset of the (n_groups, kCluster, R_last)
                           // output rows of the last level's rows
  int barriers;            // bit l: a cluster barrier before level l
};

// Parent row `ref` (owner << 16 | local row) of the state the cluster
// holds in buffer `buf`, at `stride` floats a row.
__device__ __forceinline__ const float* parent_row(
    cooperative_groups::cluster_group& cluster, float* buf, int ref,
    int rank, int stride) {
  const int owner = ref >> 16;
  float* base = owner == rank ? buf : cluster.map_shared_rank(buf, owner);
  return base + (size_t)(ref & 0xffff) * stride;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kHeadThreads, 2)
head_kernel(const float* __restrict__ x, const int* __restrict__ tab,
            float* __restrict__ out, const HeadParams p) {
  extern __shared__ __align__(16) int smem_i[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / kCluster;
  const int g = cid / p.tiles;
  const int t0 = (cid - g * p.tiles) * p.tile;
  const int nsamples = p.nsamples;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // shared memory: this block's tables of every level, its row counts,
  // its output rows of the last level, then the two buffers
  int level_at[kHeadLevels];
  int meta = 0;
#pragma unroll
  for (int l = 0; l < kHeadLevels; ++l) {
    level_at[l] = meta;
    meta += 4 * p.rows[l];
  }
  constexpr int kLast = kHeadLevels - 1;
  int* counts = smem_i + meta;
  int* outs = counts + kHeadLevels;
  float* buf0 = reinterpret_cast<float*>(
      smem_i + ((meta + kHeadLevels + p.rows[kLast] + 3) & ~3));
  float* buf1 = buf0 + (size_t)p.buf0_rows * p.stride;

  // stage band `rank`'s input rows over the tile's window; 16 bytes a
  // copy where T and the data's address keep every piece aligned (t0 and
  // the row stride are multiples of 4)
  const bool wide = (nsamples & 3) == 0 &&
                    (reinterpret_cast<size_t>(x) & 15) == 0;
  for (int rr = warp; rr < kInRows; rr += kHeadWarps) {
    const int ch = g * kHeadGroup + rank * kInRows + rr;
    float* dst = buf0 + (size_t)rr * p.stride;
    if (ch >= p.rows_valid) {
      for (int j = lane; j < p.stride; j += 32) dst[j] = 0.0f;
      continue;
    }
    const float* src = x + (size_t)ch * nsamples;
    if (t0 + p.stride <= 2 * nsamples) {
      // at most one wrap: two contiguous pieces
      const int first = min(p.stride, nsamples - t0);
      if (wide) {
        for (int j = 4 * lane; j < first; j += 128)
          cp_async16(dst + j, src + t0 + j);
        for (int j = first + 4 * lane; j < p.stride; j += 128)
          cp_async16(dst + j, src + (t0 + j - nsamples));
      } else {
        for (int j = lane; j < first; j += 32)
          cp_async4(dst + j, src + t0 + j);
        for (int j = first + lane; j < p.stride; j += 32)
          cp_async4(dst + j, src + (t0 + j - nsamples));
      }
    } else {  // a window longer than T wraps more than once
      for (int j = lane; j < p.stride; j += 32)
        cp_async4(dst + j, src + (t0 + j) % nsamples);
    }
  }
#pragma unroll
  for (int l = 0; l < kHeadLevels; ++l) {
    const int* src = tab + p.tab[l] + (size_t)(g * kCluster + rank) * 4 *
                                          p.rows[l];
    for (int i = threadIdx.x; i < 4 * p.rows[l]; i += kHeadThreads)
      smem_i[level_at[l] + i] = __ldg(src + i);
  }
  if (threadIdx.x < kHeadLevels)
    counts[threadIdx.x] = __ldg(
        tab + p.counts + (threadIdx.x * p.n_groups + g) * kCluster + rank);
  for (int i = threadIdx.x; i < p.rows[kLast]; i += kHeadThreads)
    outs[i] = __ldg(tab + p.outs +
                    (size_t)(g * kCluster + rank) * p.rows[kLast] + i);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

#pragma unroll
  for (int l = 0; l < kHeadLevels; ++l) {
    if (l > 0) {
      // the level before is complete wherever this level reads it, and no
      // block still reads the rows this level overwrites
      if ((p.barriers >> l) & 1)
        cluster.sync();
      else
        __syncthreads();
    }
    float* src = (l & 1) ? buf1 : buf0;
    float* dst = (l & 1) ? buf0 : buf1;
    const int rows = p.rows[l];
    const int width = p.width[l];
    const int mine = counts[l];
    const int nseg = (width + kSegment - 1) / kSegment;
    const int* tl = smem_i + level_at[l];
    for (int item = warp; item < mine * nseg; item += kHeadWarps) {
      const int rl = item / nseg;
      const int j0 = (item - rl * nseg) * kSegment;
      const int j1 = min(j0 + kSegment, width);
      const float* high =
          parent_row(cluster, src, tl[rl], rank, p.stride) + tl[2 * rows + rl];
      const float* low = parent_row(cluster, src, tl[rows + rl], rank,
                                    p.stride) + tl[3 * rows + rl];
      // every parent load of the item is in flight before the first store
      // (a store may alias a parent as far as the compiler knows, and a
      // parent in another block's shared memory is a long-latency load)
      float sum[kLaneCols];
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) {
        const int j = j0 + lane + 32 * k;
        if (j < j1) {
          const float h = high[j];
          const float lo = low[j];
          sum[k] = h + lo;
        }
      }
      float* o;
      int end = j1;
      if (l == kLast) {
        o = out + (size_t)outs[rl] * nsamples + t0;
        end = min(j1, nsamples - t0);  // the last tile is partial
      } else {
        o = dst + (size_t)rl * p.stride;
      }
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) {
        const int j = j0 + lane + 32 * k;
        if (j < end) o[j] = sum[k];
      }
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

extern "C" {

// Both launch on `stream` (a cudaStream_t) of `device` and return the
// cudaError_t of the launch (0 on success).  No synchronisation.
int fdmt_merge_launch(const float* s, const int* tab, float* out,
                      int rows_valid, int rows_out, int nsamples, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<grid_for(rows_out, nsamples), kThreads, 0,
                 (cudaStream_t)stream>>>(s, tab, out, rows_valid, rows_out,
                                         nsamples);
  return (int)cudaGetLastError();
}

int fdmt_merge4_launch(const float* s, const int* tab, float* out,
                       int rows_valid, int rows_out, int nsamples, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  merge4_kernel<<<grid_for(rows_out, nsamples), kThreads, 0,
                  (cudaStream_t)stream>>>(s, tab, out, rows_valid, rows_out,
                                          nsamples);
  return (int)cudaGetLastError();
}

int fdmt_head_params_len() { return (int)(sizeof(HeadParams) / sizeof(int)); }

// `params` is a host array of fdmt_head_params_len() ints in HeadParams'
// order; `tab` the device int32 tables it indexes.  Launches one cluster
// per (group, time tile).
int fdmt_head_launch(const float* x, const int* tab, float* out,
                     const int* params, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  HeadParams p;
  memcpy(&p, params, sizeof(HeadParams));
  int meta = kHeadLevels + p.rows[kHeadLevels - 1];
  for (int l = 0; l < kHeadLevels; ++l) meta += 4 * p.rows[l];
  const size_t smem =
      sizeof(int) * (((size_t)meta + 3) & ~(size_t)3) +
      (size_t)(p.buf0_rows + p.buf1_rows) * p.stride * sizeof(float);
  err = cudaFuncSetAttribute(head_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)p.n_groups * p.tiles * kCluster;
  head_kernel<<<blocks, kHeadThreads, smem, (cudaStream_t)stream>>>(
      x, tab, out, p);
  return (int)cudaGetLastError();
}

// The compile-time head shape: levels, channels per group, blocks per
// cluster.
void fdmt_head_geometry(int* levels, int* group, int* cluster) {
  *levels = kHeadLevels;
  *group = kHeadGroup;
  *cluster = kCluster;
}

const char* fdmt_merge_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The compile-time tiling, so the host plans launches with the same numbers.
void fdmt_merge_geometry(int* time_tile, int* max_row_blocks) {
  *time_tile = kTimeTile;
  *max_row_blocks = kMaxRowBlocks;
}

}  // extern "C"
