// K4: fused CVA Monte Carlo — log-space GBM exposure walk over n_grid nodes.
//
// Replaces mctpu/kernels/cva.py::_cva_kernel (its pallas_call in
// _pallas_partials).  Per simulation block b and iteration i the stream is
// reseeded with (seed, (off + b) * iters + i) in int32 wrap; tile element e
// walks the grid in pairs, pair jj drawing Philox block (e, jj, 0, 0) whose
// cosine branch drives step 2jj and sine branch step 2jj+1 (an odd grid
// takes the cosine branch of pair n_grid/2 last).  At node j the netted
// exposure is max(sum_m w_m BS_hastings(S_j, k_m, T - t_j), 0) (intrinsic at
// the last node), the default leg adds dp_j * ee_j (or the wrong-way hazard
// mass), and the per-node exposure sum feeds the EE profile.  The walk state
// is the log-spot, f32 or a double-single (hi, lo) pair under F32_DS: a
// product of 500 f32 expf would compound its rounding.  The antithetic
// mirror replays the same stream with the sign flipped.
//
// Bound on the H100: arithmetic and latency.  Per path-step: one expf for
// the spot, two Hastings CDFs (an expf and an IEEE divide each) per option,
// half a Philox block and Box-Muller, and a serial dependence from node to
// node.  Design: split.  layout_for keeps the TPU's few wide simulation
// blocks (32 of 256 rows at 2^20 paths), and one CUDA block each would
// leave 100 of the 132 SMs idle with a serial walk of 128 paths a thread.
// So each simulation block's rows are cut into slices of SLICE_ROWS rows,
// one CUDA block (256 threads) per (block, slice): 2048 CUDA blocks at 2^20
// paths.  A slice walks its elements as the unsplit walk (element e = row *
// 128 + lane under (seed, (off + b) * iters + i)), one thread per element
// striding over the slice, so every path's draws and node values are
// unchanged.  The EE profile is reduced per node by a fixed warp-shuffle
// tree and Kahan-added by lane 0 into its warp's own slot; a slice writes
// per iteration its (sum cva, sum cva^2) reduced over the block
// (mct::block_row) and at the end its profile row (the warps' slots in
// order), and cva_fold_kernel adds the slices in order (mct::slice_fold:
// the iteration sums Kahan-carried under KAHAN).  No atomics: the order
// depends on the plan alone.  Node tables and profile slots live in shared
// memory when they fit (92 bytes a node: 46 KB at 500 nodes, four CUDA
// blocks an SM), otherwise in global memory, with the grid capped at the
// blocks the card holds and each CUDA block taking (block, slice) items in
// turn.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int N_TABLES = 7;  // dp, c1, isig_bs, vsig, disc, mu, isig
constexpr size_t SMEM_LIMIT = 96 * 1024;

struct Ctx {
  const float* dp;
  const float* c1;
  const float* isig_bs;
  const float* vsig;
  const float* disc;
  const float* mu;
  const float* isig;
  const float* strikes;
  const float* weights;
  const float* log_k;
  int n_options, g;
  float lgd, drift, vol, lam, bw, dt, log_s0;
};

// Netted exposure at node j from the walk state (mctpu/kernels/cva.py,
// _exposure_log); lo is the double-single low word, added after the strike
// subtraction so its bits reach d1.
template <bool DS>
__device__ __forceinline__ float exposure(const Ctx& cx, int j, float s,
                                          float log_s, float lo) {
  const bool last = j == cx.g - 1;
  float value = 0.0f;
  for (int m = 0; m < cx.n_options; ++m) {
    const float km = __ldg(cx.strikes + m);
    float vm;
    if (last) {
      vm = fmaxf(s - km, 0.0f);
    } else {
      float d1 = (log_s - __ldg(cx.log_k + m) + cx.c1[j]) * cx.isig_bs[j];
      if (DS) d1 = d1 + lo * cx.isig_bs[j];
      const float d2 = d1 - cx.vsig[j];
      vm = s * mct::norm_cdf_hastings(d1) -
           km * cx.disc[j] * mct::norm_cdf_hastings(d2);
    }
    const float term = __ldg(cx.weights + m) * vm;
    value = (m == 0) ? term : value + term;
  }
  return fmaxf(value, 0.0f);
}

// One walk of tile element e; returns its default leg lgd * sum_j dp_j ee_j
// and adds half_w * (warp sum of ee_j) into the warp's profile slots.
template <bool KAHAN, bool DS, bool WWR>
__device__ float walk(const Ctx& cx, mct::Key key, uint32_t e, float sgn,
                      float half_w, float* wprof, int lane) {
  float hi = cx.log_s0, lo = 0.0f, surv = 1.0f, acc = 0.0f;
  auto step = [&](int j, float z) {
    const float inc = cx.drift + cx.vol * (sgn * z);
    float s, log_rel;
    if (DS) {
      mct::ds_add(hi, lo, inc);
      s = expf(hi) * (1.0f + lo);
      log_rel = (hi - cx.log_s0) + lo;
    } else {
      hi = hi + inc;
      s = expf(hi);
      log_rel = hi - cx.log_s0;
    }
    const float ee = exposure<DS>(cx, j, s, hi, lo);
    float dpj;
    if (WWR) {  // _wwr_hazard_step: Hull-White hazard, cancellation-free mass
      const float zstd = (log_rel - cx.mu[j]) * cx.isig[j];
      const float h = cx.lam * expf(cx.bw * zstd - 0.5f * cx.bw * cx.bw);
      const float y = h * cx.dt;
      const float series =
          y * (1.0f + y * (-0.5f + y * MCT_F32(1.0 / 6.0)));
      dpj = surv * ((y < MCT_F32(0.01)) ? series : 1.0f - expf(-y));
      surv = surv - dpj;
    } else {
      dpj = cx.dp[j];
    }
    acc = acc + dpj * ee;
    float r = ee;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      r = __fadd_rn(r, __shfl_down_sync(0xffffffffu, r, o));
    }
    if (lane == 0) {
      float* slot = wprof + 2 * j;
      const float row = __fmul_rn(half_w, r);
      if (KAHAN) {  // the TPU kernel's per-lane Kahan form, slot = (sum, comp)
        const float y = __fsub_rn(row, slot[1]);
        const float t = __fadd_rn(slot[0], y);
        slot[1] = __fsub_rn(__fsub_rn(t, slot[0]), y);
        slot[0] = t;
      } else {
        slot[0] = __fadd_rn(slot[0], row);
      }
    }
  };
  mct::walk_pairwise(key, e, cx.g, step);
  return cx.lgd * acc;
}

// Rows of a slice: 2048 CUDA blocks at 2^20 paths (32 x 256 rows), 3.9
// waves of the 528 the card holds at 500 nodes (four an SM by shared
// memory); each thread walks 2 elements an iteration.  8-row slices (1024
// CUDA blocks, 4 elements a thread) took 2-3% longer at 500 nodes on an
// H100 (tools/time_redesign.py, see PERF.md).
constexpr int SLICE_ROWS = 4;

size_t smem_need(int g) {
  return (static_cast<size_t>(N_TABLES) + 2 * WARPS) * g * sizeof(float);
}

// The split launch: its slices a simulation block, (block, slice) items and
// CUDA blocks, whether tables and profile slots sit in shared memory, and
// its scratch in floats: the slices' iteration sums [B][iters][S][2] and
// profile rows [B][S][g], then, past shared memory, per CUDA block of the
// grid its profile slots [WARPS][g][2].
struct Split {
  int slices, items, grid;
  bool use_smem;
  size_t total;
};

using SliceFn = void (*)(const float*, const float*, const float*, int, int,
                         uint32_t, uint32_t, int, int, int, int, int, float*);

template <bool ANTI, bool KAHAN, bool DS, bool WWR>
__global__ void __launch_bounds__(THREADS)
    cva_slice_kernel(const float* __restrict__ scal,
                     const float* __restrict__ opts,
                     const float* __restrict__ nodes_g, int n_options, int g,
                     uint32_t seed, uint32_t off, int rows, int iters,
                     int n_blocks, int slices, int use_smem,
                     float* __restrict__ scratch) {
  extern __shared__ float smem[];
  __shared__ float sh[WARPS * 2];
  const int items = n_blocks * slices;
  const size_t n_slot = static_cast<size_t>(WARPS) * g * 2;
  float* sums = scratch;
  float* sprof = sums + static_cast<size_t>(items) * iters * 2;
  const float* nodes = nodes_g;
  float* prof = sprof + static_cast<size_t>(items) * g + blockIdx.x * n_slot;
  if (use_smem) {
    for (int t = threadIdx.x; t < N_TABLES * g; t += THREADS) {
      smem[t] = nodes_g[t];
    }
    nodes = smem;
    prof = smem + N_TABLES * g;
  }

  Ctx cx;
  cx.dp = nodes;
  cx.c1 = nodes + g;
  cx.isig_bs = nodes + 2 * g;
  cx.vsig = nodes + 3 * g;
  cx.disc = nodes + 4 * g;
  cx.mu = nodes + 5 * g;
  cx.isig = nodes + 6 * g;
  cx.strikes = opts;
  cx.weights = opts + n_options;
  cx.log_k = opts + 2 * n_options;
  cx.n_options = n_options;
  cx.g = g;
  // scal: s, r, v, lgd, drift, vol, intensity, wwr_b, dt, log_s0
  cx.lgd = scal[3];
  cx.drift = scal[4];
  cx.vol = scal[5];
  cx.lam = scal[6];
  cx.bw = scal[7];
  cx.dt = scal[8];
  cx.log_s0 = scal[9];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wprof = prof + warp * g * 2;
  const float half_w = ANTI ? 0.5f : 1.0f;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / slices, sl = item - b * slices;
    const int e0 = sl * SLICE_ROWS * mct::LANES;
    const int e1 = min(rows, (sl + 1) * SLICE_ROWS) * mct::LANES;
    for (size_t t = threadIdx.x; t < n_slot; t += THREADS) prof[t] = 0.0f;
    __syncthreads();
    float v[2] = {0.0f, 0.0f};
    for (int i = 0; i < iters; ++i) {
      const mct::Key key = mct::seed_key(
          seed, (off + static_cast<uint32_t>(b)) *
                        static_cast<uint32_t>(iters) +
                    static_cast<uint32_t>(i));
      for (int base = e0; base < e1; base += THREADS) {
        // e1 - e0 is a multiple of 128: a warp is wholly inside or outside.
        if (base + warp * 32 >= e1) continue;
        const uint32_t e = static_cast<uint32_t>(base + threadIdx.x);
        float cva =
            walk<KAHAN, DS, WWR>(cx, key, e, 1.0f, half_w, wprof, lane);
        if (ANTI) {
          cva = 0.5f * (cva + walk<KAHAN, DS, WWR>(cx, key, e, -1.0f, half_w,
                                                   wprof, lane));
        }
        v[0] = __fadd_rn(v[0], cva);
        v[1] = __fadd_rn(v[1], __fmul_rn(cva, cva));
      }
      mct::block_row<THREADS, 2>(
          v, sh, sums + ((static_cast<size_t>(b) * iters + i) * slices + sl) *
                            2);
    }
    // block_row's barrier orders the last profile adds before these reads.
    for (int j = threadIdx.x; j < g; j += THREADS) {
      float total = 0.0f;
      for (int w = 0; w < WARPS; ++w) {
        const float* slot = prof + (w * g + j) * 2;
        total = __fadd_rn(total, __fadd_rn(slot[0], slot[1]));
      }
      sprof[static_cast<size_t>(item) * g + j] = total;
    }
    __syncthreads();
  }
}

template <bool KAHAN>
__global__ void cva_fold_kernel(const float* __restrict__ scratch,
                                int n_blocks, int iters, int slices, int g,
                                float* __restrict__ out,
                                float* __restrict__ ee) {
  mct::slice_fold<2, KAHAN>(scratch, n_blocks, iters, slices, g,
                            blockIdx.x * blockDim.x + threadIdx.x, out, ee);
}

// Indexed by antithetic << 3 | kahan << 2 | ds << 1 | wwr.
constexpr SliceFn SLICE_FNS[16] = {
    cva_slice_kernel<false, false, false, false>,
    cva_slice_kernel<false, false, false, true>,
    cva_slice_kernel<false, false, true, false>,
    cva_slice_kernel<false, false, true, true>,
    cva_slice_kernel<false, true, false, false>,
    cva_slice_kernel<false, true, false, true>,
    cva_slice_kernel<false, true, true, false>,
    cva_slice_kernel<false, true, true, true>,
    cva_slice_kernel<true, false, false, false>,
    cva_slice_kernel<true, false, false, true>,
    cva_slice_kernel<true, false, true, false>,
    cva_slice_kernel<true, false, true, true>,
    cva_slice_kernel<true, true, false, false>,
    cva_slice_kernel<true, true, false, true>,
    cva_slice_kernel<true, true, true, false>,
    cva_slice_kernel<true, true, true, true>,
};

// The split launch of K4.  Past shared memory the grid is the blocks the
// card holds at once (by the occupancy of the widest instance), capped at
// the items; the sums do not depend on it.
Split split(int g, int n_blocks, int rows, int iters) {
  Split X{};
  X.slices = (rows + SLICE_ROWS - 1) / SLICE_ROWS;
  X.items = n_blocks * X.slices;
  X.use_smem = smem_need(g) <= SMEM_LIMIT;
  X.grid = X.items;
  const size_t n_slot = static_cast<size_t>(WARPS) * g * 2;
  if (!X.use_smem) {
    int dev = 0, sms = 1, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, SLICE_FNS[15],
                                                  THREADS, 0);
    X.grid = std::min(X.items, std::max(1, per_sm) * sms);
  }
  X.total = static_cast<size_t>(X.items) * (2 * iters + g) +
            (X.use_smem ? 0 : static_cast<size_t>(X.grid) * n_slot);
  return X;
}

}  // namespace

// Floats of K4's scratch for a launch (Split::total).
extern "C" int mctpu_cva_scratch_floats(int n_grid, int n_blocks, int rows,
                                        int iters) {
  return static_cast<int>(split(n_grid, n_blocks, rows, iters).total);
}

extern "C" int mctpu_cva(const float* scal, const float* opts,
                         const float* nodes, int n_options, int n_grid,
                         int seed, int off, int n_blocks, int rows, int iters,
                         int antithetic, int kahan, int ds, int wwr,
                         float* scratch, float* out, float* ee, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split X = split(n_grid, n_blocks, rows, iters);
  const SliceFn fn = SLICE_FNS[(antithetic ? 8 : 0) | (kahan ? 4 : 0) |
                               (ds ? 2 : 0) | (wwr ? 1 : 0)];
  const size_t smem = X.use_smem ? smem_need(n_grid) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<X.grid, THREADS, smem, s>>>(
      scal, opts, nodes, n_options, n_grid, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(off), rows, iters, n_blocks, X.slices,
      X.use_smem ? 1 : 0, scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int work = n_blocks * (2 + n_grid);
  (kahan ? cva_fold_kernel<true> : cva_fold_kernel<false>)<<<
      (work + 255) / 256, 256, 0, s>>>(scratch, n_blocks, iters, X.slices,
                                       n_grid, out, ee);
  return static_cast<int>(cudaGetLastError());
}
