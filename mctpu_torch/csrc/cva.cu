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
// node.  Simple design: one CUDA block (256 threads) per simulation block,
// one thread per path element, striding over the (rows, 128) tile.  The EE
// profile is reduced per node by a fixed warp-shuffle tree and
// Kahan-added by lane 0 into its warp's own slot, then combined across warps
// in warp order: no atomics, deterministic.  Node tables and profile slots
// live in shared memory when they fit, otherwise in global memory.  With
// layout_for's few wide blocks (32 at 2^20 paths) most of the 132 SMs idle
// (see PERF.md).
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

template <bool ANTI, bool KAHAN, bool DS, bool WWR>
__global__ void __launch_bounds__(THREADS)
    cva_kernel(const float* __restrict__ scal, const float* __restrict__ opts,
               const float* __restrict__ nodes_g, int n_options, int g,
               uint32_t seed, uint32_t off, int n_elems, int iters,
               int use_smem, float* __restrict__ scratch,
               float* __restrict__ out, float* __restrict__ ee_out) {
  extern __shared__ float smem[];
  const float* nodes = nodes_g;
  float* prof = scratch + static_cast<size_t>(blockIdx.x) * WARPS * g * 2;
  if (use_smem) {
    for (int t = threadIdx.x; t < N_TABLES * g; t += THREADS) smem[t] = nodes_g[t];
    nodes = smem;
    prof = smem + N_TABLES * g;
  }
  for (int t = threadIdx.x; t < WARPS * g * 2; t += THREADS) prof[t] = 0.0f;
  __syncthreads();

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
  mct::Acc2<KAHAN> acc;
  for (int i = 0; i < iters; ++i) {
    const uint32_t word = (off + blockIdx.x) * static_cast<uint32_t>(iters) +
                          static_cast<uint32_t>(i);
    const mct::Key key = mct::seed_key(seed, word);
    for (int base = 0; base < n_elems; base += THREADS) {
      // n_elems is a multiple of 128: a warp is wholly inside or outside.
      if (base + warp * 32 >= n_elems) continue;
      const uint32_t e = static_cast<uint32_t>(base + threadIdx.x);
      float cva = walk<KAHAN, DS, WWR>(cx, key, e, 1.0f, half_w, wprof, lane);
      if (ANTI) {
        cva = 0.5f * (cva + walk<KAHAN, DS, WWR>(cx, key, e, -1.0f, half_w,
                                                 wprof, lane));
      }
      acc.add(cva);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < g; j += THREADS) {
    float total = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      const float* slot = prof + (w * g + j) * 2;
      total = __fadd_rn(total, __fadd_rn(slot[0], slot[1]));
    }
    ee_out[static_cast<size_t>(blockIdx.x) * g + j] = total;
  }
  mct::write_block_sums<THREADS, KAHAN>(acc, out);
}

template <bool ANTI, bool KAHAN, bool DS, bool WWR>
int launch(const float* scal, const float* opts, const float* nodes,
           int n_options, int g, uint32_t seed, uint32_t off, int n_blocks,
           int n_elems, int iters, float* scratch, float* out, float* ee,
           cudaStream_t stream) {
  const size_t smem_need =
      (static_cast<size_t>(N_TABLES) * g + static_cast<size_t>(WARPS) * g * 2) *
      sizeof(float);
  const int use_smem = smem_need <= SMEM_LIMIT;
  const size_t smem = use_smem ? smem_need : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cva_kernel<ANTI, KAHAN, DS, WWR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cva_kernel<ANTI, KAHAN, DS, WWR><<<n_blocks, THREADS, smem, stream>>>(
      scal, opts, nodes, n_options, g, seed, off, n_elems, iters, use_smem,
      scratch, out, ee);
  return 0;
}

using LaunchFn = int (*)(const float*, const float*, const float*, int, int,
                         uint32_t, uint32_t, int, int, int, float*, float*,
                         float*, cudaStream_t);

// Indexed by antithetic << 3 | kahan << 2 | ds << 1 | wwr.
constexpr LaunchFn LAUNCHERS[16] = {
    launch<false, false, false, false>, launch<false, false, false, true>,
    launch<false, false, true, false>,  launch<false, false, true, true>,
    launch<false, true, false, false>,  launch<false, true, false, true>,
    launch<false, true, true, false>,   launch<false, true, true, true>,
    launch<true, false, false, false>,  launch<true, false, false, true>,
    launch<true, false, true, false>,   launch<true, false, true, true>,
    launch<true, true, false, false>,   launch<true, true, false, true>,
    launch<true, true, true, false>,    launch<true, true, true, true>,
};

}  // namespace

extern "C" int mctpu_cva_scratch_floats(int n_grid) { return WARPS * n_grid * 2; }

extern "C" int mctpu_cva(const float* scal, const float* opts,
                         const float* nodes, int n_options, int n_grid,
                         int seed, int off, int n_blocks, int rows, int iters,
                         int antithetic, int kahan, int ds, int wwr,
                         float* scratch, float* out, float* ee, void* stream) {
  const int idx = (antithetic ? 8 : 0) | (kahan ? 4 : 0) | (ds ? 2 : 0) |
                  (wwr ? 1 : 0);
  const int err = LAUNCHERS[idx](
      scal, opts, nodes, n_options, n_grid, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(off), n_blocks, rows * mct::LANES, iters, scratch,
      out, ee, static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
