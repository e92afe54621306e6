// K5: CVA Greeks — the exposure walk of K4 with its sensitivities.
//
// Replaces mctpu/kernels/cva.py::_cva_greek_kernel.  K4's stream: per
// simulation block b and iteration i reseed with (seed, (off + b) * iters +
// i) in int32 wrap; tile element e walks the grid in pairs, pair jj drawing
// Philox block (e, jj, 0, 0), cosine branch for step 2jj and sine branch for
// 2jj+1 (an odd grid takes the cosine branch of pair n_grid/2 last); the
// antithetic mirror replays the same draws with the sign flipped.  Per path
// it carries the log-spot and dxv = d log s/dv, and under wrong-way risk the
// survival with its lambda, v and z-tilt tangents and the lambda-free
// integrated hazard; per node it reprices the netted portfolio with the
// Hastings CDF and its spot slope, BS vega and BS gamma, and accumulates
// the CVA and its credit delta, spot delta, vega, spot gamma (pathwise at
// inner nodes, mixed pathwise-LR at the last), credit gamma and cross gamma
// (derivations in the JAX module): 7 outputs, 14 sums (x, x^2).  As in the
// JAX Greeks path there is no double-single walk state.
//
// Bound on the H100: arithmetic and latency.  Per path-step: one expf for
// the spot, per option three expf-class operations (two Hastings CDFs and
// the density, which shares the first CDF's exponential), two IEEE divides,
// and the serial node-to-node dependence; the WWR hazard adds two expf and a
// divide.  Design: split, as K4 (csrc/cva.cu).  layout_for keeps the TPU's
// few wide simulation blocks (32 of 256 rows at 2^20 paths), and one CUDA
// block each would leave 100 of the 132 SMs idle with a serial walk of 128
// paths a thread.  So each simulation block's rows are cut into slices of
// SLICE_ROWS rows, one CUDA block (256 threads) per (block, slice): 2048
// CUDA blocks at 2^20 paths.  A slice walks its elements as the unsplit
// walk, one thread per element striding over the slice with the 14-value
// state in registers, so every path's draws and node values are unchanged;
// it writes per iteration its 14 sums reduced over the block
// (mct::block_row), and cva_greeks_fold_kernel adds the slices in order and
// carries the iterations (mct::slice_fold, Kahan under KAHAN).  No atomics:
// the order depends on the plan alone, so launches and block offsets agree
// bit for bit; the sums move in the last bits against the unsplit order,
// and no gate holds them to another kernel's.  The 12 node tables (12 *
// n_grid floats, 24 KB at n_grid = 500) are staged in shared memory when
// they fit, else read through the read-only path with the grid capped at
// the blocks the card holds and each CUDA block taking (block, slice) items
// in turn; never __constant__, whose 64 KB would cap n_grid.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int N_SUMS = 14;
// Node tables (mctpu_torch/kernels/cva.py, GREEK_NODES).
enum Node { DP, DDP, DDP2, C1, ISIGBS, VSIG, DISC, MU, ISIG, DMU, DISIG, TZ,
            N_NODES };
constexpr size_t SMEM_LIMIT = 96 * 1024;
constexpr float INV_SQRT_2PI = MCT_F32(0.3989422804014327);

struct Ctx {
  const float* nodes;  // [N_NODES][g]
  const float* strikes;
  const float* weights;
  const float* log_k;
  int n_options, g;
  // scal (GREEK_SCAL): drift, vol, v_dt, sqdt, inv_v, inv_s0, log_s0, lam,
  // bw, dt, lgd, v_t, isqt
  float drift, vol, v_dt, sqdt, inv_v, inv_s0, log_s0, lam, bw, dt, lgd, v_t,
      isqt;
  __device__ __forceinline__ float at(int table, int j) const {
    return nodes[table * g + j];
  }
};

// Netted exposure at node j and its sensitivities (mctpu _exposure_grads):
// ee, dV/ds, BS vega, BS gamma times s, and the terminal LR option factor,
// each gated by 1{V > 0}.
struct Grads {
  float ee, dvds, veg, gam, gl;
};

__device__ __forceinline__ Grads exposure_grads(const Ctx& cx, int j, float s,
                                                float log_s, bool last) {
  float value = 0.0f, dvds = 0.0f, veg = 0.0f, gam = 0.0f, gl = 0.0f;
  for (int m = 0; m < cx.n_options; ++m) {
    const float km = __ldg(cx.strikes + m);
    const float wm = __ldg(cx.weights + m);
    const float itm = s > km ? 1.0f : 0.0f;
    float v_m, dv_m, veg_m, gam_m;
    if (last) {
      v_m = fmaxf(s - km, 0.0f);
      dv_m = itm;
      veg_m = 0.0f;
      gam_m = 0.0f;  // unused at the last node
    } else {
      const float d1 = (log_s - __ldg(cx.log_k + m) + cx.at(C1, j)) *
                       cx.at(ISIGBS, j);
      const float d2 = d1 - cx.at(VSIG, j);
      const float e1 = expf(MCT_F32(-0.5) * d1 * d1);
      const float nd1 = mct::norm_cdf_hastings_e(d1, e1);
      v_m = s * nd1 - km * cx.at(DISC, j) * mct::norm_cdf_hastings(d2);
      dv_m = nd1;
      const float phi = INV_SQRT_2PI * e1;
      veg_m = s * phi * cx.at(VSIG, j) * cx.inv_v;
      gam_m = phi * cx.at(ISIGBS, j);
    }
    const float gl_m = km * itm;
    if (m == 0) {
      value = wm * v_m;
      dvds = wm * dv_m;
      veg = wm * veg_m;
      gam = wm * gam_m;
      gl = wm * gl_m;
    } else {
      value = value + wm * v_m;
      dvds = dvds + wm * dv_m;
      veg = veg + wm * veg_m;
      gam = gam + wm * gam_m;
      gl = gl + wm * gl_m;
    }
  }
  const float ind = value > 0.0f ? 1.0f : 0.0f;
  return Grads{fmaxf(value, 0.0f), ind * dvds, ind * veg, ind * gam, ind * gl};
}

// One Greeks walk of tile element e; out[] gets lgd times the 7 outputs
// (mctpu _greek_step).
template <bool WWR>
__device__ void walk(const Ctx& cx, mct::Key key, uint32_t e, float sgn,
                     float (&out)[7]) {
  float log_s = cx.log_s0, dxv = 0.0f;
  float surv = 1.0f, dsl = 0.0f, dsv = 0.0f, csum = 0.0f, dsz = 0.0f;
  float a = 0.0f, al = 0.0f, ad = 0.0f, av = 0.0f, ag = 0.0f, acg = 0.0f,
        axg = 0.0f;
  const float inv_s0_2 = cx.inv_s0 * cx.inv_s0;
  const float gl_scale = inv_s0_2 * cx.inv_v * cx.isqt;
  auto step = [&](int j, float z) {
    const float zs = sgn * z;
    log_s = log_s + cx.drift + cx.vol * zs;
    dxv = dxv - cx.v_dt + cx.sqdt * zs;
    const float s = expf(log_s);
    const bool last = j == cx.g - 1;
    const Grads G = exposure_grads(cx, j, s, log_s, last);
    const float dee_ds0 = G.dvds * s * cx.inv_s0;
    const float dee_dv = G.dvds * s * dxv + G.veg;
    const float z_std = (dxv + cx.v_t) * cx.isqt;
    float dp_j, ddp_l, ddp2_j, ddp_z;
    if (WWR) {  // _wwr_hazard_step_grads
      const float log_rel = log_s - cx.log_s0;
      const float mu = cx.at(MU, j), isig = cx.at(ISIG, j);
      const float zstd = (log_rel - mu) * isig;
      const float h = cx.lam * expf(cx.bw * zstd - 0.5f * cx.bw * cx.bw);
      const float y = h * cx.dt;
      const float series = y * (1.0f + y * (-0.5f + y * MCT_F32(1.0 / 6.0)));
      const float emy = expf(-y);
      const float ey = (y < MCT_F32(0.01)) ? series : 1.0f - emy;
      dp_j = surv * ey;
      const float de_dh = emy * cx.dt;
      const float dh_dl = h / cx.lam;
      const float dh_dv = h * cx.bw * ((dxv - cx.at(DMU, j)) * isig +
                                       (log_rel - mu) * cx.at(DISIG, j));
      const float dh_dz = h * cx.bw * isig * cx.at(TZ, j);
      ddp_l = dsl * ey + surv * de_dh * dh_dl;
      const float ddp_v = dsv * ey + surv * de_dh * dh_dv;
      ddp_z = dsz * ey + surv * de_dh * dh_dz;
      const float surv_new = surv - dp_j;
      const float csum_new = csum + cx.dt * dh_dl;
      ddp2_j = csum * csum * surv - csum_new * csum_new * surv_new;
      surv = surv_new;
      dsl = dsl - ddp_l;
      dsv = dsv - ddp_v;
      csum = csum_new;
      dsz = dsz - ddp_z;
      av = av + dp_j * dee_dv + ddp_v * G.ee;
    } else {
      dp_j = cx.at(DP, j);
      ddp_l = cx.at(DDP, j);
      ddp2_j = cx.at(DDP2, j);
      ddp_z = 0.0f;
      av = av + dp_j * dee_dv;
    }
    a = a + dp_j * G.ee;
    al = al + ddp_l * G.ee;
    ad = ad + dp_j * dee_ds0;
    ag = ag + (last ? (dp_j * z_std - ddp_z) * (G.gl * gl_scale)
                    : dp_j * G.gam * s * inv_s0_2);
    acg = acg + ddp2_j * G.ee;
    axg = axg + ddp_l * dee_ds0;
  };
  mct::walk_pairwise(key, e, cx.g, step);
  out[0] = cx.lgd * a;
  out[1] = cx.lgd * al;
  out[2] = cx.lgd * ad;
  out[3] = cx.lgd * av;
  out[4] = cx.lgd * ag;
  out[5] = cx.lgd * acg;
  out[6] = cx.lgd * axg;
}

// Rows of a slice (K4's choice): 2048 CUDA blocks at 2^20 paths (32 x 256
// rows), each thread walking 2 elements an iteration.  On an H100 8-row
// slices took ~2% longer at 500 nodes and 2-row slices 5% longer at 50
// (tools/time_redesign.py, see PERF.md).
constexpr int SLICE_ROWS = 4;
// Three CUDA blocks an SM: the walk at 80 registers (the plain instance's
// own count; the antithetic and WWR instances spill 4-80 B instead of
// taking 119-127 registers and two blocks an SM), 1.5-7% faster on an
// H100 than uncapped; four blocks (64 registers, 84-144 B spilled) gained
// 2-7.5%, less under antithetic (tools/time_redesign.py, see PERF.md).
constexpr int MIN_BLOCKS = 3;

using SliceFn = void (*)(const float*, const float*, const float*, int, int,
                         uint32_t, uint32_t, int, int, int, int, int, float*);

// One CUDA block per (simulation block b, slice sl) item, taking items in
// turn when the grid is capped.  A slice walks its elements as the unsplit
// walk (element e = row * 128 + lane under (seed, (off + b) * iters + i)),
// one thread per element striding over the slice, and writes per iteration
// its 14 sums reduced over the block to scratch [B][iters][S][14].
template <bool ANTI, bool KAHAN, bool WWR>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    cva_greeks_slice_kernel(const float* __restrict__ scal,
                            const float* __restrict__ opts,
                            const float* __restrict__ nodes_g, int n_options,
                            int g, uint32_t seed, uint32_t off, int rows,
                            int iters, int n_blocks, int slices, int use_smem,
                            float* __restrict__ scratch) {
  extern __shared__ float smem[];
  __shared__ float sh[WARPS * N_SUMS];
  Ctx cx;
  cx.nodes = nodes_g;
  if (use_smem) {
    for (int t = threadIdx.x; t < N_NODES * g; t += THREADS) {
      smem[t] = nodes_g[t];
    }
    cx.nodes = smem;
  }
  __syncthreads();
  cx.strikes = opts;
  cx.weights = opts + n_options;
  cx.log_k = opts + 2 * n_options;
  cx.n_options = n_options;
  cx.g = g;
  cx.drift = scal[0];
  cx.vol = scal[1];
  cx.v_dt = scal[2];
  cx.sqdt = scal[3];
  cx.inv_v = scal[4];
  cx.inv_s0 = scal[5];
  cx.log_s0 = scal[6];
  cx.lam = scal[7];
  cx.bw = scal[8];
  cx.dt = scal[9];
  cx.lgd = scal[10];
  cx.v_t = scal[11];
  cx.isqt = scal[12];

  const int items = n_blocks * slices;
  float v[N_SUMS];
#pragma unroll
  for (int k = 0; k < N_SUMS; ++k) v[k] = 0.0f;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / slices, sl = item - b * slices;
    const int e0 = sl * SLICE_ROWS * mct::LANES;
    const int e1 = min(rows, (sl + 1) * SLICE_ROWS) * mct::LANES;
    for (int i = 0; i < iters; ++i) {
      const mct::Key key = mct::seed_key(
          seed, (off + static_cast<uint32_t>(b)) *
                        static_cast<uint32_t>(iters) +
                    static_cast<uint32_t>(i));
      for (int e = e0 + threadIdx.x; e < e1; e += THREADS) {
        float o[7];
        walk<WWR>(cx, key, static_cast<uint32_t>(e), 1.0f, o);
        if (ANTI) {
          float m[7];
          walk<WWR>(cx, key, static_cast<uint32_t>(e), -1.0f, m);
#pragma unroll
          for (int k = 0; k < 7; ++k) o[k] = 0.5f * (o[k] + m[k]);
        }
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          v[2 * k] += o[k];
          v[2 * k + 1] += o[k] * o[k];
        }
      }
      mct::block_row<THREADS, N_SUMS>(
          v, sh,
          scratch + ((static_cast<size_t>(b) * iters + i) * slices + sl) *
                        N_SUMS);
    }
  }
}

// Block b's 14 sums: per iteration its slices added in order, carried over
// the iterations (Kahan under KAHAN); no profile (gp = 0).
template <bool KAHAN>
__global__ void cva_greeks_fold_kernel(const float* __restrict__ scratch,
                                       int n_blocks, int iters, int slices,
                                       float* __restrict__ out) {
  mct::slice_fold<N_SUMS, KAHAN>(scratch, n_blocks, iters, slices, 0,
                                 blockIdx.x * blockDim.x + threadIdx.x, out,
                                 nullptr);
}

// Indexed by antithetic << 2 | kahan << 1 | wwr.
constexpr SliceFn SLICE_FNS[8] = {
    cva_greeks_slice_kernel<false, false, false>,
    cva_greeks_slice_kernel<false, false, true>,
    cva_greeks_slice_kernel<false, true, false>,
    cva_greeks_slice_kernel<false, true, true>,
    cva_greeks_slice_kernel<true, false, false>,
    cva_greeks_slice_kernel<true, false, true>,
    cva_greeks_slice_kernel<true, true, false>,
    cva_greeks_slice_kernel<true, true, true>,
};

size_t smem_need(int g) {
  return static_cast<size_t>(N_NODES) * g * sizeof(float);
}

// The split launch: its slices a simulation block, (block, slice) items and
// CUDA blocks, whether the tables sit in shared memory, and its scratch in
// floats (the slices' iteration sums [B][iters][S][14]).
struct Split {
  int slices, items, grid;
  bool use_smem;
  size_t total;
};

// Past shared memory the grid is the blocks the card holds at once (by the
// occupancy of the widest instance), capped at the items; the sums do not
// depend on it.
Split split(int g, int n_blocks, int rows, int iters) {
  Split X{};
  X.slices = (rows + SLICE_ROWS - 1) / SLICE_ROWS;
  X.items = n_blocks * X.slices;
  X.use_smem = smem_need(g) <= SMEM_LIMIT;
  X.grid = X.items;
  if (!X.use_smem) {
    int dev = 0, sms = 1, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, SLICE_FNS[7],
                                                  THREADS, 0);
    X.grid = std::min(X.items, std::max(1, per_sm) * sms);
  }
  X.total = static_cast<size_t>(X.items) * iters * N_SUMS;
  return X;
}

}  // namespace

// Floats of K5's scratch for a launch (Split::total).
extern "C" int mctpu_cva_greeks_scratch_floats(int n_grid, int n_blocks,
                                               int rows, int iters) {
  return static_cast<int>(split(n_grid, n_blocks, rows, iters).total);
}

extern "C" int mctpu_cva_greeks(const float* scal, const float* opts,
                                const float* nodes, int n_options, int n_grid,
                                int seed, int off, int n_blocks, int rows,
                                int iters, int antithetic, int kahan, int wwr,
                                float* scratch, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split X = split(n_grid, n_blocks, rows, iters);
  const SliceFn fn =
      SLICE_FNS[(antithetic ? 4 : 0) | (kahan ? 2 : 0) | (wwr ? 1 : 0)];
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
  const int work = n_blocks * N_SUMS;
  (kahan ? cva_greeks_fold_kernel<true> : cva_greeks_fold_kernel<false>)<<<
      (work + 255) / 256, 256, 0, s>>>(scratch, n_blocks, iters, X.slices,
                                       out);
  return static_cast<int>(cudaGetLastError());
}
