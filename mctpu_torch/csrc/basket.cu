// K2 and K3: fused weighted-basket call Monte Carlo (correlated GBM).
//
// K2 replaces mctpu/kernels/basket.py::_basket_am_kernel (<= 8 assets, the
// asset-major stream map): in iteration i, tile element e draws Philox
// blocks (e, i*a + p, 0, 0) for p < a; the cosine branches are path A's
// asset normals, the sine branches path B's.  bt = L z as lower-triangular
// FMAs, basket = sum_i (w s0)_i exp(drift_i + vol_i (bt_i + d_i)).
//
// K3 replaces mctpu/kernels/basket.py::_basket_kernel (> 8 assets, the
// lane-packed stream map): the tile is (rows, width) with element index
// row * width + lane, and path (row, p) owns lanes p*a_tile .. p*a_tile+a-1
// (pack_factor); iteration i draws Philox block (element, i, 0, 0), the
// cosine tile feeds one set of paths and the sine tile another.  The TPU
// kernel forms bt = z @ chol_bd on the MXU at HIGHEST precision; here it is
// FP32 FFMA over the lower triangle only.  Not TF32 or bf16: reduced-
// precision products biased the price by +4% (mctpu/kernels/basket.py).
//
// Bound on the H100: arithmetic.  K2 spends a Philox block, a logf, a sqrtf
// and the sin/cos polynomials per two asset normals plus a(a+1)/2 FMAs and
// a expf per path.  K3 at a = 100 spends ~5000 FMAs per path against 100
// draws, so its correlation product dominates; L (a x a floats) is read
// through the read-only cache, every thread of a warp reading the same
// entry.  Simple design: one CUDA block per simulation block.  K2: 256
// threads stride over tile elements, L and the parameter rows in shared
// memory.  K3: 128 threads first draw a chunk of the tile's rows into
// shared memory (both branches, padded rows against bank conflicts, padded
// asset slots not drawn), then one thread per (row, packed path, branch)
// forms its basket.  Both end in the fixed-order block tree of common.cuh:
// no atomics, deterministic.
#include <algorithm>

#include "basket.cuh"

namespace {

constexpr int AM_THREADS = 256;
constexpr int PK_THREADS = 128;
constexpr int MAX_AM_ASSETS = 8;
constexpr size_t SMEM_LIMIT = 96 * 1024;

// ---------------------------------------------------------------- K2 (a <= 8)

template <int A, bool ANTI>
__device__ __forceinline__ float am_payoff(const float* z, const float* lt,
                                           const float* par, float k) {
  const float p = fmaxf(mct::am_basket<A>(z, lt, par, 1.0f) - k, 0.0f);
  if (ANTI) {
    return 0.5f * (p + fmaxf(mct::am_basket<A>(z, lt, par, -1.0f) - k, 0.0f));
  }
  return p;
}

template <int A, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(AM_THREADS)
    basket_am_kernel(const float* __restrict__ lt, const float* __restrict__ par,
                     const float* __restrict__ kp, uint32_t seed, uint32_t off,
                     int n_elems, int iters, float* __restrict__ out) {
  __shared__ float s_lt[A * A];
  __shared__ float s_par[4 * A];
  for (int t = threadIdx.x; t < A * A; t += AM_THREADS) s_lt[t] = lt[t];
  for (int t = threadIdx.x; t < 4 * A; t += AM_THREADS) s_par[t] = par[t];
  __syncthreads();
  const float k = kp[0];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  mct::Acc2<KAHAN> acc;
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += AM_THREADS) {
      float za[A], zb[A];
#pragma unroll
      for (int p = 0; p < A; ++p) {
        mct::draw_normal_pair(key, e, static_cast<uint32_t>(i * A + p), za[p],
                              zb[p]);
      }
      acc.add(am_payoff<A, ANTI>(za, s_lt, s_par, k));
      acc.add(am_payoff<A, ANTI>(zb, s_lt, s_par, k));
    }
  }
  mct::write_block_sums<AM_THREADS, KAHAN>(acc, out);
}

template <int A, bool ANTI, bool KAHAN>
void launch_am(const float* lt, const float* par, const float* kp,
               uint32_t seed, uint32_t off, int n_blocks, int n_elems,
               int iters, float* out, cudaStream_t stream) {
  basket_am_kernel<A, ANTI, KAHAN><<<n_blocks, AM_THREADS, 0, stream>>>(
      lt, par, kp, seed, off, n_elems, iters, out);
}

template <int A>
void dispatch_am(bool anti, bool kahan, const float* lt, const float* par,
                 const float* kp, uint32_t seed, uint32_t off, int n_blocks,
                 int n_elems, int iters, float* out, cudaStream_t s) {
  if (anti) {
    if (kahan) launch_am<A, true, true>(lt, par, kp, seed, off, n_blocks, n_elems, iters, out, s);
    else launch_am<A, true, false>(lt, par, kp, seed, off, n_blocks, n_elems, iters, out, s);
  } else {
    if (kahan) launch_am<A, false, true>(lt, par, kp, seed, off, n_blocks, n_elems, iters, out, s);
    else launch_am<A, false, false>(lt, par, kp, seed, off, n_blocks, n_elems, iters, out, s);
  }
}

// ---------------------------------------------------------------- K3 (a > 8)

// Payoff of one packed path from its a normals z (shared memory), pair-meaned
// under ANTI (mct::packed_baskets).
template <bool ANTI>
__device__ __forceinline__ float packed_payoff(const float* z,
                                               const float* __restrict__ lt,
                                               const float* __restrict__ par,
                                               int a, float k) {
  float basket, basket_m;
  mct::packed_baskets<ANTI>(z, lt, par, a, basket, basket_m);
  const float p = fmaxf(basket - k, 0.0f);
  if (ANTI) return 0.5f * (p + fmaxf(basket_m - k, 0.0f));
  return p;
}

template <bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(PK_THREADS)
    basket_packed_kernel(const float* __restrict__ lt,
                         const float* __restrict__ par,
                         const float* __restrict__ kp, int a, int a_tile,
                         int width, int chunk_rows, uint32_t seed,
                         uint32_t off, int rows, int iters,
                         float* __restrict__ out) {
  extern __shared__ float smem[];
  const int stride = width + 1;  // odd row stride: rows land on distinct banks
  float* z1s = smem;
  float* z2s = smem + chunk_rows * stride;
  const int c = width / a_tile;
  const float k = kp[0];
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  mct::Acc2<KAHAN> acc;
  for (int i = 0; i < iters; ++i) {
    for (int r0 = 0; r0 < rows; r0 += chunk_rows) {
      const int nr = min(chunk_rows, rows - r0);
      for (int e = threadIdx.x; e < nr * width; e += PK_THREADS) {
        const int row = e / width;
        const int lane = e - row * width;
        if (lane % a_tile < a) {  // padded asset slots are never read
          float z1, z2;
          mct::draw_normal_pair(key, static_cast<uint32_t>(r0 * width + e),
                                static_cast<uint32_t>(i), z1, z2);
          z1s[row * stride + lane] = z1;
          z2s[row * stride + lane] = z2;
        }
      }
      __syncthreads();
      for (int q = threadIdx.x; q < nr * c * 2; q += PK_THREADS) {
        const int path = q >> 1;
        const int row = path / c;
        const int p = path - row * c;
        const float* z = ((q & 1) ? z2s : z1s) + row * stride + p * a_tile;
        acc.add(packed_payoff<ANTI>(z, lt, par, a, k));
      }
      __syncthreads();
    }
  }
  mct::write_block_sums<PK_THREADS, KAHAN>(acc, out);
}

template <bool ANTI, bool KAHAN>
int launch_packed(const float* lt, const float* par, const float* kp, int a,
                  int a_tile, int width, int chunk_rows, size_t smem,
                  uint32_t seed, uint32_t off, int n_blocks, int rows,
                  int iters, float* out, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        basket_packed_kernel<ANTI, KAHAN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  basket_packed_kernel<ANTI, KAHAN><<<n_blocks, PK_THREADS, smem, stream>>>(
      lt, par, kp, a, a_tile, width, chunk_rows, seed, off, rows, iters, out);
  return 0;
}

}  // namespace

extern "C" int mctpu_basket_am(const float* lt, const float* par,
                               const float* kp, int n_assets, int seed,
                               int off, int n_blocks, int rows, int iters,
                               int antithetic, int kahan, float* out,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int n = rows * mct::LANES;
  const bool anti = antithetic != 0, kh = kahan != 0;
  switch (n_assets) {
    case 1: dispatch_am<1>(anti, kh, lt, par, kp, sd, of, n_blocks, n, iters, out, s); break;
    case 2: dispatch_am<2>(anti, kh, lt, par, kp, sd, of, n_blocks, n, iters, out, s); break;
    case 3: dispatch_am<3>(anti, kh, lt, par, kp, sd, of, n_blocks, n, iters, out, s); break;
    case 4: dispatch_am<4>(anti, kh, lt, par, kp, sd, of, n_blocks, n, iters, out, s); break;
    case 5: dispatch_am<5>(anti, kh, lt, par, kp, sd, of, n_blocks, n, iters, out, s); break;
    case 6: dispatch_am<6>(anti, kh, lt, par, kp, sd, of, n_blocks, n, iters, out, s); break;
    case 7: dispatch_am<7>(anti, kh, lt, par, kp, sd, of, n_blocks, n, iters, out, s); break;
    case MAX_AM_ASSETS: dispatch_am<MAX_AM_ASSETS>(anti, kh, lt, par, kp, sd, of, n_blocks, n, iters, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mctpu_basket_packed(const float* lt, const float* par,
                                   const float* kp, int n_assets, int a_tile,
                                   int width, int seed, int off, int n_blocks,
                                   int rows, int iters, int antithetic,
                                   int kahan, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  // Rows per shared-memory chunk: about one (path, branch) per thread, and
  // both branches' rows within SMEM_LIMIT.
  const int c = width / a_tile;
  const size_t row_bytes = 2 * static_cast<size_t>(width + 1) * sizeof(float);
  int chunk = std::min(rows, std::max(1, PK_THREADS / (2 * c)));
  chunk = std::min<int>(chunk, static_cast<int>(SMEM_LIMIT / row_bytes));
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = chunk * row_bytes;
  int err;
  if (antithetic) {
    err = kahan ? launch_packed<true, true>(lt, par, kp, n_assets, a_tile, width, chunk, smem, sd, of, n_blocks, rows, iters, out, s)
                : launch_packed<true, false>(lt, par, kp, n_assets, a_tile, width, chunk, smem, sd, of, n_blocks, rows, iters, out, s);
  } else {
    err = kahan ? launch_packed<false, true>(lt, par, kp, n_assets, a_tile, width, chunk, smem, sd, of, n_blocks, rows, iters, out, s)
                : launch_packed<false, false>(lt, par, kp, n_assets, a_tile, width, chunk, smem, sd, of, n_blocks, rows, iters, out, s);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
