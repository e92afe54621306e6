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
// draws, so its correlation product dominates.  K2, simple design: one CUDA
// block per simulation block, 256 threads striding over tile elements, L
// and the parameter rows in shared memory, the fixed-order block tree of
// common.cuh at the end.  K3 is a split kernel and a fold (see "K3" below):
// one CUDA block per (simulation block, iteration) item writes each unit's
// payoff, and the fold adds them in the simple design's order, so the block
// sums are that design's bit for bit.  No atomics, deterministic.
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

// K3's simple design was one CUDA block of PK_THREADS threads per
// simulation block walking its iterations in series: per iteration, chunks
// of chunk_rows rows (both branches' normals drawn into shared memory,
// padded slots not drawn), then unit q = 2 path + branch of a chunk (at most
// PK_THREADS of them) to thread q, which formed its payoff (packed_payoff:
// mct::packed_baskets, one L load and one normal load a multiply-add) and
// added it into its own Acc2, in the order (iteration, chunk);
// write_block_sums reduced the Acc2s once at the end.  Here one CUDA block
// takes one (simulation block b, iteration i) item on b's key and the draws
// (r0 * width + e, i), with the same chunks and unit-to-thread map, and
// writes each unit's payoff (the pair's mean under antithetic) to scratch
// [block][iteration][units], unit q of the chunk at row r0 at 2 c r0 + q.
// basket_fold_kernel, one CUDA block of PK_THREADS per simulation block,
// replays the simple design's sums: thread t adds unit t, t + PK_THREADS,
// .. of each chunk of each iteration into its own Acc2 (a short last chunk's
// missing units are skipped, not added as zeros, which could move a Kahan
// compensation), then write_block_sums' tree.  So the block sums equal the
// simple design's bit for bit, and 512 blocks x 16 iterations become 8192
// CUDA blocks.  The scratch is grouped under K3_SCRATCH_CAP by
// mct::scratch_groups, each fold thread's Acc2 carried between the groups.
//
// At width 128 (9-128 assets) an item's payoffs come from the register-
// tiled product mct::tiled_item (basket.cuh, shared with K48), whose basket
// values are packed_baskets' bit for bit: this file contracts drift + vol
// (bt + d) the same way in both.  Past width 128 (a > 128) the item keeps
// the simple design's per-path code (basket_path_kernel).
constexpr size_t K3_SCRATCH_CAP = size_t{64} << 20;  // floats: 256 MB

// The payoff of one packed path's basket values, pair-meaned under ANTI
// (packed_payoff's operations).
template <bool ANTI>
__device__ __forceinline__ float pair_payoff(float basket, float basket_m,
                                             float k) {
  const float p = fmaxf(basket - k, 0.0f);
  if (ANTI) return 0.5f * (p + fmaxf(basket_m - k, 0.0f));
  return p;
}

// Payoff of one packed path from its a normals z (shared memory).
template <bool ANTI>
__device__ __forceinline__ float packed_payoff(const float* z,
                                               const float* __restrict__ lt,
                                               const float* __restrict__ par,
                                               int a, float k) {
  float basket, basket_m;
  mct::packed_baskets<ANTI>(z, lt, par, a, basket, basket_m);
  return pair_payoff<ANTI>(basket, basket_m, k);
}

// A group's items: simulation blocks b0 .. b0 + nb, iterations i0 .. i0 +
// ni; units per item.
struct K3Items {
  uint32_t seed, off;
  int b0, i0, ni, units;
};

__device__ __forceinline__ mct::Key item_key(const K3Items& I, int& i) {
  const int bl = blockIdx.x / I.ni;
  i = I.i0 + (blockIdx.x - bl * I.ni);
  return mct::seed_key(I.seed, I.off + static_cast<uint32_t>(I.b0 + bl));
}

template <bool ANTI>
__global__ void __launch_bounds__(mct::TILED_THREADS, 2)
    basket_tiled_kernel(const float* __restrict__ lt,
                        const float* __restrict__ par,
                        const float* __restrict__ kp, int a, int a_tile,
                        int chunk_rows, int rows, K3Items I,
                        float* __restrict__ split) {
  int i;
  const mct::Key key = item_key(I, i);
  const float k = kp[0];
  float* dst = split + static_cast<size_t>(blockIdx.x) * I.units;
  mct::tiled_item<ANTI>(lt, par, a, a_tile, chunk_rows, key,
                        static_cast<uint32_t>(i), rows,
                        [&](int u0, int q, float basket, float basket_m) {
                          dst[u0 + q] = pair_payoff<ANTI>(basket, basket_m, k);
                        });
}

// Past width 128: the simple design's chunk (both branches' rows, odd row
// stride) and one thread per unit forming its payoff, per item.
template <bool ANTI>
__global__ void __launch_bounds__(PK_THREADS)
    basket_path_kernel(const float* __restrict__ lt,
                       const float* __restrict__ par,
                       const float* __restrict__ kp, int a, int a_tile,
                       int width, int chunk_rows, int rows, K3Items I,
                       float* __restrict__ split) {
  extern __shared__ float smem[];
  const int stride = width + 1;  // odd row stride: rows land on distinct banks
  float* z1s = smem;
  float* z2s = smem + chunk_rows * stride;
  const int c = width / a_tile;
  const float k = kp[0];
  int i;
  const mct::Key key = item_key(I, i);
  float* dst = split + static_cast<size_t>(blockIdx.x) * I.units;
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
      dst[2 * c * r0 + q] = packed_payoff<ANTI>(z, lt, par, a, k);
    }
    __syncthreads();
  }
}

// Calls f(x) on unit t, t + THREADS, .. of every chunk of `chunk` units
// (the last one may be shorter) of each of ni items of n units, item by
// item and chunk by chunk, the loads issued mct::FOLD_BATCH at a time
// ahead of the calls.
template <int THREADS, class F>
__device__ __forceinline__ void fold_chunks(const float* __restrict__ items,
                                            int ni, int n, int chunk,
                                            F&& f) {
  const int t = threadIdx.x;
  int il = 0, base = 0, q = t;  // the next load's item, chunk and unit
  auto settle = [&]() {  // past the chunk's units: the next chunk or item
    while (il < ni && q >= min(chunk, n - base)) {
      base += chunk;
      q = t;
      if (base >= n) {
        base = 0;
        ++il;
      }
    }
  };
  settle();
  while (il < ni) {
    float x[mct::FOLD_BATCH];
    int got = 0;
#pragma unroll
    for (int u = 0; u < mct::FOLD_BATCH; ++u) {
      x[u] = 0.0f;
      if (il < ni) {
        x[u] = items[static_cast<size_t>(il) * n + base + q];
        got = u + 1;
        q += THREADS;
        settle();
      }
    }
#pragma unroll
    for (int u = 0; u < mct::FOLD_BATCH; ++u) {
      if (u < got) f(x[u]);
    }
  }
}

// Simulation block b0 + blockIdx.x of a group of ni iterations; out is
// offset to b0's row.  carry holds each thread's Acc2 between groups.
template <bool KAHAN>
__global__ void __launch_bounds__(PK_THREADS)
    basket_fold_kernel(const float* __restrict__ split,
                       float* __restrict__ carry, int units, int chunk,
                       int ni, int first, int last, float* __restrict__ out) {
  const int t = threadIdx.x;
  const float* items = split + static_cast<size_t>(blockIdx.x) * ni * units;
  float* cb = carry + blockIdx.x * 4 * PK_THREADS;
  mct::Acc2<KAHAN> acc;
  if (!first) {
    acc.s = cb[t];
    acc.c = cb[PK_THREADS + t];
    acc.s2 = cb[2 * PK_THREADS + t];
    acc.c2 = cb[3 * PK_THREADS + t];
  }
  fold_chunks<PK_THREADS>(items, ni, units, chunk,
                          [&](float p) { acc.add(p); });
  if (last) {
    mct::write_block_sums<PK_THREADS, KAHAN>(acc, out);
  } else {
    cb[t] = acc.s;
    cb[PK_THREADS + t] = acc.c;
    cb[2 * PK_THREADS + t] = acc.s2;
    cb[3 * PK_THREADS + t] = acc.c2;
  }
}

// A K3 launch's shape: the simple design's chunk (about one unit a thread,
// both branches' rows within SMEM_LIMIT; 0 if one row does not fit), its
// units, an item's units and the scratch groups under a cap in floats (0:
// K3_SCRATCH_CAP).
struct K3Plan {
  int chunk, chunk_units, units;
  mct::ScratchGroups groups;
};

K3Plan k3_plan(int a_tile, int width, int n_blocks, int rows, int iters,
               size_t cap) {
  K3Plan P{};
  const int c = width / a_tile;
  const size_t row_bytes = 2 * static_cast<size_t>(width + 1) * sizeof(float);
  P.chunk = std::min(rows, std::max(1, PK_THREADS / (2 * c)));
  P.chunk = std::min<int>(P.chunk, static_cast<int>(SMEM_LIMIT / row_bytes));
  P.chunk_units = 2 * c * P.chunk;
  P.units = 2 * c * rows;
  P.groups = mct::scratch_groups(n_blocks, iters, 4 * PK_THREADS, P.units,
                                 cap == 0 ? K3_SCRATCH_CAP : cap);
  return P;
}

template <bool ANTI>
int launch_packed(bool kahan, const float* lt, const float* par,
                  const float* kp, int a, int a_tile, int width,
                  const K3Plan& P, uint32_t seed, uint32_t off, int n_blocks,
                  int rows, int iters, float* scratch, float* out,
                  cudaStream_t s) {
  const bool tiled = width == mct::LANES;
  const void* fn = tiled ? reinterpret_cast<const void*>(
                               &basket_tiled_kernel<ANTI>)
                         : reinterpret_cast<const void*>(
                               &basket_path_kernel<ANTI>);
  const size_t smem =
      tiled ? mct::tiled_smem_bytes(a, ANTI)
            : P.chunk * 2 * static_cast<size_t>(width + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess && tiled) {
      err = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto fold = kahan ? basket_fold_kernel<true>
                          : basket_fold_kernel<false>;
  const mct::ScratchGroups& G = P.groups;
  float* carry = scratch;
  float* items = scratch + G.blocks * 4 * PK_THREADS;
  for (int b0 = 0; b0 < n_blocks; b0 += G.blocks) {
    const int nb = std::min(G.blocks, n_blocks - b0);
    for (int i0 = 0; i0 < iters; i0 += G.iters) {
      const int ni = std::min(G.iters, iters - i0);
      const K3Items I{seed, off, b0, i0, ni, P.units};
      if (tiled) {
        basket_tiled_kernel<ANTI><<<nb * ni, mct::TILED_THREADS, smem, s>>>(
            lt, par, kp, a, a_tile, P.chunk, rows, I, items);
      } else {
        basket_path_kernel<ANTI><<<nb * ni, PK_THREADS, smem, s>>>(
            lt, par, kp, a, a_tile, width, P.chunk, rows, I, items);
      }
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      fold<<<nb, PK_THREADS, 0, s>>>(items, carry, P.units, P.chunk_units,
                                     ni, i0 == 0, i0 + ni >= iters,
                                     out + 2 * static_cast<size_t>(b0));
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
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

// Floats of K3's scratch for a launch under a cap in floats (0: 256 MB):
// per block of a group the fold's carry, per (block, iteration) item its
// units' payoffs.
extern "C" int mctpu_basket_packed_scratch_floats(int a_tile, int width,
                                                  int n_blocks, int rows,
                                                  int iters, int cap) {
  return static_cast<int>(k3_plan(a_tile, width, n_blocks, rows, iters,
                                  static_cast<size_t>(cap))
                              .groups.total);
}

extern "C" int mctpu_basket_packed(const float* lt, const float* par,
                                   const float* kp, int n_assets, int a_tile,
                                   int width, int seed, int off, int n_blocks,
                                   int rows, int iters, int antithetic,
                                   int kahan, int cap, float* scratch,
                                   float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  if (a_tile < n_assets || width % a_tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const K3Plan P = k3_plan(a_tile, width, n_blocks, rows, iters,
                           static_cast<size_t>(cap));
  if (P.chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      antithetic ? launch_packed<true>(kahan != 0, lt, par, kp, n_assets,
                                       a_tile, width, P, sd, of, n_blocks,
                                       rows, iters, scratch, out, s)
                 : launch_packed<false>(kahan != 0, lt, par, kp, n_assets,
                                        a_tile, width, P, sd, of, n_blocks,
                                        rows, iters, scratch, out, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
