// K1: fused European call/put Monte Carlo.
//
// Replaces mctpu/kernels/vanilla.py::_vanilla_kernel (its pallas_call in
// pallas_partials).  Per simulation block b: seed the stream with
// (seed, off + b); in iteration i, tile element e draws Philox block
// (e, i, 0, 0), whose two Box-Muller branches are two terminal GBM draws;
// payoff max(+-(s0 exp(mu + sig z) - k), 0), pair-meaned under antithetic;
// the block's (sum p, sum p^2), Neumaier-compensated under Kahan.
//
// Bound on the H100: arithmetic.  Per pair of paths: 10 Philox rounds (two
// 32-bit mul.hi/lo each), one logf and sqrtf, the sin/cos polynomials and
// two expf (four under antithetic); the only memory traffic is 8 bytes of
// partials per block.  Simple design: one CUDA block per simulation block,
// its 256 threads striding over the tile's rows * 128 elements each
// iteration with the running sums in registers, then one fixed-order
// shared-memory tree.  Each block writes its own row, so there is no atomic
// and two launches give the same bits.  Fewer simulation blocks than about
// 4 x 132 leave SMs idle (see PERF.md).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <bool PUT>
__device__ __forceinline__ float pay(float s0, float k, float mu, float sig,
                                     float z) {
  const float st = s0 * expf(mu + sig * z);
  return PUT ? fmaxf(k - st, 0.0f) : fmaxf(st - k, 0.0f);
}

template <bool ANTI, bool PUT>
__device__ __forceinline__ float payoff(float s0, float k, float mu, float sig,
                                        float z) {
  if (ANTI) {
    return 0.5f * (pay<PUT>(s0, k, mu, sig, z) + pay<PUT>(s0, k, mu, sig, -z));
  }
  return pay<PUT>(s0, k, mu, sig, z);
}

template <bool ANTI, bool PUT, bool KAHAN>
__global__ void __launch_bounds__(THREADS)
    vanilla_kernel(const float* __restrict__ par, uint32_t seed, uint32_t off,
                   int n_elems, int iters, float* __restrict__ out) {
  const mct::Key key = mct::seed_key(seed, off + blockIdx.x);
  const float s0 = par[0], k = par[1], mu = par[2], sig = par[3];
  mct::Acc2<KAHAN> acc;
  for (int i = 0; i < iters; ++i) {
    for (int e = threadIdx.x; e < n_elems; e += THREADS) {
      float z1, z2;
      mct::draw_normal_pair(key, e, i, z1, z2);
      acc.add(payoff<ANTI, PUT>(s0, k, mu, sig, z1));
      acc.add(payoff<ANTI, PUT>(s0, k, mu, sig, z2));
    }
  }
  mct::write_block_sums<THREADS, KAHAN>(acc, out);
}

template <bool ANTI, bool PUT, bool KAHAN>
void launch(const float* par, uint32_t seed, uint32_t off, int n_blocks,
            int n_elems, int iters, float* out, cudaStream_t stream) {
  vanilla_kernel<ANTI, PUT, KAHAN>
      <<<n_blocks, THREADS, 0, stream>>>(par, seed, off, n_elems, iters, out);
}

}  // namespace

extern "C" int mctpu_vanilla(const float* par, int seed, int off, int n_blocks,
                             int rows, int iters, int antithetic, int put,
                             int kahan, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int n = rows * mct::LANES;
  switch ((antithetic ? 4 : 0) | (put ? 2 : 0) | (kahan ? 1 : 0)) {
    case 0: launch<false, false, false>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 1: launch<false, false, true>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 2: launch<false, true, false>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 3: launch<false, true, true>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 4: launch<true, false, false>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 5: launch<true, false, true>(par, sd, of, n_blocks, n, iters, out, s); break;
    case 6: launch<true, true, false>(par, sd, of, n_blocks, n, iters, out, s); break;
    default: launch<true, true, true>(par, sd, of, n_blocks, n, iters, out, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mctpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
