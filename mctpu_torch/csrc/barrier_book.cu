// K25 and K26: the barrier book, M <= 32 knock-out calls and puts priced
// (K25) or risked (K26) on one shared walk per path.
//
// K25 replaces mctpu/kernels/barrier_book.py::_bb_kernel, K26
// ::_bb_greeks_kernel.  The stream is K12's (csrc/barrier.cu): reseed per
// (block, iteration) with (seed, (off + b) * iters + i), pairs of dates per
// Philox block, an odd n_obs taking the cosine branch of the last pair.
// Every instrument i steps its own log-spot on the path's one normal z,
// ls_i = (ls_i + drift_i) + vol_i z, dies the first date where bsgn_i (ls_i
// - log b_i) >= 0 and pays alive_i max(ksgn_i (exp(ls_i) - k_i), 0): the
// direction (bsgn = +1 up-and-out, -1 down-and-out) and the payoff sign
// (ksgn = +1 call, -1 put) are data, kept in the JAX expression, so a
// one-instrument book computes K12's path step for step.  K26 also carries
// the shared z_1, sum z and sum z^2 and forms, per instrument, K13's
// likelihood-ratio scores p z_1 c_d, p (z2s inv_v - zs sqdt - n/v) and p (zs
// c_r - t) (mctpu _bb_greek_tiles); the (7, M) and (13, M) tables are
// mctpu_torch/kernels/barrier_book.py's book_params and greek_rows.
//
// The alive flags of a path are the bits of one 32-bit mask: bit i cleared
// is alive_i = 0.  The payoff takes p where the bit is set and 0 where it is
// not, which equals alive_i * max(...) bit for bit while the payoff is
// finite (0 * x = +0 for a finite x >= 0).  The antithetic mirror steps in
// the same walk on -z of the same draw (the JAX kernel reseeds and draws
// again); its z_1 and sum z are the negated sums, exactly, and its sum z^2
// the same.
//
// Bound on the H100: float32 work, ~7 operations per instrument and date
// (step, compare, mask) beside half a Philox block and half a Box-Muller per
// date, which the whole book shares: one walk per path, drawn once.
//
// Simple design, as K12: one CUDA block of 512 threads per simulation
// block, one thread per path element striding over the (rows, 128) tile.
// A thread walks its path for every instrument at once: the G log-spots
// (twice G under antithetic) in registers, G the instrument count rounded
// up to 1, 4, 8, 16 or 32 (the unused columns copy instrument 0 and are not
// summed); the per-instrument constants in shared memory, read as
// broadcasts.  Sums: after each round of paths every per-path value (2 per
// instrument in K25, 8 in K26) is reduced over the warp by a fixed shuffle
// tree and added by lane 0 to the warp's slot in shared memory; once per
// iteration one thread per sum adds the warps' slots in order and
// Kahan-adds the total into its carry (mct::BlockAccN with its values in
// shared memory).  No atomics: two launches give the same bits.  Built with
// -fmad=false (mctpu_torch/_build.py), as every walk, for the knock-out
// compare's sake (see csrc/barrier.cu).
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BOOK = 32;
constexpr int N_PRICE_ROWS = 7;
constexpr int N_GREEK_ROWS = 13;

// The instrument constants of a simulation block, in shared memory.
template <int G>
struct Consts {
  float log_s0[G];
  float4 step[G];  // drift, vol, log b, bsgn
  float4 pay[G];   // k, ksgn, c_d, inv_v
  float4 lr[G];    // sqdt, n/v, c_r, t (K26)
};

// Loads the table's columns (rows n_rows, m instruments) into c; column i
// >= m copies instrument 0.
template <int G>
__device__ __forceinline__ void load_consts(const float* __restrict__ table,
                                            int n_rows, int m,
                                            Consts<G>& c) {
  for (int i = threadIdx.x; i < G; i += THREADS) {
    const float* col = table + (i < m ? i : 0);
    auto at = [&](int row) { return row < n_rows ? col[row * m] : 0.0f; };
    c.log_s0[i] = at(0);
    c.step[i] = make_float4(at(3), at(4), at(2), at(5));
    c.pay[i] = make_float4(at(1), at(6), at(7), at(8));
    c.lr[i] = make_float4(at(9), at(10), at(11), at(12));
  }
}

// Instrument i's step constants.  Up to 8 instruments they may stay in
// registers across the walk; beyond, a volatile shared load per date keeps
// the compiler from hoisting 4 G of them out of the loop into registers it
// does not have.
template <int G>
__device__ __forceinline__ float4 step_consts(const Consts<G>& c, int i) {
  if constexpr (G <= 8) {
    return c.step[i];
  } else {
    float4 v;
    asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(static_cast<unsigned>(
                     __cvta_generic_to_shared(&c.step[i]))));
    return v;
  }
}

// Per-warp slots of NS sums in shared memory, and the carry of sum
// threadIdx.x (< NS).
template <int NS, bool KAHAN>
struct SlotAcc {
  float s = 0.0f, c = 0.0f;

  __device__ __forceinline__ static void zero(float* sh) {
    for (int k = threadIdx.x; k < WARPS * NS; k += THREADS) sh[k] = 0.0f;
  }

  // Adds the warp's sum of r (a fixed shuffle tree) into slot k.
  __device__ __forceinline__ static void warp_add(float r, float* sh, int k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      r = __fadd_rn(r, __shfl_down_sync(0xffffffffu, r, o));
    }
    if ((threadIdx.x & 31) == 0) {
      float& slot = sh[(threadIdx.x >> 5) * NS + k];
      slot = __fadd_rn(slot, r);
    }
  }

  // Once per iteration, by every thread: the first n sums take the warps'
  // slots in order into their carries; the slots are zeroed.
  __device__ __forceinline__ void fold(float* sh, int n) {
    __syncthreads();
    if (threadIdx.x < n) {
      float t = 0.0f;
      for (int w = 0; w < WARPS; ++w) {
        float& slot = sh[w * NS + threadIdx.x];
        t = __fadd_rn(t, slot);
        slot = 0.0f;
      }
      if (KAHAN) {
        mct::kahan_add(s, c, t);
      } else {
        s = __fadd_rn(s, t);
      }
    }
    __syncthreads();
  }

  __device__ __forceinline__ void write(float* dst, int n) const {
    if (threadIdx.x < n) dst[threadIdx.x] = __fadd_rn(s, c);
  }
};

// A path's state: G log-spots and their alive bits, and the mirror's.
template <int G, bool ANTI>
struct Walk {
  float ls[G];
  float lm[ANTI ? G : 1];
  uint32_t alive, alive_m;
  float z1, zs, z2s;  // first normal, sum z, sum z^2 (K26)
};

// Walks tile element e over n_obs dates; a lane past the tile is dead.
template <int G, bool ANTI, bool SCORES>
__device__ __forceinline__ void walk(const Consts<G>& c, int n_obs,
                                     mct::Key key, int e, int n_elems,
                                     Walk<G, ANTI>& w) {
  w.alive = w.alive_m = e < n_elems ? 0xffffffffu : 0u;
  w.z1 = w.zs = w.z2s = 0.0f;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    w.ls[i] = c.log_s0[i];
    if (ANTI) w.lm[i] = c.log_s0[i];
  }
  mct::walk_pairwise(key, static_cast<uint32_t>(e), n_obs, [&](int j,
                                                               float z) {
    if (SCORES) {
      if (j == 0) w.z1 = z;
      w.zs = w.zs + z;
      w.z2s = w.z2s + z * z;
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float4 s = step_consts<G>(c, i);
      w.ls[i] = (w.ls[i] + s.x) + s.y * z;
      const bool hit = s.w * (w.ls[i] - s.z) >= 0.0f;
      w.alive &= ~(static_cast<uint32_t>(hit) << i);
      if (ANTI) {
        w.lm[i] = (w.lm[i] + s.x) + s.y * (-z);
        const bool hit_m = s.w * (w.lm[i] - s.z) >= 0.0f;
        w.alive_m &= ~(static_cast<uint32_t>(hit_m) << i);
      }
    }
  });
}

// Instrument i's payoff at log-spot ls, 0 where its bit of alive is clear.
template <int G>
__device__ __forceinline__ float payoff(const Consts<G>& c, int i, float ls,
                                        uint32_t alive) {
  const float4 p = c.pay[i];
  const float x = fmaxf(p.y * (expf(ls) - p.x), 0.0f);
  return ((alive >> i) & 1u) ? x : 0.0f;
}

// ---------------------------------------------------------------- K25 price

template <int G, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(THREADS, 1)
    bb_kernel(const float* __restrict__ table, int m, int n_obs,
              uint32_t seed, uint32_t off, int n_elems, int iters,
              float* __restrict__ out) {
  constexpr int NS = 2 * G;
  __shared__ Consts<G> c;
  __shared__ float sh[WARPS * NS];
  load_consts<G>(table, N_PRICE_ROWS, m, c);
  SlotAcc<NS, KAHAN>::zero(sh);
  __syncthreads();
  SlotAcc<NS, KAHAN> acc;
  for (int it = 0; it < iters; ++it) {
    const uint32_t word = (off + blockIdx.x) * static_cast<uint32_t>(iters) +
                          static_cast<uint32_t>(it);
    const mct::Key key = mct::seed_key(seed, word);
    for (int base = 0; base < n_elems; base += THREADS) {
      Walk<G, ANTI> w;
      walk<G, ANTI, false>(c, n_obs, key, base + threadIdx.x, n_elems, w);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (i < m) {
          float p = payoff<G>(c, i, w.ls[i], w.alive);
          if (ANTI) p = 0.5f * (p + payoff<G>(c, i, w.lm[i], w.alive_m));
          SlotAcc<NS, KAHAN>::warp_add(p, sh, 2 * i);
          SlotAcc<NS, KAHAN>::warp_add(p * p, sh, 2 * i + 1);
        }
      }
    }
    acc.fold(sh, 2 * m);
  }
  acc.write(out + static_cast<size_t>(blockIdx.x) * 2 * m, 2 * m);
}

// --------------------------------------------------------------- K26 Greeks

// Instrument i's (p, delta, vega, rho) integrands on one walk's end state.
template <int G>
__device__ __forceinline__ void scores(const Consts<G>& c, int i, float ls,
                                       uint32_t alive, float z1, float zs,
                                       float z2s, float (&q)[4]) {
  const float p = payoff<G>(c, i, ls, alive);
  const float4 a = c.pay[i];  // k, ksgn, c_d, inv_v
  const float4 b = c.lr[i];   // sqdt, n/v, c_r, t
  q[0] = p;
  q[1] = p * z1 * a.z;
  q[2] = p * (z2s * a.w - zs * b.x - b.y);
  q[3] = p * (zs * b.z - b.w);
}

template <int G, bool ANTI, bool KAHAN>
__global__ void __launch_bounds__(THREADS, 1)
    bb_greeks_kernel(const float* __restrict__ table, int m, int n_obs,
                     uint32_t seed, uint32_t off, int n_elems, int iters,
                     float* __restrict__ out) {
  constexpr int NS = 8 * G;
  __shared__ Consts<G> c;
  __shared__ float sh[WARPS * NS];
  load_consts<G>(table, N_GREEK_ROWS, m, c);
  SlotAcc<NS, KAHAN>::zero(sh);
  __syncthreads();
  SlotAcc<NS, KAHAN> acc;
  for (int it = 0; it < iters; ++it) {
    const uint32_t word = (off + blockIdx.x) * static_cast<uint32_t>(iters) +
                          static_cast<uint32_t>(it);
    const mct::Key key = mct::seed_key(seed, word);
    for (int base = 0; base < n_elems; base += THREADS) {
      Walk<G, ANTI> w;
      walk<G, ANTI, true>(c, n_obs, key, base + threadIdx.x, n_elems, w);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (i < m) {
          float q[4];
          scores<G>(c, i, w.ls[i], w.alive, w.z1, w.zs, w.z2s, q);
          if (ANTI) {
            float qm[4];
            scores<G>(c, i, w.lm[i], w.alive_m, -w.z1, -w.zs, w.z2s, qm);
#pragma unroll
            for (int j = 0; j < 4; ++j) q[j] = 0.5f * (q[j] + qm[j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            SlotAcc<NS, KAHAN>::warp_add(q[j], sh, 8 * i + 2 * j);
            SlotAcc<NS, KAHAN>::warp_add(q[j] * q[j], sh, 8 * i + 2 * j + 1);
          }
        }
      }
    }
    acc.fold(sh, 8 * m);
  }
  acc.write(out + static_cast<size_t>(blockIdx.x) * 8 * m, 8 * m);
}

template <int G, bool ANTI, bool KAHAN>
void launch(bool greeks, const float* table, int m, int n_obs, uint32_t seed,
            uint32_t off, int n_blocks, int n_elems, int iters, float* out,
            cudaStream_t stream) {
  if (greeks) {
    bb_greeks_kernel<G, ANTI, KAHAN><<<n_blocks, THREADS, 0, stream>>>(
        table, m, n_obs, seed, off, n_elems, iters, out);
  } else {
    bb_kernel<G, ANTI, KAHAN><<<n_blocks, THREADS, 0, stream>>>(
        table, m, n_obs, seed, off, n_elems, iters, out);
  }
}

template <bool ANTI, bool KAHAN>
void launch_g(bool greeks, const float* table, int m, int n_obs,
              uint32_t seed, uint32_t off, int n_blocks, int n_elems,
              int iters, float* out, cudaStream_t stream) {
  if (m <= 1) {
    launch<1, ANTI, KAHAN>(greeks, table, m, n_obs, seed, off, n_blocks,
                           n_elems, iters, out, stream);
  } else if (m <= 4) {
    launch<4, ANTI, KAHAN>(greeks, table, m, n_obs, seed, off, n_blocks,
                           n_elems, iters, out, stream);
  } else if (m <= 8) {
    launch<8, ANTI, KAHAN>(greeks, table, m, n_obs, seed, off, n_blocks,
                           n_elems, iters, out, stream);
  } else if (m <= 16) {
    launch<16, ANTI, KAHAN>(greeks, table, m, n_obs, seed, off, n_blocks,
                            n_elems, iters, out, stream);
  } else {
    launch<32, ANTI, KAHAN>(greeks, table, m, n_obs, seed, off, n_blocks,
                            n_elems, iters, out, stream);
  }
}

int dispatch(bool greeks, const float* table, int m, int seed, int off,
             int n_blocks, int rows, int iters, int antithetic, int n_obs,
             int kahan, float* out, void* stream) {
  if (m < 1 || m > MAX_BOOK || n_blocks < 1 || n_obs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t sd = static_cast<uint32_t>(seed);
  const uint32_t of = static_cast<uint32_t>(off);
  const int n = rows * mct::LANES;
  switch ((antithetic ? 2 : 0) | (kahan ? 1 : 0)) {
    case 0: launch_g<false, false>(greeks, table, m, n_obs, sd, of, n_blocks, n, iters, out, s); break;
    case 1: launch_g<false, true>(greeks, table, m, n_obs, sd, of, n_blocks, n, iters, out, s); break;
    case 2: launch_g<true, false>(greeks, table, m, n_obs, sd, of, n_blocks, n, iters, out, s); break;
    default: launch_g<true, true>(greeks, table, m, n_obs, sd, of, n_blocks, n, iters, out, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (7, m: log s0, k, log b, drift, vol, bsgn, ksgn) -> out
// (n_blocks, m, 2).
extern "C" int mctpu_barrier_book(const float* table, int m, int seed,
                                  int off, int n_blocks, int rows, int iters,
                                  int antithetic, int n_obs, int kahan,
                                  float* out, void* stream) {
  return dispatch(false, table, m, seed, off, n_blocks, rows, iters,
                  antithetic, n_obs, kahan, out, stream);
}

// table (13, m: the seven pricing rows, c_d, inv_v, sqdt, n/v, c_r, t) ->
// out (n_blocks, m, 8).
extern "C" int mctpu_barrier_book_greeks(const float* table, int m, int seed,
                                         int off, int n_blocks, int rows,
                                         int iters, int antithetic, int n_obs,
                                         int kahan, float* out, void* stream) {
  return dispatch(true, table, m, seed, off, n_blocks, rows, iters,
                  antithetic, n_obs, kahan, out, stream);
}
