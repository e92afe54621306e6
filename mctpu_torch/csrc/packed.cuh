// The lane-packed walk's pass structure, shared by the packed kernels of
// multi_walk.cu (K31, K33, K35) and cva_multi.cu (K39): a (rows, width)
// tile packs c paths of a_tile lanes a row (a assets or underlyings each,
// the rest padding); a CUDA block walks it in passes of chunk_rows rows,
// one thread per packed path, with the pass's normals (and, in the
// kernels, its walk state) in shared memory.  Pair jj of a pass draws
// Philox block (row * width + lane, jj) for each real lane (the JAX
// kernels' walk_pairwise over the flat tile index).
#pragma once

#include <algorithm>

#include "common.cuh"

namespace mct {

constexpr int PK_THREADS = 256;
constexpr size_t PK_SMEM_LIMIT = 160 * 1024;

// The packed walk's shape: a assets in a_tile lanes, c paths a row, and a
// pass over chunk_rows rows (np_max = chunk_rows * c paths, one a thread);
// each path's normals sit in shared memory at stride ap = a | 1 (odd: the
// threads of a warp, one path each, hit distinct banks).  Pass c0 of the
// n_chunks passes walks the rows c0, c0 + n_chunks, c0 + 2 n_chunks, ...
// below rows.  K31 and K39 take the fewest passes their bound allows, rows
// split evenly over them (set_chunk_even).  K33 and K35 take a power of two
// chunk_rows that divides rows (set_chunk_pow2): their passes hold the rows
// that the first log2(chunk_rows) levels of mctpu's halving tree over the
// rows (det_col_sums) add together, so they can take that tree pass by
// pass.  Where both give one shape (rows a power of two, K31's bound a
// power of two), a thread sums the same paths in the same order in both.
struct Packed {
  int a, a_tile, width, c, chunk_rows, np_max, ap, n_chunks;
};

inline Packed packed_base(int a, int a_tile, int width) {
  return Packed{a, a_tile, width, width / a_tile, 0, 0, a | 1, 0};
}

// K31, K39: ceil(rows / bound) passes of at most ceil(rows / n_chunks) rows
// each (0 if bound < 1).
inline void set_chunk_even(Packed& P, int rows, int bound) {
  P.n_chunks = bound < 1 ? 0 : (rows + bound - 1) / bound;
  P.chunk_rows = P.n_chunks > 0 ? (rows + P.n_chunks - 1) / P.n_chunks : 0;
  P.np_max = P.chunk_rows * P.c;
}

// K33, K35: the largest power of two up to bound that divides rows (0 if
// bound < 1), so every pass holds chunk_rows rows.
inline void set_chunk_pow2(Packed& P, int rows, int bound) {
  int nr = bound < 1 ? 0 : 1;
  while (nr > 0 && nr * 2 <= bound && rows % (nr * 2) == 0) nr *= 2;
  P.chunk_rows = nr;
  P.np_max = nr * P.c;
  P.n_chunks = nr > 0 ? rows / nr : 0;
}

// The global row of local row rl in pass c0.
__device__ __forceinline__ int pass_row(const Packed& P, int c0, int rl) {
  return c0 + rl * P.n_chunks;
}

// Draws the normals of one pair of dates of pass c0 into z1s and z2s (path
// q's a normals at q * ap; padded lanes and rows past rows are never
// drawn).
template <int THREADS>
__device__ __forceinline__ void draw_pass(const Packed& P, Key key,
                                          int rows, int c0, int jj,
                                          float* z1s, float* z2s) {
  for (int t = threadIdx.x; t < P.chunk_rows * P.width; t += THREADS) {
    const int rl = t / P.width;
    const int lane = t - rl * P.width;
    const int p = lane / P.a_tile;
    const int m = lane - p * P.a_tile;
    const int row = pass_row(P, c0, rl);
    if (m < P.a && row < rows) {
      float z1, z2;
      draw_normal_pair(
          key, static_cast<uint32_t>(row * P.width + lane),
          static_cast<uint32_t>(jj), z1, z2);
      const int slot = (rl * P.c + p) * P.ap + m;
      z1s[slot] = z1;
      z2s[slot] = z2;
    }
  }
}

// K31's and K39's pass: about one path per thread, its normals and the
// log-spots of one or both signs within PK_SMEM_LIMIT.
inline Packed packed_shape(int a, int a_tile, int width, int rows,
                           bool anti, size_t& smem) {
  Packed P = packed_base(a, a_tile, width);
  const size_t floats = 2 * static_cast<size_t>(P.ap) +
                        (anti ? 2 : 1) * static_cast<size_t>(a);
  const size_t path_bytes = floats * sizeof(float);
  const int bound =
      std::min(std::max(1, PK_THREADS / P.c),
               static_cast<int>(PK_SMEM_LIMIT / (P.c * path_bytes)));
  set_chunk_even(P, rows, bound);
  smem = static_cast<size_t>(P.np_max) * path_bytes;
  return P;
}

}  // namespace mct
