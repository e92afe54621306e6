// The lane-packed walk's pass structure, shared by the packed kernels of
// multi_walk.cu (K31, K33, K35) and cva_multi.cu (K39, K41): a (rows, width)
// tile packs c paths of a_tile lanes a row (a assets or underlyings each,
// the rest padding); a CUDA block walks it in passes of chunk_rows rows,
// one thread per packed path, with the pass's normals (and, in the
// kernels, its walk state) in shared memory (draw_pass), or, in K31's
// register instances (a_tile 16 and 32), in the path's thread, which draws
// its own lanes.  Pair jj of a pass draws Philox block (row * width + lane,
// jj) for each real lane (the JAX kernels' walk_pairwise over the flat tile
// index).
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
// split evenly over them (set_chunk_even).  K33, K35 and K41 take a power
// of two chunk_rows that divides rows (set_chunk_pow2): their passes hold
// the rows that the first log2(chunk_rows) levels of mctpu's halving tree
// over the rows (det_col_sums) add together, so they can take that tree
// pass by pass (pass_tree, then fold_passes).  Where both give one shape (rows a power of two, K31's bound a
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
// log-spots of one or both signs within PK_SMEM_LIMIT (K31's register
// instances take the pass and leave smem unused).
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

// The packed Greek kernels' budget (K33, K35, K41): the 227 KB a block may
// take, less a margin for the static shared memory of its block reduction.
constexpr size_t PK_GREEK_SMEM_LIMIT = 220 * 1024;

// A packed Greek kernel's pass (K33, K35, K41): about one path per thread,
// a power of two of rows (set_chunk_pow2), and the block's shared floats --
// both dates' normals (2 ap) and lane_floats per lane of each path, then
// per pass the (dval, dval^2, vval, vval^2) lane rows its rows add up to
// ([n_chunks][4][width]) and the block's running lane rows ([4][width]) --
// within PK_GREEK_SMEM_LIMIT, halving the pass as needed (chunk_rows 0 if
// even one row does not fit).
inline Packed greek_shape(int a, int a_tile, int width, int rows,
                          int lane_floats, size_t& smem) {
  Packed P = packed_base(a, a_tile, width);
  int bound = std::max(1, PK_THREADS / P.c);
  for (;;) {
    set_chunk_pow2(P, rows, bound);
    const size_t per_path = 2 * static_cast<size_t>(P.ap) +
                            static_cast<size_t>(lane_floats) * P.a;
    smem = (static_cast<size_t>(P.np_max) * per_path +
            (4 * static_cast<size_t>(P.n_chunks) + 4) * P.width) *
           sizeof(float);
    if (smem <= PK_GREEK_SMEM_LIMIT || P.chunk_rows <= 1) break;
    bound = P.chunk_rows / 2;
  }
  if (smem > PK_GREEK_SMEM_LIMIT) P.chunk_rows = 0;
  return P;
}

// In place over a column of n = 2^m values at stride ld: the (sum, sum of
// squares) of mctpu's halving tree, the squares formed at the leaves.
__device__ __forceinline__ void halving_pair(float* col, int n, int ld,
                                             float& sum, float& sum2) {
  if (n == 1) {
    sum = col[0];
    sum2 = col[0] * col[0];
    return;
  }
  const int half = n / 2;
  for (int j = 0; j < half; ++j) {
    const float x = col[j * ld], y = col[(j + half) * ld];
    col[j * ld] = x + y;
    col[(j + half) * ld] = x * x + y * y;
  }
  for (int h = half / 2; h > 0; h >>= 1) {
    for (int j = 0; j < h; ++j) {
      col[j * ld] = col[j * ld] + col[(j + h) * ld];
      col[(half + j) * ld] = col[(half + j) * ld] + col[(half + j + h) * ld];
    }
  }
  sum = col[0];
  sum2 = col[half * ld];
}

// The first log2(chunk_rows) levels of the halving tree over the rows of
// pass c0: one thread per (quantity, lane) column of the pass's (dval,
// vval) leaves ([2][chunk_rows][width]) into its (dval, dval^2, vval,
// vval^2) rows of part ([n_chunks][4][width]).
__device__ __forceinline__ void pass_tree(const Packed& P, int c0,
                                          float* leaf, float* part) {
  const int W = P.width, nr = P.chunk_rows;
  for (int u = threadIdx.x; u < 2 * W; u += PK_THREADS) {
    const int qty = u / W;
    const int lane = u - qty * W;
    float s1, s2;
    halving_pair(leaf + qty * nr * W + lane, nr, W, s1, s2);
    part[(4 * c0 + 2 * qty) * W + lane] = s1;
    part[(4 * c0 + 2 * qty + 1) * W + lane] = s2;
  }
}

// pass_tree's levels over the (dval, vval) leaves where the register
// kernels (K33's, K35's, K41's) and K35's shared-memory kernel write them:
// lane p a_tile + m of local row rl at d[m np + rl c + p] (vval at v
// likewise), so a column's rows stand c apart; padded lanes sum to exact
// zeros.
__device__ __forceinline__ void bar_leaf_tree(const Packed& P, int c0,
                                              float* d, float* v,
                                              float* part) {
  const int W = P.width;
  for (int u = threadIdx.x; u < 2 * W; u += PK_THREADS) {
    const int qty = u / W;
    const int lane = u - qty * W;
    const int pth = lane / P.a_tile;
    const int m = lane - pth * P.a_tile;
    float s1 = 0.0f, s2 = 0.0f;
    if (m < P.a) {
      halving_pair((qty ? v : d) + m * P.np_max + pth, P.chunk_rows, P.c, s1,
                   s2);
    }
    part[(4 * c0 + 2 * qty) * W + lane] = s1;
    part[(4 * c0 + 2 * qty + 1) * W + lane] = s2;
  }
}

// The tree's remaining levels over the passes (odd rows carried, as
// det_col_sums), added into the block's lane rows vec ([4][width]) in plain
// float32.
__device__ __forceinline__ void fold_passes(const Packed& P, float* part,
                                            float* vec) {
  const int ld = 4 * P.width;
  for (int u = threadIdx.x; u < ld; u += PK_THREADS) {
    float* col = part + u;
    int n = P.n_chunks;
    while (n > 1) {
      const int half = n / 2;
      for (int j = 0; j < half; ++j) {
        col[j * ld] = col[j * ld] + col[(j + half) * ld];
      }
      if (n & 1) col[half * ld] = col[(n - 1) * ld];
      n = half + (n & 1);
    }
    vec[u] = vec[u] + col[0];
  }
}

}  // namespace mct
