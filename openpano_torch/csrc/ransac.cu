// RANSAC for Hopper (sm_90a): the hypotheses' draws, fits and scores, the
// best hypothesis, its refit and the acceptance gates of a batch of image
// pairs, in one launch with one block a pair.
//
// Replaces no Pallas kernel: the JAX package leaves estimate_transform
// (openpano_tpu/geometry/ransac.py) to XLA, which fuses its batched chain.
// PyTorch runs that chain eagerly: about 1,400 launches of small operators
// for each chunk of 32 pairs, some 30,900 for the 703 pairs of a 38-view
// panorama, each costing the host more than the card spends on it, and its
// scoring step holds [32, 1500, 1024, 2] float32 projections (393 MB) in
// device memory.  This kernel computes what the plain version
// (estimate_transform_plain in openpano_torch/geometry/ransac.py) computes,
// with no host synchronisation and nothing of size [hypotheses, matches]
// outside registers.
//
// What bounds it on an H100: operations.  Scoring projects every match row
// under every hypothesis, 1500 x 1024 rows a pair with two IEEE divisions
// and some 20 other float32 operations each; a 703-pair panorama reads
// 35 MB.  The design keeps a pair's match rows in shared memory (read by
// every thread of the block at the same address, a broadcast), each
// hypothesis's state in one thread's registers, and scores only rows up to
// the last valid one, so a pair with few matches costs little.
//
// Block p, in order:
//   1. stage: the pair's match rows as float2 p1 (image i) and p2 (image j)
//      gathered from the keypoints by the match indices, and their valid
//      bits, into shared memory; the inlier threshold of image i's size.
//   2. hypotheses, one a thread in turn: ns rows drawn by Threefry-2x32 on
//      the pair's key (prng.uniform_f64's bits and the plain version's
//      clamps), the scale-normalised DLT (8x8, or 6x6 affine) solved by the
//      unrolled Cholesky of dlt._chol_solve_small, health, and the count of
//      valid rows within the threshold (-1 when unhealthy).
//   3. best: the block's argmax of (score, -h): the first best, as
//      torch.argmax.
//   4. refit: the best hypothesis's inlier mask recounted with the same
//      projection and listed in row order (a block scan), then the DLT
//      over those rows, its sums in fixed orders (no float atomics) and
//      solved by one thread.
//   5. gates: the inverse by the adjugate, the overlap counts of the match
//      rows and of both images' keypoints, the OVERLAP_AREA_GRID^2 lattice,
//      the ratios, the confidence and success.
//   6. output: the inliers written first in row order, and the rest of
//      MatchInfo.
//
// Rounding: every operation rounds where the plain version's PyTorch
// operators round it on the card (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn keep nvcc from contracting; a division by a Python number is
// PyTorch's multiplication by its float32 reciprocal there), and the
// hypotheses' fits sum in the orders the card's matrix-product and
// reduction kernels take (measured on an H100; fit_hypothesis says which),
// so a hypothesis here is the plain version's to the bit and counts the
// same rows.  The refit's sums take the orders measured at M = 1024
// (refit_sums); at another M the card's kernels may take others, and the
// transform may then differ from the plain version's in its last bits.
// The orders are those of PyTorch 2.11 built for CUDA 12.8, with the
// cuBLAS it ships; another version may take others.  So the tests gate
// the kernel on what no summation order moves (a float64 refit of its own
// inliers, the CPU's plain version within rounding's flips) and report the
// bit-equality with the card's plain version without gating on it.
//
// Plain C interface (loaded with ctypes).  The launcher returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / LANES;
constexpr unsigned FULL = 0xffffffffu;

// Constants of the plain version, named where they live there.
constexpr float RIDGE = 1e-9f;          // dlt._weighted_lstsq
constexpr float CHOL_FLOOR = 1e-30f;    // dlt._chol_solve_small
constexpr float SQR_FLOOR = 1e-12f;     // dlt._norm_scale
constexpr float DET_EPS = 1e-12f;       // homography.homo_inverse
constexpr float DENOM_EPS = 1e-20f;     // homography.trans2d
constexpr float RES_SCALE = 800.f;      // ransac: the threshold's image size
constexpr float AREA_MIN = 0.15f;       // ransac: overlap area share
constexpr float POINT_MIN = 0.01f;      // ransac: keypoint ratio bounds

struct Gates {
  int min_match;         // ESTIMATE_MIN_NR_MATCH
  float inlier_thres;    // RANSAC_INLIER_THRES
  float match_ratio;     // INLIER_IN_MATCH_RATIO
  float points_ratio;    // INLIER_IN_POINTS_RATIO
  float max_persp;       // HOMO_MAX_PERSPECTIVE
  int grid;              // OVERLAP_AREA_GRID
};

struct Images {          // one side of the pairs: [N, K, 2], [N, K], [N, 2]
  const float* pos;
  const uint8_t* valid;
  const float* wh;
  int K;
};

struct Out {
  float* homo;           // [P, 3, 3]
  float* conf;           // [P]
  float2* to_pos;        // [P, M]
  float2* from_pos;      // [P, M]
  uint8_t* valid;        // [P, M]
  long long* count;      // [P]
};

// torch.clamp(v, min=lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// --------------------------------------------------------------------------
// Threefry-2x32, 20 rounds (utils/prng.threefry2x32)

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int R[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x0 += x1;
      x1 = rotl(x1, R[i % 2][q]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// The row of draw c (= h * ns + s) under the pair's key: uniform_f64's
// top 52 bits as a double in [0, 1), scaled by max(n, 1), truncated, then
// clamped to max(n - 1, 0) and to the buffer's last row.
__device__ __forceinline__ int draw_row(uint32_t k0, uint32_t k1,
                                        unsigned long long c, double hi,
                                        long long top, int M) {
  uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
  threefry(k0, k1, x0, x1);
  const unsigned long long mant =
      ((unsigned long long)x0 << 20) | (unsigned long long)(x1 >> 12);
  const double u = __dmul_rn((double)mant, 0x1p-52);
  long long q = (long long)__dmul_rn(u, hi);
  q = min(q, top);
  return (int)min(q, (long long)(M - 1));
}

// --------------------------------------------------------------------------
// Homographies (geometry/homography.py), rounded as its operators

// trans2d of one point: (px, py) and the depth z
__device__ __forceinline__ void project(const float* H, float x, float y,
                                        float& px, float& py, float& z) {
  const float o0 = __fadd_rn(__fadd_rn(__fmul_rn(H[0], x), __fmul_rn(H[1], y)), H[2]);
  const float o1 = __fadd_rn(__fadd_rn(__fmul_rn(H[3], x), __fmul_rn(H[4], y)), H[5]);
  z = __fadd_rn(__fadd_rn(__fmul_rn(H[6], x), __fmul_rn(H[7], y)), H[8]);
  const float d = fabsf(z) > 0.f ? z : (z >= 0.f ? DENOM_EPS : -DENOM_EPS);
  px = __fdiv_rn(o0, d);
  py = __fdiv_rn(o1, d);
}

// Whether H maps p2 within the threshold of p1: the scoring test, used by
// the hypotheses' scores and by the winner's recount alike.
__device__ __forceinline__ bool inlier(const float* H, float2 a, float2 b,
                                       float thr2) {
  float px, py, z;
  project(H, b.x, b.y, px, py, z);
  const float dx = __fsub_rn(px, a.x), dy = __fsub_rn(py, a.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < thr2;
}

__device__ __forceinline__ bool health(const float* H, float max_persp) {
  return fabsf(H[6]) <= max_persp && fabsf(H[7]) <= max_persp &&
         __fadd_rn(H[4], H[5]) > H[5] &&
         __fadd_rn(__fadd_rn(H[0], H[1]), H[2]) > __fadd_rn(H[1], H[2]);
}

// shifted_in: inside the half-shifted (w, h) frame
__device__ __forceinline__ bool shifted_in(float w, float h, float x,
                                           float y) {
  const float hw = __fmul_rn(w, 0.5f), hh = __fmul_rn(h, 0.5f);
  return x >= -hw && x < hw && y >= -hh && y < hh;
}

// overlap_mask_in1 of a point given in image-1 coords under H12
__device__ __forceinline__ bool overlap(const float* H12, float w1, float h1,
                                        float w2, float h2, float x, float y) {
  float px, py, z;
  project(H12, x, y, px, py, z);
  return shifted_in(w1, h1, x, y) && shifted_in(w2, h2, px, py) && z > 0.f;
}

// homo_inverse: the adjugate over the determinant, the identity and false
// where |det| <= 1e-12
__device__ bool homo_inverse(const float* e, float* inv) {
  const float c0 = __fsub_rn(__fmul_rn(e[4], e[8]), __fmul_rn(e[5], e[7]));
  const float c1 = __fsub_rn(__fmul_rn(e[3], e[8]), __fmul_rn(e[5], e[6]));
  const float c2 = __fsub_rn(__fmul_rn(e[3], e[7]), __fmul_rn(e[4], e[6]));
  const float det = __fadd_rn(
      __fsub_rn(__fmul_rn(e[0], c0), __fmul_rn(e[1], c1)), __fmul_rn(e[2], c2));
  const bool ok = fabsf(det) > DET_EPS;
  const float d = ok ? det : 1.f;
  const float adj[9] = {
      __fsub_rn(__fmul_rn(e[4], e[8]), __fmul_rn(e[5], e[7])),
      __fsub_rn(__fmul_rn(e[2], e[7]), __fmul_rn(e[1], e[8])),
      __fsub_rn(__fmul_rn(e[1], e[5]), __fmul_rn(e[2], e[4])),
      __fsub_rn(__fmul_rn(e[5], e[6]), __fmul_rn(e[3], e[8])),
      __fsub_rn(__fmul_rn(e[0], e[8]), __fmul_rn(e[2], e[6])),
      __fsub_rn(__fmul_rn(e[2], e[3]), __fmul_rn(e[0], e[5])),
      __fsub_rn(__fmul_rn(e[3], e[7]), __fmul_rn(e[4], e[6])),
      __fsub_rn(__fmul_rn(e[1], e[6]), __fmul_rn(e[0], e[7])),
      __fsub_rn(__fmul_rn(e[0], e[4]), __fmul_rn(e[1], e[3]))};
#pragma unroll
  for (int k = 0; k < 9; ++k)
    inv[k] = ok ? __fdiv_rn(adj[k], d) : (k % 4 == 0 ? 1.f : 0.f);
  return ok;
}

// --------------------------------------------------------------------------
// The normalised DLT (geometry/dlt.py)

template <bool AFFINE>
struct Dlt {
  static constexpr int NS = AFFINE ? 7 : 8;  // rows a hypothesis draws
  static constexpr int NP = AFFINE ? 6 : 8;  // parameters
  static constexpr int NT = NP * (NP + 1) / 2;
  static constexpr int NV = NT + NP;         // lower AtA, then Atb
};

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// A match's two rows of the stacked system in normalised coords (x row: y
// false; perspective_dlt / affine_dlt): whether entry i can be non-zero,
// and the value of such an entry.  A zero entry adds an exact zero to any
// sum, so the sums skip it.
template <bool AFFINE>
__device__ __forceinline__ bool row_live(bool y, int i) {
  return (!AFFINE && i >= 6) || (y ? i >= 3 && i < 6 : i < 3);
}

template <bool AFFINE>
__device__ __forceinline__ float row_entry(bool y, int i, float x1, float y1,
                                           float x2, float y2) {
  switch (i) {
    case 0: case 3: return x2;
    case 1: case 4: return y2;
    case 2: case 5: return 1.f;
    case 6: return -__fmul_rn(x2, y ? y1 : x1);
    default: return -__fmul_rn(y2, y ? y1 : x1);
  }
}

// One row's terms by fused multiply-adds: the lower triangle of the normal
// matrix into v, the right-hand side (x1 or y1 times the row) into r
template <bool AFFINE>
__device__ __forceinline__ void accumulate(float* v, float* r, bool y,
                                           float x1, float y1, float x2,
                                           float y2) {
  constexpr int NP = Dlt<AFFINE>::NP;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (!row_live<AFFINE>(y, i)) continue;
    const float ai = row_entry<AFFINE>(y, i, x1, y1, x2, y2);
#pragma unroll
    for (int j = 0; j <= i; ++j)
      if (row_live<AFFINE>(y, j))
        v[tri(i, j)] = __fmaf_rn(ai, row_entry<AFFINE>(y, j, x1, y1, x2, y2),
                                 v[tri(i, j)]);
    r[i] = __fmaf_rn(ai, y ? y1 : x1, r[i]);
  }
}

// The scale of one point set: sqrt(2 / max(sqrsum / cnt, 1e-12))
__device__ __forceinline__ float norm_scale(float sqrsum, float cnt) {
  return __fsqrt_rn(__fdiv_rn(2.f, clamp_min(__fdiv_rn(sqrsum, cnt), SQR_FLOOR)));
}

__device__ __forceinline__ float sq_norm(float x, float y) {
  return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
}

// Solve the normal equations v (lower AtA, Atb) with the ridge, by the
// unrolled Cholesky of dlt._chol_solve_small, and de-normalise into H.
template <bool AFFINE>
__device__ __forceinline__ void solve(const float* v, float s1, float s2,
                                      float* H) {
  constexpr int NP = Dlt<AFFINE>::NP, NT = Dlt<AFFINE>::NT;
  float L[NT];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float s = __fadd_rn(v[tri(j, j)], RIDGE);
#pragma unroll
    for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(L[tri(j, k)], L[tri(j, k)]));
    const float d = __fsqrt_rn(clamp_min(s, CHOL_FLOOR));
    L[tri(j, j)] = d;
    const float inv_d = __fdiv_rn(1.f, d);
#pragma unroll
    for (int i = j + 1; i < NP; ++i) {
      float t = v[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) t = __fsub_rn(t, __fmul_rn(L[tri(i, k)], L[tri(j, k)]));
      L[tri(i, j)] = __fmul_rn(t, inv_d);
    }
  }
  float y[NP], x[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float s = v[NT + i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = __fsub_rn(s, __fmul_rn(L[tri(i, k)], y[k]));
    y[i] = __fdiv_rn(s, L[tri(i, i)]);
  }
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < NP; ++k) s = __fsub_rn(s, __fmul_rn(L[tri(k, i)], x[k]));
    x[i] = __fdiv_rn(s, L[tri(i, i)]);
  }
  float Hn[9];
#pragma unroll
  for (int k = 0; k < NP; ++k) Hn[k] = x[k];
  if (AFFINE) Hn[6] = 0.f, Hn[7] = 0.f;
  Hn[8] = 1.f;
  // diag(1/s1, 1/s1, 1) Hn diag(s2, s2, 1), as (Hn * col) * row
  const float inv1 = __fdiv_rn(1.f, s1);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      H[3 * r + c] = __fmul_rn(__fmul_rn(Hn[3 * r + c], c < 2 ? s2 : 1.f),
                               r < 2 ? inv1 : 1.f);
}

// The sum of a hypothesis's ns squared norms in the order the card's
// reduction kernel takes for such a short row (measured on an H100):
// a_k = t_k + t_{k+4}, then (a_0 + a_2) + (a_1 + a_3).
template <int NS>
__device__ __forceinline__ float sum_short(const float* t) {
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = k + 4 < NS ? __fadd_rn(t[k], t[k + 4]) : t[k];
  return __fadd_rn(__fadd_rn(a[0], a[2]), __fadd_rn(a[1], a[3]));
}

// The fit of one hypothesis from its ns drawn rows (weights 1), rounded as
// the plain version's on the card (the orders measured on an H100): the
// normal matrix by fused multiply-adds over the rows as A stacks them,
// every x row before every y row, from zero; the right-hand side as the
// x rows' sum plus the y rows' sum, each so accumulated; the scales' sums
// by sum_short.
template <bool AFFINE>
__device__ __forceinline__ void fit_hypothesis(const float2* p1,
                                               const float2* p2, float* H) {
  constexpr int NS = Dlt<AFFINE>::NS, NP = Dlt<AFFINE>::NP,
                NT = Dlt<AFFINE>::NT, NV = Dlt<AFFINE>::NV;
  float t1[NS], t2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    t1[s] = sq_norm(p1[s].x, p1[s].y);
    t2[s] = sq_norm(p2[s].x, p2[s].y);
  }
  const float s1 = norm_scale(sum_short<NS>(t1), (float)NS);
  const float s2 = norm_scale(sum_short<NS>(t2), (float)NS);
  float v[NV], by[NP];
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = 0.f;
#pragma unroll
  for (int k = 0; k < NP; ++k) by[k] = 0.f;
#pragma unroll
  for (int y = 0; y < 2; ++y) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
      accumulate<AFFINE>(v, y ? by : v + NT, y, __fmul_rn(p1[s].x, s1),
                         __fmul_rn(p1[s].y, s1), __fmul_rn(p2[s].x, s2),
                         __fmul_rn(p2[s].y, s2));
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) v[NT + i] = __fadd_rn(v[NT + i], by[i]);
  solve<AFFINE>(v, s1, s2, H);
}

// --------------------------------------------------------------------------
// Block reductions (every thread of the block calls them)

// The sum of one int a thread; every thread gets it.
__device__ __forceinline__ int block_sum(int v, int* sh) {
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  v = __reduce_add_sync(FULL, v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += sh[w];
  __syncthreads();
  return total;
}

// Exclusive scan of one int a thread in thread order; *total gets the sum.
__device__ __forceinline__ int block_scan(int v, int* total, int* sh) {
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  int incl = v;
#pragma unroll
  for (int d = 1; d < LANES; d <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == LANES - 1) sh[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? sh[w] : 0;
    all += sh[w];
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

// --------------------------------------------------------------------------
// The refit's sums
//
// Each sum follows the order the plain version's kernels take on the card
// for the refit of M = 1024 rows (measured on an H100): rows of weight 0
// add exact zeros there, so only the inliers are visited here.
//   - the scales' sums of M values: SUM_LANES = 128 lanes, lane l adding the
//     values l, l + 128, ... in turn (s_lanes), then sum_lanes;
//   - the normal matrix: each entry by fused multiply-adds over the stacked
//     rows in order, every x row before every y row, from zero (one thread
//     an entry);
//   - the right-hand side: 32 lanes, lane s adding the stacked rows s,
//     s + 32, ... by fused multiply-adds, then halved (s + 16, + 8, ...) as
//     a warp's shuffles (one warp a parameter).

constexpr int SUM_LANES = 128;

// 32 groups of 4 lanes: each group's lanes added in turn, then the groups'
// sums halved
__device__ __forceinline__ float sum_lanes(const float* lane) {
  float u[LANES];
#pragma unroll
  for (int g = 0; g < LANES; ++g)
    u[g] = __fadd_rn(__fadd_rn(__fadd_rn(lane[4 * g], lane[4 * g + 1]),
                               lane[4 * g + 2]),
                     lane[4 * g + 3]);
#pragma unroll
  for (int h = LANES / 2; h > 0; h >>= 1)
#pragma unroll
    for (int g = 0; g < h; ++g) u[g] = __fadd_rn(u[g], u[g + h]);
  return u[0];
}

// v (lower normal matrix, then right-hand side) of the refit over the n_in
// inliers listed in row order, in normalised coords (scales sc1, sc2).
// Every thread of the block calls it; v is complete after a barrier.
template <bool AFFINE>
__device__ __forceinline__ void refit_sums(const float2* s1, const float2* s2,
                                           const uint8_t* s_in,
                                           const int* s_list, int n_in, int M,
                                           float sc1, float sc2, float* v) {
  constexpr int NP = Dlt<AFFINE>::NP, NT = Dlt<AFFINE>::NT;
  const int t = threadIdx.x, lane = t % LANES, warp = t / LANES;
  auto scaled = [&](int r, float& x1, float& y1, float& x2, float& y2) {
    x1 = __fmul_rn(s1[r].x, sc1), y1 = __fmul_rn(s1[r].y, sc1);
    x2 = __fmul_rn(s2[r].x, sc2), y2 = __fmul_rn(s2[r].y, sc2);
  };
  if (t < NT) {
    int i = 0;
    while (tri(i + 1, 0) <= t) ++i;
    const int j = t - tri(i, 0);
    float acc = 0.f;
    for (int y = 0; y < 2; ++y) {
      if (!row_live<AFFINE>(y, i) || !row_live<AFFINE>(y, j)) continue;
      for (int k = 0; k < n_in; ++k) {
        float x1, y1, x2, y2;
        scaled(s_list[k], x1, y1, x2, y2);
        acc = __fmaf_rn(row_entry<AFFINE>(y, i, x1, y1, x2, y2),
                        row_entry<AFFINE>(y, j, x1, y1, x2, y2), acc);
      }
    }
    v[t] = acc;
  }
  if (warp < NP) {
    float acc = 0.f;
    for (int k = lane; k < 2 * M; k += LANES) {
      const bool y = k >= M;
      const int r = y ? k - M : k;
      if (!s_in[r] || !row_live<AFFINE>(y, warp)) continue;
      float x1, y1, x2, y2;
      scaled(r, x1, y1, x2, y2);
      acc = __fmaf_rn(row_entry<AFFINE>(y, warp, x1, y1, x2, y2),
                      y ? y1 : x1, acc);
    }
#pragma unroll
    for (int h = LANES / 2; h > 0; h >>= 1)
      acc = __fadd_rn(acc, __shfl_down_sync(FULL, acc, h));
    if (lane == 0) v[NT + warp] = acc;
  }
}

// --------------------------------------------------------------------------

template <bool AFFINE>
__global__ void __launch_bounds__(THREADS)
ransac_kernel(int M, int nh, const long long* __restrict__ idx,
              const uint8_t* __restrict__ mvalid,
              const long long* __restrict__ count,
              const long long* __restrict__ keys,
              const long long* __restrict__ ij, Images A, Images B, Gates g,
              Out o) {
  constexpr int NS = Dlt<AFFINE>::NS;
  extern __shared__ float2 smem[];
  float2* s1 = smem;                          // [M] p1 (image i)
  float2* s2 = smem + M;                      // [M] p2 (image j)
  int* s_list = (int*)(smem + 2 * M);         // [M] the inliers' rows
  uint8_t* sv = (uint8_t*)(s_list + M);       // [M] valid
  uint8_t* s_in = sv + M;                     // [M] the winner's inliers
  __shared__ int sh_i[WARPS], sh_h[WARPS];
  __shared__ float sH[9], sHinv[9], sHw[9];
  __shared__ int s_rows, s_best;

  const int p = blockIdx.x, t = threadIdx.x;
  const int lane = t % LANES, warp = t / LANES;
  const long long a = ij ? ij[p] : p;
  const long long b = ij ? ij[gridDim.x + p] : p;
  const float* P1 = A.pos + a * A.K * 2;
  const float* P2 = B.pos + b * B.K * 2;
  const float wi = A.wh[2 * a], hi = A.wh[2 * a + 1];
  const float wj = B.wh[2 * b], hj = B.wh[2 * b + 1];
  const long long n = count[p];

  // 1. stage the rows; the scored rows end after the last valid one
  if (t == 0) s_rows = 0;
  __syncthreads();
  for (int r = t; r < M; r += THREADS) {
    const long long* m = idx + ((long long)p * M + r) * 2;
    const long long u = m[0], w = m[1];
    s1[r] = make_float2(P1[2 * u], P1[2 * u + 1]);
    s2[r] = make_float2(P2[2 * w], P2[2 * w + 1]);
    const uint8_t v = mvalid[(long long)p * M + r];
    sv[r] = v;
    if (v) atomicMax(&s_rows, r + 1);
  }
  // (w1 + h1) * 0.5 / 800 * RANSAC_INLIER_THRES, squared
  const float thres = __fmul_rn(
      __fmul_rn(__fmul_rn(__fadd_rn(wi, hi), 0.5f), 1.f / RES_SCALE),
      g.inlier_thres);
  const float thr2 = __fmul_rn(thres, thres);
  __syncthreads();
  const int rows = s_rows;

  // 2. hypotheses
  const uint32_t k0 = (uint32_t)keys[2 * p], k1 = (uint32_t)keys[2 * p + 1];
  const double hi_n = (double)max(n, 1LL);
  const long long top = max(n - 1, 0LL);
  int best_s = INT_MIN, best_h = INT_MAX;
  float bestH[9];
  for (int h = t; h < nh; h += THREADS) {
    float2 d1[NS], d2[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int r = draw_row(k0, k1, (unsigned long long)h * NS + s, hi_n,
                             top, M);
      d1[s] = s1[r];
      d2[s] = s2[r];
    }
    float H[9];
    fit_hypothesis<AFFINE>(d1, d2, H);
    int score = -1;
    if (health(H, g.max_persp)) {
      score = 0;
      for (int r = 0; r < rows; ++r)
        if (sv[r]) score += inlier(H, s1[r], s2[r], thr2);
    }
    if (score > best_s) {
      best_s = score, best_h = h;
#pragma unroll
      for (int k = 0; k < 9; ++k) bestH[k] = H[k];
    }
  }

  // 3. the best: highest score, then lowest index
#pragma unroll
  for (int d = LANES / 2; d > 0; d >>= 1) {
    const int os = __shfl_down_sync(FULL, best_s, d);
    const int oh = __shfl_down_sync(FULL, best_h, d);
    if (os > best_s || (os == best_s && oh < best_h)) best_s = os, best_h = oh;
  }
  if (lane == 0) sh_i[warp] = best_s, sh_h[warp] = best_h;
  __syncthreads();
  if (t == 0) {
    int bs = sh_i[0], bh = sh_h[0];
    for (int w = 1; w < WARPS; ++w)
      if (sh_i[w] > bs || (sh_i[w] == bs && sh_h[w] < bh)) bs = sh_i[w], bh = sh_h[w];
    s_best = bh;
  }
  __syncthreads();
  const int best = s_best;
  if (best % THREADS == t) {
    // the winner's thread: its hypothesis h = best is its best
#pragma unroll
    for (int k = 0; k < 9; ++k) sHw[k] = bestH[k];
  }
  __syncthreads();

  // 4. the winner's inliers, recounted and listed in row order, and the
  // refit over them, each sum in the order of the plain version's on the
  // card (refit_sums says which)
  for (int r = t; r < M; r += THREADS)
    s_in[r] = r < rows && sv[r] && inlier(sHw, s1[r], s2[r], thr2);
  int n_in = 0;
  for (int r0 = 0; r0 < rows; r0 += THREADS) {
    const int r = r0 + t;
    const int f = r < rows && s_in[r];
    int tot;
    const int at = n_in + block_scan(f, &tot, sh_i);
    if (f) s_list[at] = r;
    n_in += tot;
  }
  __syncthreads();
  __shared__ float s_lanes[2][SUM_LANES], s_scale[2], s_v[Dlt<false>::NV];
  if (t < SUM_LANES) {
    float a1 = 0.f, a2 = 0.f;
    for (int r = t; r < rows; r += SUM_LANES)
      if (s_in[r]) {
        a1 = __fadd_rn(a1, sq_norm(s1[r].x, s1[r].y));
        a2 = __fadd_rn(a2, sq_norm(s2[r].x, s2[r].y));
      }
    s_lanes[0][t] = a1;
    s_lanes[1][t] = a2;
  }
  __syncthreads();
  if (t == 0) {
    const float cnt = (float)max(n_in, 1);
    s_scale[0] = norm_scale(sum_lanes(s_lanes[0]), cnt);
    s_scale[1] = norm_scale(sum_lanes(s_lanes[1]), cnt);
  }
  __syncthreads();
  refit_sums<AFFINE>(s1, s2, s_in, s_list, n_in, M, s_scale[0], s_scale[1],
                     s_v);
  __syncthreads();
  __shared__ int s_inv_ok;
  if (t == 0) {
    float H[9], Hinv[9];
    solve<AFFINE>(s_v, s_scale[0], s_scale[1], H);
    s_inv_ok = homo_inverse(H, Hinv);
#pragma unroll
    for (int k = 0; k < 9; ++k) sH[k] = H[k], sHinv[k] = Hinv[k];
  }
  __syncthreads();

  // 5. gates (fill_inliers_to_matchinfo): overlap counts of the match rows
  // both ways, of each image's keypoints, and of the area lattice
  int c1m = 0, c2m = 0, c1k = 0, c2k = 0, c_area = 0;
  for (int r = t; r < rows; r += THREADS) {
    if (!sv[r]) continue;
    c1m += overlap(sHinv, wi, hi, wj, hj, s1[r].x, s1[r].y);
    c2m += overlap(sH, wj, hj, wi, hi, s2[r].x, s2[r].y);
  }
  const uint8_t* V1 = A.valid + a * A.K;
  const uint8_t* V2 = B.valid + b * B.K;
  for (int k = t; k < A.K; k += THREADS)
    if (V1[k]) c1k += overlap(sHinv, wi, hi, wj, hj, P1[2 * k], P1[2 * k + 1]);
  for (int k = t; k < B.K; k += THREADS)
    if (V2[k]) c2k += overlap(sH, wj, hj, wi, hi, P2[2 * k], P2[2 * k + 1]);
  const float inv_g = __fdiv_rn(1.f, (float)g.grid);
  for (int k = t; k < g.grid * g.grid; k += THREADS) {
    const int ky = k / g.grid, kx = k - ky * g.grid;
    const float ux = __fsub_rn(__fmul_rn(__fadd_rn((float)kx, 0.5f), inv_g), 0.5f);
    const float uy = __fsub_rn(__fmul_rn(__fadd_rn((float)ky, 0.5f), inv_g), 0.5f);
    float px, py, z;
    project(sH, __fmul_rn(ux, wj), __fmul_rn(uy, hj), px, py, z);
    c_area += shifted_in(wi, hi, px, py) && z > 0.f;
  }
  c1m = block_sum(c1m, sh_i);
  c2m = block_sum(c2m, sh_i);
  c1k = block_sum(c1k, sh_i);
  c2k = block_sum(c2k, sh_i);
  c_area = block_sum(c_area, sh_i);

  const float fn = (float)n_in;
  auto ratio = [&](int m) { return __fdiv_rn(fn, (float)max(m, 1)); };
  const float r1m = ratio(c1m), r2m = ratio(c2m);
  const float r1p = ratio(c1k), r2p = ratio(c2k);
  const float conf = __fmul_rn(__fadd_rn(r1p, r2p), 0.5f);
  // the mean of the lattice's hits: their count times 1 / grid^2
  const float frac = __fmul_rn((float)c_area, __fdiv_rn(1.f, (float)(g.grid * g.grid)));
  const float area2 = __fmul_rn(wj, hj), area1 = __fmul_rn(wi, hi);
  const float area = __fmul_rn(frac, area2);
  const bool ok = r1m >= g.match_ratio && r2m >= g.match_ratio &&
                  r1p >= POINT_MIN && r1p <= 1.f && r2p >= POINT_MIN &&
                  r2p <= 1.f && conf >= g.points_ratio &&
                  __fdiv_rn(area, fmaxf(area1, area2)) >= AREA_MIN;
  const bool success = n >= g.min_match && n >= NS && n_in >= g.min_match &&
                       s_inv_ok && ok;

  // 6. output: the inliers first, in row order; zeros past them
  const long long row0 = (long long)p * M;
  const int kept = success ? n_in : 0;
  for (int k = t; k < M; k += THREADS) {
    const bool live = k < kept;
    o.valid[row0 + k] = live;
    o.to_pos[row0 + k] = live ? s1[s_list[k]] : make_float2(0.f, 0.f);
    o.from_pos[row0 + k] = live ? s2[s_list[k]] : make_float2(0.f, 0.f);
  }
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) o.homo[9 * p + k] = sH[k];
    o.conf[p] = success ? conf : -fn;
    o.count[p] = kept;
  }
}

}  // namespace

extern "C" int ransac_launch(
    int P, int M, int nh, int affine, const void* idx, const void* mvalid,
    const void* count, const void* keys, const void* ij, const void* pos_i,
    const void* valid_i, const void* wh_i, int Ki, const void* pos_j,
    const void* valid_j, const void* wh_j, int Kj, int min_match,
    float inlier_thres, float match_ratio, float points_ratio,
    float max_persp, int grid, void* homo, void* conf, void* to_pos,
    void* from_pos, void* valid, void* out_count, void* stream) {
  if (P > 0) {
    const Images A{(const float*)pos_i, (const uint8_t*)valid_i,
                   (const float*)wh_i, Ki};
    const Images B{(const float*)pos_j, (const uint8_t*)valid_j,
                   (const float*)wh_j, Kj};
    const Gates g{min_match, inlier_thres, match_ratio, points_ratio,
                  max_persp, grid};
    const Out o{(float*)homo, (float*)conf, (float2*)to_pos,
                (float2*)from_pos, (uint8_t*)valid, (long long*)out_count};
    const size_t smem = (size_t)M * (2 * sizeof(float2) + sizeof(int) + 2);
    const cudaStream_t st = (cudaStream_t)stream;
    auto run = [&](auto kernel) {
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return;
      }
      kernel<<<P, THREADS, smem, st>>>(
          M, nh, (const long long*)idx, (const uint8_t*)mvalid,
          (const long long*)count, (const long long*)keys,
          (const long long*)ij, A, B, g, o);
    };
    if (affine)
      run(ransac_kernel<true>);
    else
      run(ransac_kernel<false>);
  }
  return (int)cudaGetLastError();
}
