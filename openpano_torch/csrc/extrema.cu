// DoG extrema for Hopper (sm_90a): the 26-neighbour candidate scan, the
// capped compaction of the candidates, and their Newton refinement with the
// contrast and edge gates, in two launches.
//
// Replaces no Pallas kernel: the JAX package leaves detect_extrema
// (openpano_tpu/sift/extrema.py) to XLA, which fuses its chain of
// elementwise operations, gathers and cumulative sums.  PyTorch runs that
// chain eagerly: about 1,500 launches of small operators per call (per
// feature batch and octave), each costing the host more than the card
// spends on it.  These kernels compute what the plain version
// (detect_extrema_plain in openpano_torch/sift/extrema.py) computes, bit
// for bit, with no host synchronisation.
//
// What bounds them on an H100: the scan reads the DoG volume, B * L * h * w
// float32 (58.9 MB for a batch of four 959x640 views at octave 0, 17.6 us
// at 3.35 TB/s); everything after it reads a few thousand 3x3x3 stencils and
// writes a few thousand keypoints, which is latency, not bytes.  The
// design answers the bound by reading each voxel of the scanned levels once,
// coalesced, as the centre of its lane; only a lane whose value passes
// PRE_COLOR_THRES (a few per cent of the lanes) reads its 26 neighbours,
// which its block's other lanes and the adjacent levels' blocks have brought
// into L1 and L2, so the outer levels 0 and L-1 cost bytes only around
// such lanes.  No shared-memory tile: a 128-lane block is one run of a row
// (or a few short rows in the small octaves), and the neighbour reads are
// too sparse for staging to pay.
//
// Lanes and blocks follow the plain version's compaction: lane
// l = (j - 1) * h * w + y * w + x over the scanned levels j in
// [1, NUM_SCALE - 3], borders included as false lanes, cut into blocks of
// 128 consecutive lanes (the last one padded); a block keeps its first 32
// candidates in lane order.
//
// extrema_scan_kernel: one thread per lane, one block per 128 lanes; a
// warp ballot ranks the block's candidates, and the block writes the
// ballot of the lanes it keeps (four words) and their count.
//
// extrema_refine_kernel: one block per image.  It first places the kept
// lanes: each thread sums the counts of a run of blocks, a block-wide
// exclusive scan gives each run its first slot, and the thread writes the
// lanes of its run to slots below cap_cand in lane order (the plain
// version's int64 cumulative sums over the whole volume).  Then each thread
// takes a slot: up to CALC_OFFSET_DEPTH Newton iterations in registers on
// the 3x3x3 stencil read from the DoG, the singular-Hessian, interior and
// convergence tests, the contrast and edge gates and the scale factor
// (powf on the card); a block-wide scan of the survivors writes them to
// keypoint slots below cap_kp in slot order.  Slots past the survivors
// hold slot 0's values with valid false, as the plain version's
// zero-filled gather gives them.
//
// Bit for bit: each float operation is the plain version's, rounded where
// PyTorch rounds it (one kernel per operator, so no fused multiply-add):
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn keep nvcc from contracting;
// a division by a Python number is PyTorch's multiplication by its float32
// reciprocal; torch.round is rintf (half to even); thresholds arrive as the
// float32 casts of the Python floats, which is how PyTorch compares them.
//
// Plain C interface (loaded with ctypes).  The launcher returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int BLOCK_LANES = 128;  // lanes per compaction block
constexpr int BLOCK_CAP = 32;     // candidates a block keeps
constexpr int SCAN_WARPS = BLOCK_LANES / LANES;
constexpr int REFINE_THREADS = 512;
constexpr int REFINE_WARPS = REFINE_THREADS / LANES;
constexpr unsigned FULL = 0xffffffffu;

struct Gates {
  float offset;    // OFFSET_THRES
  float contrast;  // CONTRAST_THRES
  float edge;      // (EDGE_RATIO + 1)^2 / EDGE_RATIO
  float det_eps;   // the singular-Hessian bound, 1e-18
  float base;      // SCALE_FACTOR
  float sigma;     // GAUSS_SIGMA
};

struct Keypoint {
  long long x, y, s;
  float scale_factor, real_x, real_y;
};

// The 26-neighbour test of one lane (the centre is interior and on a
// scanned level).
__device__ __forceinline__ bool is_extremum(const float* __restrict__ c,
                                            float v, long long hw, int w,
                                            float judge) {
  float mx = -INFINITY, mn = INFINITY;
#pragma unroll
  for (int dz = -1; dz <= 1; ++dz)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dz == 0 && dy == 0 && dx == 0) continue;
        const float u = c[dz * hw + dy * w + dx];
        mx = fmaxf(mx, u);
        mn = fminf(mn, u);
      }
  return mx < __fsub_rn(v, judge) || mn > __fadd_rn(v, judge);
}

__global__ void __launch_bounds__(BLOCK_LANES)
extrema_scan_kernel(const float* __restrict__ dog, int L, int h, int w,
                    int levels, int nb, float pre, float judge,
                    unsigned* __restrict__ masks, int* __restrict__ counts) {
  const int b = blockIdx.y, blk = blockIdx.x;
  const int t = threadIdx.x, warp = t / LANES, lane = t % LANES;
  const long long hw = (long long)h * w;
  const long long l = (long long)blk * BLOCK_LANES + t;
  bool cand = false;
  if (l < levels * hw) {
    const long long j = l / hw + 1;
    const long long p = l - (j - 1) * hw;
    const int y = (int)(p / w), x = (int)(p - (long long)y * w);
    if (y >= 1 && y <= h - 2 && x >= 1 && x <= w - 2) {
      const float* c = dog + ((long long)b * L + j) * hw + p;
      const float v = *c;
      cand = v >= pre && is_extremum(c, v, hw, w, judge);
    }
  }
  __shared__ int warp_n[SCAN_WARPS];
  const unsigned ball = __ballot_sync(FULL, cand);
  if (lane == 0) warp_n[warp] = __popc(ball);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int k = 0; k < SCAN_WARPS; ++k) {
    before += k < warp ? warp_n[k] : 0;
    total += warp_n[k];
  }
  const int rank = before + __popc(ball & ((1u << lane) - 1u));
  const unsigned kept = __ballot_sync(FULL, cand && rank < BLOCK_CAP);
  const long long id = (long long)b * nb + blk;
  if (lane == 0) masks[id * SCAN_WARPS + warp] = kept;
  if (t == 0) counts[id] = min(total, BLOCK_CAP);
}

// Exclusive scan of one int per thread over the block, in thread order;
// *total gets the sum.  Every thread of the block calls it.
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
  if (warp == 0) {
    int s = lane < REFINE_WARPS ? sh[lane] : 0;
#pragma unroll
    for (int d = 1; d < LANES; d <<= 1) {
      const int u = __shfl_up_sync(FULL, s, d);
      if (lane >= d) s += u;
    }
    if (lane < REFINE_WARPS) sh[lane] = s;
  }
  __syncthreads();
  const int off = (warp ? sh[warp - 1] : 0) + incl - v;
  *total = sh[REFINE_WARPS - 1];
  __syncthreads();  // sh is free again
  return off;
}

// The Newton refinement and gates of one candidate slot, as the plain
// version's vectorised loop runs them on that slot (each operation rounded
// as a PyTorch operator rounds it).  D: the image's [L, h, w] DoG; idx: the
// slot's lane (0 for a slot past the candidates, whose alive is false).
// Returns whether the keypoint survives; *kp gets the slot's values either
// way (slot 0's fill the padding).
__device__ bool refine(const float* __restrict__ D, int h, int w, int ns,
                       int depth, int idx, bool alive, const Gates& g,
                       float inv_w, float inv_h, float inv_ns, Keypoint* kp) {
  const long long hw = (long long)h * w;
  long long s = idx / hw + 1, y = (idx / w) % h, x = idx % w;
  bool done = false;
  float ox = 0.f, oy = 0.f, os = 0.f, gfx = 0.f, gfy = 0.f, gfs = 0.f;
  for (int it = 0; alive && !done && it < depth; ++it) {
    if (!(x >= 1 && x <= w - 2 && y >= 1 && y <= h - 2 && s >= 1 &&
          s <= ns - 3))
      break;  // fails: the step left the interior
    const float* c = D + (s * h + y) * w + x;
    auto at = [&](int ds, int dy, int dx) {
      return c[ds * hw + dy * w + dx];
    };
    const float v2 = __fmul_rn(at(0, 0, 0), 2.f);
    const float gx = __fmul_rn(__fsub_rn(at(0, 0, 1), at(0, 0, -1)), 0.5f);
    const float gy = __fmul_rn(__fsub_rn(at(0, 1, 0), at(0, -1, 0)), 0.5f);
    const float gs = __fmul_rn(__fsub_rn(at(1, 0, 0), at(-1, 0, 0)), 0.5f);
    const float dxx = __fsub_rn(__fadd_rn(at(0, 0, 1), at(0, 0, -1)), v2);
    const float dyy = __fsub_rn(__fadd_rn(at(0, 1, 0), at(0, -1, 0)), v2);
    const float dss = __fsub_rn(__fadd_rn(at(1, 0, 0), at(-1, 0, 0)), v2);
    const float dxy = __fmul_rn(
        __fadd_rn(__fsub_rn(__fsub_rn(at(0, 1, 1), at(0, -1, 1)),
                            at(0, 1, -1)),
                  at(0, -1, -1)),
        0.25f);
    const float dys = __fmul_rn(
        __fadd_rn(__fsub_rn(__fsub_rn(at(1, 1, 0), at(1, -1, 0)),
                            at(-1, 1, 0)),
                  at(-1, -1, 0)),
        0.25f);
    const float dsx = __fmul_rn(
        __fadd_rn(__fsub_rn(__fsub_rn(at(1, 0, 1), at(1, 0, -1)),
                            at(-1, 0, 1)),
                  at(-1, 0, -1)),
        0.25f);
    // adjugate of H = [[dxx, dxy, dsx], [dxy, dyy, dys], [dsx, dys, dss]]
    const float c00 = __fsub_rn(__fmul_rn(dyy, dss), __fmul_rn(dys, dys));
    const float c01 = __fsub_rn(__fmul_rn(dsx, dys), __fmul_rn(dxy, dss));
    const float c02 = __fsub_rn(__fmul_rn(dxy, dys), __fmul_rn(dsx, dyy));
    const float c11 = __fsub_rn(__fmul_rn(dxx, dss), __fmul_rn(dsx, dsx));
    const float c12 = __fsub_rn(__fmul_rn(dsx, dxy), __fmul_rn(dxx, dys));
    const float c22 = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
    const float det = __fadd_rn(
        __fadd_rn(__fmul_rn(dxx, c00), __fmul_rn(dxy, c01)),
        __fmul_rn(dsx, c02));
    if (!(fabsf(det) > g.det_eps)) break;  // fails: singular
    const float idet = __fdiv_rn(1.f, det);
    const float nox = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(c00, gx), __fmul_rn(c01, gy)),
                  __fmul_rn(c02, gs)),
        idet);
    const float noy = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(c01, gx), __fmul_rn(c11, gy)),
                  __fmul_rn(c12, gs)),
        idet);
    const float nos = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(c02, gx), __fmul_rn(c12, gy)),
                  __fmul_rn(c22, gs)),
        idet);
    // a NaN offset fails each test, as it fails torch.maximum's
    if (fabsf(nox) < g.offset && fabsf(noy) < g.offset &&
        fabsf(nos) < g.offset) {
      ox = nox, oy = noy, os = nos;
      gfx = gx, gfy = gy, gfs = gs;
      done = true;
    } else {
      x += (long long)rintf(nox);
      y += (long long)rintf(noy);
      s += (long long)rintf(nos);
    }
  }
  // torch.clamp(v, lo, hi) is min(max(v, lo), hi)
  const long long sc = min(max(s, 1LL), (long long)ns - 3);
  const long long yc = min(max(y, 1LL), (long long)h - 2);
  const long long xc = min(max(x, 1LL), (long long)w - 2);
  bool ok = done;
  if (ok) {
    const float* c = D + (sc * h + yc) * w + xc;
    auto at = [&](int dy, int dx) { return c[dy * w + dx]; };
    const float val = at(0, 0);
    // contrast: D + offset . grad / 2 (extrema.cc:89-94)
    const float dot = __fadd_rn(__fadd_rn(__fmul_rn(ox, gfx), __fmul_rn(oy, gfy)),
                                __fmul_rn(os, gfs));
    ok = __fadd_rn(val, __fmul_rn(dot, 0.5f)) >= g.contrast;
    // edge response on the 2x2 spatial Hessian (extrema.cc:152-168)
    const float v2 = __fmul_rn(val, 2.f);
    const float exx = __fsub_rn(__fadd_rn(at(0, 1), at(0, -1)), v2);
    const float eyy = __fsub_rn(__fadd_rn(at(1, 0), at(-1, 0)), v2);
    const float exy = __fmul_rn(
        __fsub_rn(__fsub_rn(__fadd_rn(at(1, 1), at(-1, -1)), at(1, -1)),
                  at(-1, 1)),
        0.25f);
    const float edet = __fsub_rn(__fmul_rn(exx, eyy), __fmul_rn(exy, exy));
    const float tr = __fadd_rn(exx, eyy);
    ok = ok && edet > 0.f && __fdiv_rn(__fmul_rn(tr, tr), edet) < g.edge;
  }
  kp->x = xc, kp->y = yc, kp->s = sc;
  const float e = __fmul_rn(__fadd_rn((float)sc, os), inv_ns);
  kp->scale_factor = __fmul_rn(powf(g.base, e), g.sigma);
  kp->real_x = __fmul_rn(__fadd_rn((float)xc, ox), inv_w);
  kp->real_y = __fmul_rn(__fadd_rn((float)yc, oy), inv_h);
  return ok;
}

struct Out {
  long long *x, *y, *s;
  float *scale_factor, *real_x, *real_y;
  uint8_t* valid;
};

__device__ __forceinline__ void put(const Out& o, long long k,
                                    const Keypoint& kp, bool valid) {
  o.x[k] = kp.x, o.y[k] = kp.y, o.s[k] = kp.s;
  o.scale_factor[k] = kp.scale_factor;
  o.real_x[k] = kp.real_x, o.real_y[k] = kp.real_y;
  o.valid[k] = valid;
}

__global__ void __launch_bounds__(REFINE_THREADS)
extrema_refine_kernel(const float* __restrict__ dog, int L, int h, int w,
                      int ns, int depth, int nb,
                      const unsigned* __restrict__ masks,
                      const int* __restrict__ counts, int cap_cand,
                      int cap_kp, Gates g, int* __restrict__ slots_all,
                      Out o) {
  __shared__ int sh[REFINE_WARPS];
  __shared__ Keypoint first;
  const int b = blockIdx.x, t = threadIdx.x;

  // place: the kept lanes in lane order into slots below cap_cand
  const int* cnt = counts + (long long)b * nb;
  const int run = (nb + REFINE_THREADS - 1) / REFINE_THREADS;
  const int k0 = min(t * run, nb), k1 = min(k0 + run, nb);
  int mine = 0;
  for (int k = k0; k < k1; ++k) mine += cnt[k];
  int total;
  int slot = block_scan(mine, &total, sh);
  int* slots = slots_all + (long long)b * cap_cand;
  for (int k = k0; k < k1 && slot < cap_cand; ++k) {
    if (cnt[k] == 0) continue;
    const unsigned* m4 = masks + ((long long)b * nb + k) * SCAN_WARPS;
    for (int q = 0; q < SCAN_WARPS && slot < cap_cand; ++q) {
      for (unsigned m = m4[q]; m && slot < cap_cand; m &= m - 1u)
        slots[slot++] = k * BLOCK_LANES + q * LANES + (__ffs(m) - 1);
    }
  }
  const int n_cand = min(total, cap_cand);
  __syncthreads();

  // refine: one slot a thread, survivors written in slot order; slot 0 is
  // refined even with no candidate, for the padding
  const float* D = dog + (long long)b * L * h * w;
  const float inv_w = __fdiv_rn(1.f, (float)w);
  const float inv_h = __fdiv_rn(1.f, (float)h);
  const float inv_ns = __fdiv_rn(1.f, (float)ns);
  const long long row = (long long)b * cap_kp;
  const int n_slots = max(n_cand, 1);
  int kept = 0;
  for (int r = 0; r < n_slots && kept < cap_kp; r += REFINE_THREADS) {
    const int i = r + t;
    Keypoint kp;
    bool ok = false;
    if (i < n_slots) {
      const bool alive = i < n_cand;
      ok = refine(D, h, w, ns, depth, alive ? slots[i] : 0, alive, g, inv_w,
                  inv_h, inv_ns, &kp);
      if (i == 0) first = kp;
    }
    int n_ok;
    const int pos = kept + block_scan(ok, &n_ok, sh);
    if (ok && pos < cap_kp) put(o, row + pos, kp, true);
    kept += n_ok;
  }
  __syncthreads();
  for (int k = min(kept, cap_kp) + t; k < cap_kp; k += REFINE_THREADS)
    put(o, row + k, first, false);
}

}  // namespace

extern "C" int extrema_launch(const void* dog, int B, int L, int h, int w,
                              int ns, int depth, int cap_cand, int cap_kp,
                              float pre, float judge, float offset,
                              float contrast, float edge, float det_eps,
                              float base, float sigma, void* scratch,
                              void* x, void* y, void* s, void* scale_factor,
                              void* real_x, void* real_y, void* valid,
                              void* stream) {
  if (B > 0) {
    const long long lanes = (long long)(ns - 3) * h * w;
    const int nb = (int)((lanes + BLOCK_LANES - 1) / BLOCK_LANES);
    unsigned* masks = (unsigned*)scratch;
    int* counts = (int*)(masks + (long long)B * nb * SCAN_WARPS);
    int* slots = counts + (long long)B * nb;
    const cudaStream_t st = (cudaStream_t)stream;
    extrema_scan_kernel<<<dim3(nb, B), BLOCK_LANES, 0, st>>>(
        (const float*)dog, L, h, w, ns - 3, nb, pre, judge, masks, counts);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const Gates g{offset, contrast, edge, det_eps, base, sigma};
    const Out o{(long long*)x, (long long*)y, (long long*)s,
                (float*)scale_factor, (float*)real_x, (float*)real_y,
                (uint8_t*)valid};
    extrema_refine_kernel<<<B, REFINE_THREADS, 0, st>>>(
        (const float*)dog, L, h, w, ns, depth, nb, masks, counts, cap_cand,
        cap_kp, g, slots, o);
  }
  return (int)cudaGetLastError();
}
