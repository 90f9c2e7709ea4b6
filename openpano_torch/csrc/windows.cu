// Keypoint-window kernels for Hopper (sm_90a): the SIFT orientation
// histogram (K1), the raw 4x4x8 descriptor histogram (K2) and the window
// slab gather (K3, at the end of this file, with its own note).
//
// K1 and K2 replace the Pallas kernels `_ori_hist_pallas` and
// `_desc_hist_pallas` of openpano_tpu/ops/windows.py and compute what their
// plain references `_ori_hist_xla` / `_desc_hist_xla` compute.  The TPU
// kernels DMA an 8x128-aligned [WR, 256] slab per keypoint because the
// TPU's vector layout asks for it; here each warp reads its keypoint's
// window straight from the stacked [S, H, W] planes.  That equals the slab
// semantics while the window lies inside the slab, i.e. for window radii up
// to 63 (the wrapper asserts it; the defaults are 8 and 19).
//
// Design: one warp per keypoint, several keypoints per block, no block
// barrier (warps finish on their own; an inactive slot's warp writes zeros
// and leaves).  Each lane computes the weight and bins of its pixels and
// adds them into a histogram in shared memory that no other warp touches;
// then lane l sums bins l, l + 32, ... over the warp's histograms in order
// and writes them.  No float atomics: a fixed assignment of pixels to
// lanes and a fixed order of the adds give the same bits on every run.
// Each term is rounded as a separate product (__fmul_rn), so only the
// order of the sum differs from the plain version.  A stride of nbins + 1
// floats between histograms puts histogram m's bin b on bank
// (m + b) mod 32 (K2; 5m + b in K1).
//
// K1 (36 bins, 37,888 B of histograms for 8 keypoints): lane l takes the
// flat pixel indices l, l + 32, ... of its keypoint's box [-r, r - 1]^2
// and owns histogram l.
//
// K2 adds only the corners whose trilinear weight can be non-zero: for
// ybin in [-1, 3] the spatial rows floor(ybin) and floor(ybin) + 1 inside
// [0, 3], the same for xbin, and the orientation bins floor(hbin) and
// floor(hbin) + 1 mod 8: at most 8 products per pixel where the dense form
// (every thread one of the 128 bins, every pixel) evaluates 128.  Every
// other bin's hat is exactly 0 in f32 (|bin distance| >= 1 stays >= 1 when
// rounded), so each corner's term is bit-equal to the dense one; the
// corner weights use the dense expressions, hat(ybin - by), hat(xbin - bx),
// hat(min(d, 8 - d)) with d = |hbin - bo|, in the order wgt*hy*hx*ho.  Two
// passes keep the lanes busy: the warp tests 32 pixels of the box at a
// time (cut to the bounding box of the rotated bin square, about a third
// of the window passes) and queues the in-window ones in pixel order; each
// time 32 are queued, lane l loads, weighs and adds the l-th.  Lanes l and
// l + 16 share a histogram (DESC_SHARE) and add in turn, lower lane first:
// half the shared memory per warp, twice the warps per SM.
//
// What bounds them on an H100: the issue rate of the SMs and the latency
// of dependent instructions at the occupancy the histograms allow, not
// memory.  A warp reads its window of `mag` and `ort` once (8 B per pixel,
// a few KB per keypoint, which the byte bound counts) and writes 36 or 128
// floats, but per pixel it spends tens of instructions on masks, the
// rotation (two IEEE divisions), an exp and the shared-memory
// read-modify-writes.  No TMA: the planes' row stride (W floats, 959 at the
// headline) is no multiple of 16 bytes, so no tensor map describes them,
// and a window is a few scattered 40-column runs that cp.async staging
// would only copy once more.  No tensor cores: the TPU kernel's
// factorisation, a [16, P] x [P, 8] product per keypoint, does 128
// multiply-adds per pixel where the corners need 8, and in TF32 it misses
// the 1e-4 gate without a 3-way split.
//
// Plain C interface (loaded with ctypes).  Each launcher returns
// cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ORI_NBINS = 36;
constexpr int DESC_W4 = 4;
constexpr int DESC_NB = 8;
constexpr int DESC_LEN = DESC_W4 * DESC_W4 * DESC_NB;  // 128
constexpr int LANES = 32;
constexpr int ORI_WARPS = 8;   // keypoints per K1 block
constexpr int DESC_WARPS = 4;  // keypoints per K2 block
constexpr int ORI_STRIDE = ORI_NBINS + 1;  // floats per lane histogram
constexpr int DESC_STRIDE = DESC_LEN + 1;
constexpr int DESC_SHARE = 2;                   // lanes per K2 histogram
constexpr int DESC_HISTS = LANES / DESC_SHARE;  // K2 histograms per warp
// per K2 warp: its histograms and a queue of 64 pixel indices
constexpr int DESC_WARP_FLOATS = DESC_HISTS * DESC_STRIDE + 2 * LANES;
constexpr size_t DESC_SMEM =
    (size_t)DESC_WARPS * DESC_WARP_FLOATS * sizeof(float);  // 34 KB

// f32 constants rounded from double, as the JAX package's weakly typed
// Python constants are
constexpr float TWO_PI_F = (float)6.283185307179586;
constexpr float ORI_SCALE = (float)(36.0 / 6.283185307179586);
constexpr float DESC_ORI_SCALE = (float)(8.0 / 6.283185307179586);

__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.f, 1.f - fabsf(d));
}

// Lane `lane` of a warp sums bins lane, lane + 32, ... < NBINS over the
// warp's HISTS histograms (STRIDE floats apart) in order and writes them.
template <int NBINS, int STRIDE, int HISTS>
__device__ __forceinline__ void reduce_lanes(const float* h, int lane,
                                             float* __restrict__ o) {
  for (int b = lane; b < NBINS; b += LANES) {
    float acc = 0.f;
#pragma unroll 8
    for (int m = 0; m < HISTS; ++m) acc += h[m * STRIDE + b];
    o[b] = acc;
  }
}

// K1: per keypoint, 36-bin hard-binned histogram of exp(-r^2*invden)*mag
// over dy, dx in [-rad, rad-1], r^2 <= rad^2, inside the interior
// [1, h-2] x [1, w-2] of the keypoint's octave (windows.py:217-234).
__global__ void __launch_bounds__(ORI_WARPS * LANES)
ori_hist_kernel(const float* __restrict__ mag, const float* __restrict__ ort,
                int S, int H, int W,
                const int* __restrict__ ks, const int* __restrict__ ky,
                const int* __restrict__ kx, const float* __restrict__ krad,
                const float* __restrict__ kinvden,
                const float* __restrict__ khb, const float* __restrict__ kwb,
                const uint8_t* __restrict__ kactive, int K, int R,
                float* __restrict__ out) {
  __shared__ float hist_s[ORI_WARPS * LANES * ORI_STRIDE];
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int k = blockIdx.x * ORI_WARPS + warp;
  if (k >= K) return;
  float* o = out + (size_t)k * ORI_NBINS;
  if (!kactive[k]) {
    for (int b = lane; b < ORI_NBINS; b += LANES) o[b] = 0.f;
    return;
  }
  float* hw = hist_s + warp * LANES * ORI_STRIDE;
  float* mine = hw + lane * ORI_STRIDE;
  for (int b = 0; b < ORI_NBINS; ++b) mine[b] = 0.f;

  const int s = min(max(ks[k], 0), S - 1);
  const float yf = (float)ky[k], xf = (float)kx[k];
  const float rad = krad[k], invden = kinvden[k];
  // rows/cols past the plane are zero padding in the reference; they lie
  // outside the interior mask anyway, so bounding by the plane is exact
  const float hb = fminf(khb[k], (float)H), wb = fminf(kwb[k], (float)W);
  const float* mp = mag + (size_t)s * H * W;
  const float* op = ort + (size_t)s * H * W;
  // the keypoint's own box [-r, r - 1]^2, r = min(rad, R): no pixel past
  // it passes the mask
  const int r = max(0, min(R, (int)ceilf(rad)));
  const int side = 2 * r;
  const int npix = side * side;
  for (int p = lane; p < npix; p += LANES) {
    const float dy = (float)(p / side - r), dx = (float)(p % side - r);
    const float py = yf + dy, px = xf + dx;
    const float r2 = dy * dy + dx * dx;
    if (!(dy >= -rad && dy <= rad - 1.f && dx >= -rad && dx <= rad - 1.f &&
          r2 <= rad * rad && px >= 1.f && px <= wb - 2.f && py >= 1.f &&
          py <= hb - 2.f))
      continue;
    const size_t off = (size_t)py * W + (size_t)px;
    const float w = __fmul_rn(expf(-r2 * invden), __ldg(mp + off));
    // round-half-away hard binning (ort >= 0); no fused multiply-add, so a
    // value on a bin edge lands where the reference puts it
    int b = (int)floorf(
        __fadd_rn(__fmul_rn(__ldg(op + off), ORI_SCALE), 0.5f));
    if (b >= ORI_NBINS) b -= ORI_NBINS;
    if ((unsigned)b < (unsigned)ORI_NBINS) mine[b] += w;
  }
  __syncwarp();
  reduce_lanes<ORI_NBINS, ORI_STRIDE, LANES>(hw, lane, o);
}

// K2's per-keypoint constants; the pixels it visits are the box
// [y0, y0 + wy) x [x0, x0 + wx) of offsets, row-major.
struct DescKp {
  float yf, xf, radius, hwid, co, si, dirv, hb, wb;
  int y0, x0, wx;
  float inv_wx;
};

// Whether the box's pixel p lies inside every mask; its rotated offsets in
// (x_rot, y_rot) and its plane coordinates in (py, px).
__device__ __forceinline__ bool desc_pixel(const DescKp& kp, int p,
                                           float& x_rot, float& y_rot,
                                           float& py, float& px) {
  // p / wx, exact: the float quotient is far from the next integer
  const int iy = __float2int_rd(((float)p + 0.5f) * kp.inv_wx);
  const float fy = (float)(kp.y0 + iy), fx = (float)(kp.x0 + p - iy * kp.wx);
  py = kp.yf + fy;
  px = kp.xf + fx;
  // rounded like the reference's separate f32 ops (no fused multiply-add):
  // ybin/xbin == 3 is kept at full hat weight while anything above is
  // dropped, so these bits decide pixels
  x_rot = __fdiv_rn(__fadd_rn(__fmul_rn(fx, kp.co), __fmul_rn(fy, kp.si)),
                    kp.hwid);
  y_rot = __fdiv_rn(__fadd_rn(__fmul_rn(-fx, kp.si), __fmul_rn(fy, kp.co)),
                    kp.hwid);
  const float ybin = __fadd_rn(__fadd_rn(y_rot, 2.f), -0.5f);
  const float xbin = __fadd_rn(__fadd_rn(x_rot, 2.f), -0.5f);
  return fabsf(fy) <= kp.radius && fabsf(fx) <= kp.radius &&
         fy * fy + fx * fx <= kp.radius * kp.radius && px >= 1.f &&
         px <= kp.wb - 2.f && py >= 1.f && py <= kp.hb - 2.f &&
         ybin >= -1.f && ybin <= 3.f && xbin >= -1.f && xbin <= 3.f;
}

// In-window pixel p's corners: histogram index (or -1) and term of each.
__device__ __forceinline__ void desc_corners(const DescKp& kp, int p,
                                             const float* __restrict__ mp,
                                             const float* __restrict__ op,
                                             int W, int (&idx)[8],
                                             float (&val)[8]) {
  float x_rot, y_rot, py, px;
  desc_pixel(kp, p, x_rot, y_rot, py, px);
  const size_t off = (size_t)py * W + (size_t)px;
  float now = __ldg(op + off) - kp.dirv;
  if (now < 0.f) now += TWO_PI_F;
  if (now > TWO_PI_F) now -= TWO_PI_F;
  const float wgt = __fmul_rn(
      expf(-__fadd_rn(__fmul_rn(x_rot, x_rot), __fmul_rn(y_rot, y_rot)) /
           32.f),
      __ldg(mp + off));
  const float ybin = __fadd_rn(__fadd_rn(y_rot, 2.f), -0.5f);
  const float xbin = __fadd_rn(__fadd_rn(x_rot, 2.f), -0.5f);
  const float hbin = __fmul_rn(now, DESC_ORI_SCALE);
  const int y0 = (int)floorf(ybin), x0 = (int)floorf(xbin);
  const int o0 = (int)floorf(hbin);
#pragma unroll
  for (int cy = 0; cy < 2; ++cy) {
    const int by = y0 + cy;
    const float wy = __fmul_rn(wgt, hat(ybin - (float)by));
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const int bx = x0 + cx;
      const bool ok = by >= 0 && by < DESC_W4 && bx >= 0 && bx < DESC_W4;
      const float wyx = __fmul_rn(wy, hat(xbin - (float)bx));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int bo = ((o0 + c) % DESC_NB + DESC_NB) % DESC_NB;
        const float d = fabsf(hbin - (float)bo);
        const int j = (cy * 2 + cx) * 2 + c;
        idx[j] = ok ? (by * DESC_W4 + bx) * DESC_NB + bo : -1;
        val[j] = __fmul_rn(wyx, hat(fminf(d, (float)DESC_NB - d)));
      }
    }
  }
}

// Lanes l, l + DESC_HISTS, ... share histogram l % DESC_HISTS of the warp
// (h points at it) and add their corners in turn, lowest lane first.
__device__ __forceinline__ void desc_add(const DescKp& kp, int p, bool valid,
                                         const float* __restrict__ mp,
                                         const float* __restrict__ op, int W,
                                         float* h, int lane) {
  int idx[8];
  float val[8];
  if (valid) {
    desc_corners(kp, p, mp, op, W, idx, val);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) idx[j] = -1;
  }
#pragma unroll
  for (int turn = 0; turn < DESC_SHARE; ++turn) {
    if (lane / DESC_HISTS == turn) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (idx[j] >= 0) h[idx[j]] += val[j];
    }
    __syncwarp();
  }
}

// K2: per keypoint, the raw 4x4x8 SIFT histogram with trilinear hats,
// circular in orientation, over |dy|, |dx| <= radius, r^2 <= radius^2,
// inside the octave interior (windows.py:428-451).
__global__ void __launch_bounds__(DESC_WARPS * LANES)
desc_hist_kernel(const float* __restrict__ mag, const float* __restrict__ ort,
                 int S, int H, int W,
                 const int* __restrict__ ks, const int* __restrict__ ky,
                 const int* __restrict__ kx,
                 const float* __restrict__ kradius,
                 const float* __restrict__ khw,
                 const float* __restrict__ kcos,
                 const float* __restrict__ ksin,
                 const float* __restrict__ kdir,
                 const float* __restrict__ khb, const float* __restrict__ kwb,
                 const uint8_t* __restrict__ kactive, int K, int R,
                 float* __restrict__ out) {
  extern __shared__ float hist_d[];
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int k = blockIdx.x * DESC_WARPS + warp;
  if (k >= K) return;
  float* o = out + (size_t)k * DESC_LEN;
  if (!kactive[k]) {
    for (int b = lane; b < DESC_LEN; b += LANES) o[b] = 0.f;
    return;
  }
  float* hw = hist_d + warp * DESC_WARP_FLOATS;
  for (int i = lane; i < DESC_HISTS * DESC_STRIDE; i += LANES) hw[i] = 0.f;
  int* queue = reinterpret_cast<int*>(hw + DESC_HISTS * DESC_STRIDE);
  float* mine = hw + (lane % DESC_HISTS) * DESC_STRIDE;

  DescKp kp;
  kp.yf = (float)ky[k];
  kp.xf = (float)kx[k];
  kp.radius = kradius[k];
  kp.hwid = khw[k];
  kp.co = kcos[k];
  kp.si = ksin[k];
  kp.dirv = kdir[k];
  kp.hb = fminf(khb[k], (float)H);
  kp.wb = fminf(kwb[k], (float)W);
  // Visit the box [-r, r]^2, r = min(radius, R), cut to the bounding box
  // of the rotated square where ybin, xbin lie in [-1, 3] (the offsets
  // hw * rotate(x_rot, y_rot) with x_rot, y_rot in {-2.5, 1.5}), widened
  // by a pixel against rounding: no pixel outside passes the mask.  An
  // infinite corner widens the cut to the box; NaN corners, which no pixel
  // passes either, drop out of fminf / fmaxf.
  const float r =  // -1, no pixel, for a negative or NaN radius
      kp.radius >= 0.f ? fminf(floorf(kp.radius), (float)R) : -1.f;
  float ylo = r, yhi = -r, xlo = r, xhi = -r;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float xr = (c & 1) ? 1.5f : -2.5f, yr = (c & 2) ? 1.5f : -2.5f;
    const float cx = kp.hwid * (kp.co * xr - kp.si * yr);
    const float cy = kp.hwid * (kp.si * xr + kp.co * yr);
    xlo = fminf(xlo, cx); xhi = fmaxf(xhi, cx);
    ylo = fminf(ylo, cy); yhi = fmaxf(yhi, cy);
  }
  kp.y0 = (int)fmaxf(-r, floorf(ylo) - 1.f);
  kp.x0 = (int)fmaxf(-r, floorf(xlo) - 1.f);
  const int y1 = (int)fminf(r, ceilf(yhi) + 1.f);
  const int x1 = (int)fminf(r, ceilf(xhi) + 1.f);
  kp.wx = max(0, x1 - kp.x0 + 1);
  kp.inv_wx = 1.f / (float)max(kp.wx, 1);
  const int npix = kp.wx * max(0, y1 - kp.y0 + 1);
  const int s = min(max(ks[k], 0), S - 1);
  const float* mp = mag + (size_t)s * H * W;
  const float* op = ort + (size_t)s * H * W;
  __syncwarp();

  // Pass over the box 32 pixels at a time; queue the in-window ones in
  // pixel order, and whenever 32 are queued, lane l adds the l-th.
  const unsigned below = (1u << lane) - 1u;
  int n = 0;  // queued pixels, the same in every lane
  for (int p0 = 0; p0 < npix; p0 += LANES) {
    const int p = p0 + lane;
    float x_rot, y_rot, py, px;
    const bool in = p < npix && desc_pixel(kp, p, x_rot, y_rot, py, px);
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (in) queue[n + __popc(m & below)] = p;
    n += __popc(m);
    if (n >= LANES) {
      __syncwarp();
      desc_add(kp, queue[lane], true, mp, op, W, mine, lane);
      if (lane < n - LANES) queue[lane] = queue[lane + LANES];
      __syncwarp();
      n -= LANES;
    }
  }
  __syncwarp();
  desc_add(kp, lane < n ? queue[lane] : 0, lane < n, mp, op, W, mine, lane);
  reduce_lanes<DESC_LEN, DESC_STRIDE, DESC_HISTS>(hw, lane, o);
}

// K3: per keypoint, the [WR, 256] slab of each of two planes, as if the
// planes were zero-padded to (Hp, Wp) = (max(ceil8(H), WR),
// max(ceil128(W), 256)): out[k, i, j] = plane[s, r0 + i, c0 + j], or 0 where
// r0 + i >= H or c0 + j >= W, with r0 = clip(y - WR/2, 0, Hp - WR) & ~7,
// c0 = clip(x - 64, 0, Wp - 256) & ~127 and s clipped to [0, S - 1].
//
// It replaces `_win2_pallas` of openpano_tpu/ops/windows.py, whose plain
// reference is `_win2_xla`.  The TPU kernel DMAs each slab from a padded
// copy of the planes; here nothing is padded in memory: the block reads the
// unpadded planes and writes the zeros itself.  What bounds it on an H100:
// bytes.  It moves 2 * K * WR * 1 KB out and at most as much in, and
// computes nothing.  Design against that: one block per (keypoint, group of
// ROWS slab rows), 256 threads, thread j on lane j, so each slab row is one
// coalesced 1 KB read and one coalesced 1 KB write per plane; both planes in
// the same block.  Same inputs, same bits (a copy).
constexpr int SLAB_LANES = 256;
constexpr int WIN2_ROWS = 8;

__global__ void __launch_bounds__(SLAB_LANES)
win2_kernel(const float* __restrict__ a, const float* __restrict__ b, int S,
            int H, int W, int Hp, int Wp, const int* __restrict__ ks,
            const int* __restrict__ ky, const int* __restrict__ kx, int WR,
            float* __restrict__ outa, float* __restrict__ outb) {
  const int k = blockIdx.x;
  const int j = threadIdx.x;
  const int s = min(max(ks[k], 0), S - 1);
  const int r0 = min(max(ky[k] - WR / 2, 0), Hp - WR) & ~7;
  const int c0 = min(max(kx[k] - 64, 0), Wp - SLAB_LANES) & ~127;
  const int c = c0 + j;
  const size_t plane = (size_t)s * H * W;
  const int i0 = blockIdx.y * WIN2_ROWS;
  const int i1 = min(i0 + WIN2_ROWS, WR);
  for (int i = i0; i < i1; ++i) {
    const int r = r0 + i;
    float va = 0.f, vb = 0.f;
    if (r < H && c < W) {
      const size_t src = plane + (size_t)r * W + c;
      va = a[src];
      vb = b[src];
    }
    const size_t dst = ((size_t)k * WR + i) * SLAB_LANES + j;
    outa[dst] = va;
    outb[dst] = vb;
  }
}

// K2's shared-memory settings: room for DESC_SMEM bytes (a tuning above
// 48 KB needs it) and the SM's carveout at its largest, so that as many
// blocks fit as its shared memory allows
cudaError_t desc_smem_attr() {
  const cudaError_t e = cudaFuncSetAttribute(
      desc_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DESC_SMEM);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(desc_hist_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" int ori_hist_launch(const void* mag, const void* ort, int S, int H,
                               int W, const void* s, const void* y,
                               const void* x, const void* rad,
                               const void* invden, const void* hb,
                               const void* wb, const void* active, int K,
                               int R, void* out, void* stream) {
  if (K > 0) {
    const int blocks = (K + ORI_WARPS - 1) / ORI_WARPS;
    ori_hist_kernel<<<blocks, ORI_WARPS * LANES, 0, (cudaStream_t)stream>>>(
        (const float*)mag, (const float*)ort, S, H, W, (const int*)s,
        (const int*)y, (const int*)x, (const float*)rad,
        (const float*)invden, (const float*)hb, (const float*)wb,
        (const uint8_t*)active, K, R, (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int desc_hist_launch(const void* mag, const void* ort, int S, int H,
                                int W, const void* s, const void* y,
                                const void* x, const void* radius,
                                const void* hw, const void* cos_o,
                                const void* sin_o, const void* dirv,
                                const void* hb, const void* wb,
                                const void* active, int K, int R, void* out,
                                void* stream) {
  static const cudaError_t smem_err = desc_smem_attr();
  if (smem_err != cudaSuccess) return (int)smem_err;
  if (K > 0) {
    const int blocks = (K + DESC_WARPS - 1) / DESC_WARPS;
    desc_hist_kernel<<<blocks, DESC_WARPS * LANES, DESC_SMEM,
                       (cudaStream_t)stream>>>(
        (const float*)mag, (const float*)ort, S, H, W, (const int*)s,
        (const int*)y, (const int*)x, (const float*)radius, (const float*)hw,
        (const float*)cos_o, (const float*)sin_o, (const float*)dirv,
        (const float*)hb, (const float*)wb, (const uint8_t*)active, K, R,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int win2_launch(const void* a, const void* b, int S, int H, int W,
                           const void* s, const void* y, const void* x, int K,
                           int WR, void* outa, void* outb, void* stream) {
  if (K > 0) {
    const int H8 = (H + 7) / 8 * 8, W128 = (W + 127) / 128 * 128;
    const int Hp = H8 > WR ? H8 : WR;
    const int Wp = W128 > SLAB_LANES ? W128 : SLAB_LANES;
    const dim3 grid(K, (WR + WIN2_ROWS - 1) / WIN2_ROWS);
    win2_kernel<<<grid, SLAB_LANES, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, S, H, W, Hp, Wp, (const int*)s,
        (const int*)y, (const int*)x, WR, (float*)outa, (float*)outb);
  }
  return (int)cudaGetLastError();
}
