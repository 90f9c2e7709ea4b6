// Keypoint-window kernels for Hopper (sm_90a): the SIFT orientation
// histogram (K1), the raw 4x4x8 descriptor histogram (K2) and the window
// slab gather (K3, at the end of this file, with its own note).
//
// They replace the Pallas kernels `_ori_hist_pallas` and `_desc_hist_pallas`
// of openpano_tpu/ops/windows.py and compute what their plain references
// `_ori_hist_xla` / `_desc_hist_xla` compute.  The TPU kernels DMA an
// 8x128-aligned [WR, 256] slab per keypoint because the TPU's vector layout
// asks for it; here each block reads its keypoint's window straight from the
// stacked [S, H, W] planes.  That equals the slab semantics while the window
// lies inside the slab, i.e. for window radii up to 63 (the wrapper asserts
// it; the defaults are 8 and 19).
//
// What bounds them on an H100: memory.  Per active keypoint a block reads
// its window of `mag` and `ort` once (2 * 4 B per pixel: (2R)^2 pixels for
// K1, (2R+1)^2 for K2) and writes 36 or 128 floats; inactive slots read
// nothing and write zeros.  The arithmetic per pixel is a few dozen flops
// (K2: 128 trilinear products), far below the card's f32 rate per byte.
// Design against that bound, kept simple in this first version: one block
// per keypoint; the window is staged once through shared memory as per-pixel
// (weight, bin) records in chunks of CHUNK pixels, so each plane pixel is
// read from device memory once; then each thread owns one output bin and
// sums it over the staged pixels in pixel order.  No atomics: the same
// inputs give the same bits on every run.  The window rows are 2R apart in
// memory, so loads are short coalesced runs; staging with cp.async/TMA and
// several keypoints per block are left for later.
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
constexpr int CHUNK = 2048;  // staged window pixels per pass

// f32 constants rounded from double, as the JAX package's weakly typed
// Python constants are
constexpr float TWO_PI_F = (float)6.283185307179586;
constexpr float ORI_SCALE = (float)(36.0 / 6.283185307179586);
constexpr float DESC_ORI_SCALE = (float)(8.0 / 6.283185307179586);

__device__ __forceinline__ float hat(float d) {
  return fmaxf(0.f, 1.f - fabsf(d));
}

// K1: per keypoint, 36-bin hard-binned histogram of exp(-r^2*invden)*mag
// over dy, dx in [-rad, rad-1], r^2 <= rad^2, inside the interior
// [1, h-2] x [1, w-2] of the keypoint's octave (windows.py:217-234).
__global__ void __launch_bounds__(128)
ori_hist_kernel(const float* __restrict__ mag, const float* __restrict__ ort,
                int S, int H, int W,
                const int* __restrict__ ks, const int* __restrict__ ky,
                const int* __restrict__ kx, const float* __restrict__ krad,
                const float* __restrict__ kinvden,
                const float* __restrict__ khb, const float* __restrict__ kwb,
                const uint8_t* __restrict__ kactive, int R,
                float* __restrict__ out) {
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  float* o = out + (size_t)k * ORI_NBINS;
  if (!kactive[k]) {
    if (t < ORI_NBINS) o[t] = 0.f;
    return;
  }
  __shared__ float w_s[CHUNK];
  __shared__ uint8_t b_s[CHUNK];

  const int s = min(max(ks[k], 0), S - 1);
  const float yf = (float)ky[k], xf = (float)kx[k];
  const float rad = krad[k], invden = kinvden[k];
  // rows/cols past the plane are zero padding in the reference; they lie
  // outside the interior mask anyway, so bounding by the plane is exact
  const float hb = fminf(khb[k], (float)H), wb = fminf(kwb[k], (float)W);
  const float* mp = mag + (size_t)s * H * W;
  const float* op = ort + (size_t)s * H * W;
  const int side = 2 * R;
  const int npix = side * side;

  float acc = 0.f;  // thread t < 36 owns bin t
  for (int base = 0; base < npix; base += CHUNK) {
    const int n = min(CHUNK, npix - base);
    for (int i = t; i < n; i += blockDim.x) {
      const int p = base + i;
      const float dy = (float)(p / side - R), dx = (float)(p % side - R);
      const float py = yf + dy, px = xf + dx;
      const float r2 = dy * dy + dx * dx;
      const bool inside = dy >= -rad && dy <= rad - 1.f && dx >= -rad &&
                          dx <= rad - 1.f && r2 <= rad * rad && px >= 1.f &&
                          px <= wb - 2.f && py >= 1.f && py <= hb - 2.f;
      float w = 0.f;
      int b = 0;
      if (inside) {
        const size_t off = (size_t)py * W + (size_t)px;
        w = expf(-r2 * invden) * mp[off];
        // round-half-away hard binning (ort >= 0); no fused multiply-add,
        // so a value on a bin edge lands where the reference puts it
        b = (int)floorf(__fadd_rn(__fmul_rn(op[off], ORI_SCALE), 0.5f));
        if (b >= ORI_NBINS) b -= ORI_NBINS;
      }
      w_s[i] = w;
      b_s[i] = (uint8_t)b;
    }
    __syncthreads();
    if (t < ORI_NBINS) {
      for (int i = 0; i < n; ++i)
        if (b_s[i] == t) acc += w_s[i];
    }
    __syncthreads();
  }
  if (t < ORI_NBINS) o[t] = acc;
}

// K2: per keypoint, the raw 4x4x8 SIFT histogram with trilinear hats,
// circular in orientation, over |dy|, |dx| <= radius, r^2 <= radius^2,
// inside the octave interior (windows.py:428-451).
__global__ void __launch_bounds__(DESC_LEN)
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
                 const uint8_t* __restrict__ kactive, int R,
                 float* __restrict__ out) {
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  float* o = out + (size_t)k * DESC_LEN;
  if (!kactive[k]) {
    o[t] = 0.f;
    return;
  }
  __shared__ float4 rec[CHUNK];  // (wgt, ybin, xbin, hbin) per pixel

  const int s = min(max(ks[k], 0), S - 1);
  const float yf = (float)ky[k], xf = (float)kx[k];
  const float radius = kradius[k], hw = khw[k];
  const float co = kcos[k], si = ksin[k], dirv = kdir[k];
  const float hb = fminf(khb[k], (float)H), wb = fminf(kwb[k], (float)W);
  const float* mp = mag + (size_t)s * H * W;
  const float* op = ort + (size_t)s * H * W;
  const int side = 2 * R + 1;
  const int npix = side * side;

  // this thread's output bin (q = by*4 + bx, o)
  const float by = (float)(t / (DESC_W4 * DESC_NB));
  const float bx = (float)((t / DESC_NB) % DESC_W4);
  const float bo = (float)(t % DESC_NB);

  float acc = 0.f;
  for (int base = 0; base < npix; base += CHUNK) {
    const int n = min(CHUNK, npix - base);
    for (int i = t; i < n; i += blockDim.x) {
      const int p = base + i;
      const float fy = (float)(p / side - R), fx = (float)(p % side - R);
      const float py = yf + fy, px = xf + fx;
      const float r2 = fy * fy + fx * fx;
      bool inside = fabsf(fy) <= radius && fabsf(fx) <= radius &&
                    r2 <= radius * radius && px >= 1.f && px <= wb - 2.f &&
                    py >= 1.f && py <= hb - 2.f;
      // rounded like the reference's separate f32 ops (no fused
      // multiply-add): ybin/xbin == 3 is kept at full hat weight while
      // anything above is dropped, so these bits decide pixels
      const float x_rot =
          __fdiv_rn(__fadd_rn(__fmul_rn(fx, co), __fmul_rn(fy, si)), hw);
      const float y_rot =
          __fdiv_rn(__fadd_rn(__fmul_rn(-fx, si), __fmul_rn(fy, co)), hw);
      const float ybin = __fadd_rn(__fadd_rn(y_rot, 2.f), -0.5f);
      const float xbin = __fadd_rn(__fadd_rn(x_rot, 2.f), -0.5f);
      inside = inside && ybin >= -1.f && ybin <= 3.f && xbin >= -1.f &&
               xbin <= 3.f;
      float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
      if (inside) {
        const size_t off = (size_t)py * W + (size_t)px;
        float now = op[off] - dirv;
        if (now < 0.f) now += TWO_PI_F;
        if (now > TWO_PI_F) now -= TWO_PI_F;
        r.x = expf(-__fadd_rn(__fmul_rn(x_rot, x_rot),
                              __fmul_rn(y_rot, y_rot)) / 32.f) * mp[off];
        r.y = ybin;
        r.z = xbin;
        r.w = now * DESC_ORI_SCALE;
      }
      rec[i] = r;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float4 r = rec[i];
      if (r.x == 0.f) continue;  // adds exactly nothing; uniform branch
      const float d = fabsf(r.w - bo);
      acc += r.x * hat(r.y - by) * hat(r.z - bx) *
             hat(fminf(d, (float)DESC_NB - d));
    }
    __syncthreads();
  }
  o[t] = acc;
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

}  // namespace

extern "C" int ori_hist_launch(const void* mag, const void* ort, int S, int H,
                               int W, const void* s, const void* y,
                               const void* x, const void* rad,
                               const void* invden, const void* hb,
                               const void* wb, const void* active, int K,
                               int R, void* out, void* stream) {
  if (K > 0) {
    ori_hist_kernel<<<K, 128, 0, (cudaStream_t)stream>>>(
        (const float*)mag, (const float*)ort, S, H, W, (const int*)s,
        (const int*)y, (const int*)x, (const float*)rad,
        (const float*)invden, (const float*)hb, (const float*)wb,
        (const uint8_t*)active, R, (float*)out);
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
  if (K > 0) {
    desc_hist_kernel<<<K, DESC_LEN, 0, (cudaStream_t)stream>>>(
        (const float*)mag, (const float*)ort, S, H, W, (const int*)s,
        (const int*)y, (const int*)x, (const float*)radius, (const float*)hw,
        (const float*)cos_o, (const float*)sin_o, (const float*)dirv,
        (const float*)hb, (const float*)wb, (const uint8_t*)active, R,
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
