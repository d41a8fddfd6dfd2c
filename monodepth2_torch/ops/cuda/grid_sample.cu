// Bilinear, border-clamped grid sample for Hopper (sm_90a): the forward, the
// coordinate VJP and the image VJP of monodepth2_torch/ops/grid_sample.py.
//
// Replaces the Pallas TPU kernels in
// monodepth2_tpu/ops/pallas/grid_sample_kernel.py:
//   grid_sample_fwd     <- _fwd_kernel (:116, called by _fwd_call :296) and
//                          _fwd_kernel_colband (:175, _fwd_call_colband :318)
//   grid_sample_bwd_uv  <- _bwd_duv_kernel (:124, _bwd_duv_call :344) and
//                          _bwd_duv_kernel_colband (:186, _bwd_duv_call_colband :368)
//   grid_sample_bwd_img <- _bwd_dimg_kernel (:154, _bwd_dimg_call :398) and
//                          _bwd_dimg_kernel_colband (:214, _bwd_dimg_call_colband
//                          :419, its windows folded at :439-450)
// The TPU kernels sample through one-hot matrix contractions over 128-column
// windows because a TPU gathers slowly. Hopper gathers natively, so the
// kernels here are direct 4-tap gathers (and, for the image VJP, 4-tap
// scatters), in fp32, with no windows, no point chunks and no folding of C
// into N.
//
// Layouts (all float32, contiguous): img (N,H,W,C), uv (N,P,2) with
// uv[...,0] = x in (-1,1), out and g (N,P,C), duv (N,P,2), dimg (N,H,W,C).
//
// Bound on an H100 SXM (3.35 TB/s) at the training shape
// N = Src*S*batch = 32, H = 128, W = 416, P = H*W = 53,248, C = 1:
//   fwd:    img 6.8 MB + uv 13.6 MB + out 6.8 MB          = 27.3 MB ->  8.1 us
//   bwd_uv: img 6.8 MB + uv 13.6 MB + g 6.8 MB + duv 13.6 MB = 40.9 MB -> 12.2 us
//   bwd_img: uv 13.6 MB + g 6.8 MB + dimg 6.8 MB           = 27.3 MB ->  8.1 us
//            with the wrapper's zero fill of dimg (+6.8 MB)  = 34.1 MB -> 10.2 us
//            at C = 3: 54.5 MB -> 16.3 us, with the fill 74.9 MB -> 22.4 us
// About 25-36 fp32 operations a point are far below the 67 TFLOP/s fp32
// rate, so all three are bound by bytes.
//
// K1 and K2 (grid_sample_fwd, grid_sample_bwd_uv). Each byte of uv, g, out
// and duv moves once, coalesced; the 4 taps of one image (213 KB) are reused
// by neighbouring points from L1/L2 rather than device memory; each point's
// coordinate gradient is summed over C in registers, so no atomics and no
// second pass are needed. What kept the first design (one point a thread)
// at a third of its bound was too few bytes in flight and too many
// instructions a point, so:
//   - a 2-D grid, one image a row (blockIdx.y), with 32-bit offsets inside
//     an image: no 64-bit division to find the image of a point;
//   - 2 points a thread, their uv loads and then all 8 tap gathers issued
//     before any is used, in blocks of 256 threads. The points are
//     warp-strided (lane l takes l and l + 32 of its warp's 64), so that
//     each warp-wide access stays contiguous. A first version gave each
//     thread 4 consecutive points with 16-B accesses: each warp-wide
//     gather then spread over 4 times the cache lines, and at C = 3 K1 ran
//     1.7 times slower than one point a thread (PERF.md);
//   - uv and duv as one 8-B access a point (float2), out and g as one 4-B
//     access a point and channel: contiguous across the warp either way;
//   - C a template parameter, compiled for 1 (the training path) and 3, with
//     a run-time loop over channels for any other C;
//   - streaming, evict-first loads and stores (__ldcs/__stcs) for uv, g, out
//     and duv, which are touched once; the image's taps go through __ldg;
//   - the ragged tail masked point by point, and a uv that is not 8-B
//     aligned read a float at a time, in the same launch (the launcher
//     checks the pointers); the per-point arithmetic is the same expression
//     on every path.
// No shared memory, TMA or persistent grid: the taps of a near-identity
// warp hit L1/L2. What limits the kernels now is in PERF.md; the next lever
// is a band of image rows staged into shared memory with cp.async or TMA
// (the Hopper form of the TPU's column band), with the points that fall
// outside the band read from global memory.
//
// K3 (grid_sample_bwd_img): the image VJP is a scatter. A pixel collects
// from every point whose taps reach it, in no order known ahead, so sums
// meet in a buffer the wrapper zeroed on the same stream. Adding each term
// straight into device memory makes 4·C fp32 atomics a point, a warp's adds
// of one channel stride 4·C bytes (C times the L2 sectors), and clamped
// points pile their adds onto the border pixels. So a block of points first
// sums into shared memory: near the identity its points' taps fall on a
// band of a few rows, which it accumulates channel-planar (one channel's
// adds hit neighbouring banks) and adds into d_img once, as contiguous 16-B
// vector reductions: the Hopper form of the TPU's column band. Where the
// taps spread over more rows than the block's shared memory holds
// (scattered uv), it adds to d_img directly, except on the border pixels,
// which it sums in a shared copy first. Both are exact and live in the same
// launch (details at the kernel); what limits it is in PERF.md. Training
// never launches the image VJP: source frames are data.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Taps {
  int x0, x1, y0, y1;
  float wx, wy;
  bool inside_u, inside_v;
};

// Clamped indices and weights, as _coords (grid_sample_kernel.py:65-80).
__device__ __forceinline__ Taps coords(float un, float vn, int H, int W) {
  Taps t;
  const float wm1 = (float)(W - 1);
  const float hm1 = (float)(H - 1);
  float u = (un + 1.0f) * 0.5f * wm1;
  float v = (vn + 1.0f) * 0.5f * hm1;
  // the Pallas border rule: a sample exactly on the border is inside
  t.inside_u = (u >= 0.0f) && (u <= wm1);
  t.inside_v = (v >= 0.0f) && (v <= hm1);
  u = fminf(fmaxf(u, 0.0f), wm1);
  v = fminf(fmaxf(v, 0.0f), hm1);
  const float x0 = floorf(u);
  const float y0 = floorf(v);
  t.wx = u - x0;
  t.wy = v - y0;
  // integer clamps keep every read in bounds, NaN coordinates included
  t.x0 = min(max((int)x0, 0), W - 1);
  t.y0 = min(max((int)y0, 0), H - 1);
  t.x1 = min(t.x0 + 1, W - 1);
  t.y1 = min(t.y0 + 1, H - 1);
  return t;
}

// One sample: the 4 taps p00 p01 p10 p11 lerped by (wx, wy). K1's and K2's
// arithmetic is the same expression on every path (either uv load, any C),
// so all of them round alike.
__device__ __forceinline__ float lerp_taps(float p00, float p01, float p10,
                                           float p11, const Taps& t) {
  const float top = p00 * (1.0f - t.wx) + p01 * t.wx;
  const float bot = p10 * (1.0f - t.wx) + p11 * t.wx;
  return top * (1.0f - t.wy) + bot * t.wy;
}

// One channel's terms of the coordinate VJP, added into du and dv:
// d_u = Σ_c g·((p01−p00)(1−wy) + (p11−p10)wy), d_v = Σ_c g·(bot − top),
// the per-point form of Σ_h Wy ⊙ (img·(O1x−O0x)) and Σ_h (O1y−O0y) ⊙
// (img·Wx) (_bwd_duv_kernel :146-147).
__device__ __forceinline__ void add_duv(float p00, float p01, float p10,
                                        float p11, float gc, const Taps& t,
                                        float& du, float& dv) {
  const float top = p00 * (1.0f - t.wx) + p01 * t.wx;
  const float bot = p10 * (1.0f - t.wx) + p11 * t.wx;
  du += gc * ((p01 - p00) * (1.0f - t.wy) + (p11 - p10) * t.wy);
  dv += gc * (bot - top);
}

// Zeroed where the sample was clamped (:149-151), scaled by (W−1)/2 and
// (H−1)/2 (_sample_bwd :575-576).
__device__ __forceinline__ float2 finish_duv(float du, float dv, const Taps& t,
                                             int H, int W) {
  return make_float2(t.inside_u ? du * ((W - 1) * 0.5f) : 0.0f,
                     t.inside_v ? dv * ((H - 1) * 0.5f) : 0.0f);
}

// K1 and K2 share one launch shape: the image is blockIdx.y (the launcher
// splits a call past 65,535 images), and each warp takes 32·kPts
// consecutive points of it, lane l the points l, l + 32, ..., so every
// warp-wide load or store of uv, g, out and duv is contiguous and every
// warp-wide tap gather reads 32 neighbouring points' taps. A block spans
// kThreads·kPts points. No thread returns early: a point past P reads point
// P − 1 and writes nothing (an early return, with the image taken from
// blockIdx.y and z, timed slower). Every offset is a 32-bit int: the
// wrapper refuses sizes of 2^31 elements or more.
constexpr int kPts = 2;
constexpr int kThreads = 256;
constexpr int kSpan = kThreads * kPts;
constexpr int kMaxGridY = 65535;

// This thread's first point in its image (its k-th is + 32·k).
__device__ __forceinline__ int first_point() {
  return (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * (32 * kPts) + (threadIdx.x & 31);
}

// The coordinates of this thread's points, a point past P (the ragged
// tail) read as point P − 1. uv comes in as one 8-B load a point where it
// is 8-B aligned (`vec`), else a float at a time.
__device__ __forceinline__ void load_coords(const float* __restrict__ uvn,
                                            int p0, int P, int vec, int H,
                                            int W, Taps (&t)[kPts]) {
  if (vec) {
    const float2* q = reinterpret_cast<const float2*>(uvn);
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const float2 u = __ldcs(q + min(p0 + 32 * k, P - 1));
      t[k] = coords(u.x, u.y, H, W);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const int p = min(p0 + 32 * k, P - 1);
      t[k] = coords(__ldcs(uvn + 2 * p), __ldcs(uvn + 2 * p + 1), H, W);
    }
  }
}

// The 4 taps of one point for channels c0 .. c0 + KC − 1 of nc.
template <int KC>
__device__ __forceinline__ void gather_taps(const float* __restrict__ base,
                                            const Taps& t, int W, int nc,
                                            int c0, float (&v)[4][KC]) {
  const float* r0 = base + t.y0 * W * nc + c0;
  const float* r1 = base + t.y1 * W * nc + c0;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    v[0][c] = __ldg(r0 + t.x0 * nc + c);
    v[1][c] = __ldg(r0 + t.x1 * nc + c);
    v[2][c] = __ldg(r1 + t.x0 * nc + c);
    v[3][c] = __ldg(r1 + t.x1 * nc + c);
  }
}

// CT > 0: C is CT, known at compile time, and a thread gathers all
// channels of its points at once; CT = 0: any other C, read at run time,
// one channel after another. A thread reads its points' uv, then issues all
// of their tap gathers before it uses any. uv and out are touched once, so
// they are read and written with the streaming (evict-first) hints; the
// image, whose taps neighbouring points share, goes through __ldg.
template <int CT>
__global__ void __launch_bounds__(kThreads)
    grid_sample_fwd_kernel(const float* __restrict__ img,
                           const float* __restrict__ uv,
                           float* __restrict__ out, int H, int W, int C, int P,
                           int vec) {
  constexpr int KC = CT > 0 ? CT : 1;
  const int nc = CT > 0 ? CT : C;
  const int n = blockIdx.y;
  const int p0 = first_point();
  const float* base = img + n * H * W * nc;
  float* outn = out + n * P * nc;
  Taps t[kPts];
  load_coords(uv + n * P * 2, p0, P, vec, H, W, t);
  for (int c0 = 0; c0 < nc; c0 += KC) {
    float v[kPts][4][KC];
#pragma unroll
    for (int k = 0; k < kPts; ++k) gather_taps<KC>(base, t[k], W, nc, c0, v[k]);
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const int p = p0 + 32 * k;
      if (p < P) {
#pragma unroll
        for (int c = 0; c < KC; ++c)
          __stcs(outn + p * nc + c0 + c,
                 lerp_taps(v[k][0][c], v[k][1][c], v[k][2][c], v[k][3][c], t[k]));
      }
    }
  }
}

// The coordinate VJP, in K1's launch shape: each point's du and dv summed
// over C in registers (no atomics, no second pass); duv goes out as one
// 8-B store a point where uv and duv are 8-B aligned (`vec`).
template <int CT>
__global__ void __launch_bounds__(kThreads)
    grid_sample_bwd_uv_kernel(const float* __restrict__ img,
                              const float* __restrict__ uv,
                              const float* __restrict__ g,
                              float* __restrict__ duv, int H, int W, int C,
                              int P, int vec) {
  constexpr int KC = CT > 0 ? CT : 1;
  const int nc = CT > 0 ? CT : C;
  const int n = blockIdx.y;
  const int p0 = first_point();
  const float* base = img + n * H * W * nc;
  const float* gn = g + n * P * nc;
  float* duvn = duv + n * P * 2;
  Taps t[kPts];
  load_coords(uv + n * P * 2, p0, P, vec, H, W, t);
  float du[kPts] = {};
  float dv[kPts] = {};
  for (int c0 = 0; c0 < nc; c0 += KC) {
    float gv[kPts][KC];
#pragma unroll
    for (int k = 0; k < kPts; ++k)
#pragma unroll
      for (int c = 0; c < KC; ++c) gv[k][c] = __ldcs(gn + min(p0 + 32 * k, P - 1) * nc + c0 + c);
    float v[kPts][4][KC];
#pragma unroll
    for (int k = 0; k < kPts; ++k) gather_taps<KC>(base, t[k], W, nc, c0, v[k]);
#pragma unroll
    for (int k = 0; k < kPts; ++k)
#pragma unroll
      for (int c = 0; c < KC; ++c)
        add_duv(v[k][0][c], v[k][1][c], v[k][2][c], v[k][3][c], gv[k][c], t[k], du[k], dv[k]);
  }
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int p = p0 + 32 * k;
    if (p >= P) continue;
    const float2 d = finish_duv(du[k], dv[k], t[k], H, W);
    if (vec) {
      __stcs(reinterpret_cast<float2*>(duvn) + p, d);
    } else {
      __stcs(duvn + 2 * p, d.x);
      __stcs(duvn + 2 * p + 1, d.y);
    }
  }
}

// ---------------------------------------------------------------- K3
//
// d_img[n, y, x, c] = Σ_p g[n, p, c]·w_tap(p) over the 4 clamped taps of
// every point: the scatter form of (Wy ⊙ g)·Wxᵀ (_bwd_dimg_kernel :162-163).
// A clamped tap pair (x1 = x0 at the right border, y1 = y0 at the bottom)
// adds both weights to one pixel, as the one-hot rows of the TPU kernel do.
// A block takes kImgSpan consecutive points of one image (blockIdx.y), lane
// l of a warp the points l, l + kImgThreads, ...; it runs in four phases
// between barriers that every thread meets (no thread returns early, and
// every branch between barriers is the same for the whole block):
//   1. read uv (one 8-B streaming load a point where aligned) and g, and
//      find the rows the block's clamped taps touch: the block-wide min of
//      y0 and max of y1;
//   2. zero the shared sums: the band of those rows, when rows·W·C floats fit
//      the launch's shared memory (`cap`), else the 2·(H + W) border pixels;
//   3. add the 4·C terms a point: into the band with shared-memory atomics;
//      without a band, those on a border pixel into its shared copy and the
//      rest straight into d_img. A term of exactly 0 (the weight of a tap
//      past a clamped coordinate) is not added: it would change no sum;
//   4. add the shared sums into d_img once, in NHWC order.
// The sums are channel-planar in shared memory (plane c holds channel c of
// every pixel), so a warp's adds to one channel of neighbouring pixels hit
// neighbouring banks; the flush reads them back in NHWC order, so that each
// warp's global reductions cover one contiguous run, 16 B a thread
// (sm_90's vector atomicAdd) where d_img is 16-B aligned. Atomic order
// varies, so the sums vary in their last bits from run to run.
constexpr int kImgThreads = 256;
constexpr int kImgPts = 4;
constexpr int kImgSpan = kImgThreads * kImgPts;
// Rows of band the launch makes room for beyond the at most kImgSpan / W + 2
// rows its points sit on: a warp within ±3 px of the identity touches 6 more
// (y0 from 3 rows above a point's row, y1 to 3 below).
constexpr int kBandSlackRows = 6;
// The most dynamic shared memory a block takes: two blocks fit an SM.
constexpr int kMaxSumBytes = 112 * 1024;

// Pixels of the shared border copy: row 0, row H − 1, then columns 0 and
// W − 1 between them.
__host__ __device__ __forceinline__ int border_pixels(int H, int W) {
  return 2 * W + 2 * (H > 2 ? H - 2 : 0);
}

// The pixel's place in the border copy, or -1 off the border.
__device__ __forceinline__ int border_index(int x, int y, int H, int W) {
  if (y == 0) return x;
  if (y == H - 1) return W + x;
  if (x == 0) return 2 * W + y - 1;
  if (x == W - 1) return 2 * W + H - 2 + y - 1;
  return -1;
}

// Calls add(x, y, c, term) for each of the 4·C terms of this thread's
// points (point p0 + k·kImgThreads), except a term of exactly 0 (the weight
// of a tap past a clamped coordinate), which would change no sum. CT > 0:
// the points' g in gv; CT = 0: read here.
template <int CT, class Add>
__device__ __forceinline__ void for_each_term(const float2 (&u)[kImgPts],
                                              const float (&gv)[kImgPts][CT > 0 ? CT : 1],
                                              const float* __restrict__ gn, int p0, int P, int H,
                                              int W, int nc, Add add) {
  constexpr int KC = CT > 0 ? CT : 1;
#pragma unroll
  for (int k = 0; k < kImgPts; ++k) {
    const int p = p0 + k * kImgThreads;
    if (p >= P) continue;
    const Taps t = coords(u[k].x, u[k].y, H, W);
    const float w00 = (1.0f - t.wx) * (1.0f - t.wy);
    const float w01 = t.wx * (1.0f - t.wy);
    const float w10 = (1.0f - t.wx) * t.wy;
    const float w11 = t.wx * t.wy;
    for (int c0 = 0; c0 < nc; c0 += KC) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float gc = CT > 0 ? gv[k][c] : __ldcs(gn + p * nc + c0);
        const float terms[4] = {gc * w00, gc * w01, gc * w10, gc * w11};
        const int xs[4] = {t.x0, t.x1, t.x0, t.x1};
        const int ys[4] = {t.y0, t.y0, t.y1, t.y1};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (terms[j] != 0.0f) add(xs[j], ys[j], c0 + c, terms[j]);
      }
    }
  }
}

// Adds npix pixels of planar shared sums (channel c of pixel i at
// src[c·plane + i]) into dst, nc floats a pixel; sums of 0 are skipped. The
// whole block takes part: 16-B vector reductions from the first 16-B
// aligned float of dst, scalar ones before and after.
template <int CT>
__device__ void flush_planar(const float* src, int plane, int npix, float* dst, int nc_run) {
  const int nc = CT > 0 ? CT : nc_run;
  const int total = npix * nc;
  auto value = [&](int e) {
    const int i = e / nc;
    return src[(e - i * nc) * plane + i];
  };
  const int head = min(total, (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4);
  const int nvec = (total - head) / 4;
  for (int e = threadIdx.x; e < head; e += kImgThreads) {
    const float v = value(e);
    if (v != 0.0f) atomicAdd(dst + e, v);
  }
  for (int q = threadIdx.x; q < nvec; q += kImgThreads) {
    const int e = head + 4 * q;
    const float4 v = make_float4(value(e), value(e + 1), value(e + 2), value(e + 3));
    if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
      atomicAdd(reinterpret_cast<float4*>(dst + e), v);
  }
  for (int e = head + 4 * nvec + threadIdx.x; e < total; e += kImgThreads) {
    const float v = value(e);
    if (v != 0.0f) atomicAdd(dst + e, v);
  }
}

// CT > 0: C is CT, and a thread keeps its points' g in registers from phase
// 1; CT = 0: any other C, g read in phase 3. `cap` is the floats of shared
// memory the launch gave the block (a multiple of 4).
template <int CT>
__global__ void __launch_bounds__(kImgThreads)
    grid_sample_bwd_img_kernel(const float* __restrict__ uv,
                               const float* __restrict__ g,
                               float* __restrict__ dimg, int H, int W, int C,
                               int P, int vec, int cap) {
  extern __shared__ float4 sums4[];
  __shared__ int s_lo, s_hi;
  constexpr int KC = CT > 0 ? CT : 1;
  const int nc = CT > 0 ? CT : C;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * kImgSpan + threadIdx.x;
  const float* uvn = uv + n * P * 2;
  const float* gn = g + n * P * nc;

  // 1. uv and g in; the rows of the block's taps. A point past P (the
  // ragged tail) reads point P − 1 and counts for nothing.
  if (threadIdx.x == 0) {
    s_lo = H;
    s_hi = -1;
  }
  float2 u[kImgPts];
  float gv[kImgPts][KC];
#pragma unroll
  for (int k = 0; k < kImgPts; ++k) {
    const int p = min(p0 + k * kImgThreads, P - 1);
    u[k] = vec ? __ldcs(reinterpret_cast<const float2*>(uvn) + p)
               : make_float2(__ldcs(uvn + 2 * p), __ldcs(uvn + 2 * p + 1));
    if (CT > 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c) gv[k][c] = __ldcs(gn + p * nc + c);
    }
  }
  int lo = H, hi = -1;
#pragma unroll
  for (int k = 0; k < kImgPts; ++k) {
    if (p0 + k * kImgThreads < P) {
      const Taps t = coords(u[k].x, u[k].y, H, W);
      lo = min(lo, t.y0);
      hi = max(hi, t.y1);
    }
  }
  __syncthreads();
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();

  // 2. zero the band (every block has a point, so s_lo <= s_hi) or the
  // border copy
  float* sums = reinterpret_cast<float*>(sums4);
  float* dimgn = dimg + n * H * W * nc;
  const int row0 = s_lo;
  const int rows = s_hi - s_lo + 1;
  const bool band = rows * W * nc <= cap;
  const bool border = !band && border_pixels(H, W) * nc <= cap;
  const int plane = band ? rows * W : border_pixels(H, W);
  const int used = band || border ? plane * nc : 0;
  for (int i = threadIdx.x; i < (used + 3) / 4; i += kImgThreads) sums4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  // 3. the terms
  // (sm_90 has no shared-memory fp32 add: each shared atomicAdd is a
  // compare-and-swap loop, ATOMS.CAST.SPIN, the kernel's largest cost; the
  // two paths are separate loops, so neither carries the other's branches)
  if (band) {
    for_each_term<CT>(u, gv, gn, p0, P, H, W, nc, [&](int x, int y, int c, float term) {
      atomicAdd(sums + c * plane + (y - row0) * W + x, term);
    });
  } else {
    for_each_term<CT>(u, gv, gn, p0, P, H, W, nc, [&](int x, int y, int c, float term) {
      const int b = border ? border_index(x, y, H, W) : -1;
      if (b >= 0)
        atomicAdd(sums + c * plane + b, term);
      else
        atomicAdd(dimgn + (y * W + x) * nc + c, term);
    });
  }
  __syncthreads();

  // 4. the shared sums into d_img: the band's rows are one contiguous run of
  // d_img; of the border copy, rows 0 and H − 1 are, the columns are not
  if (band) {
    flush_planar<CT>(sums, plane, rows * W, dimgn + row0 * W * nc, nc);
  } else if (border) {
    flush_planar<CT>(sums, plane, W, dimgn, nc);
    if (H > 1) flush_planar<CT>(sums + W, plane, W, dimgn + (H - 1) * W * nc, nc);
    const int inner = H > 2 ? H - 2 : 0;
    for (int e = threadIdx.x; e < 2 * inner * nc; e += kImgThreads) {
      const int i = e / nc, c = e - i * nc;
      const int side = i / inner, y = 1 + i - side * inner;
      const float v = sums[c * plane + 2 * W + i];
      if (v != 0.0f && (side == 0 || W > 1)) atomicAdd(dimgn + (y * W + (side ? W - 1 : 0)) * nc + c, v);
    }
  }
}

// Floats of shared memory a K3 launch gives each block: the band rows a
// near-identity warp needs, or the border copy if larger, within
// kMaxSumBytes; a multiple of 4 (the zero fill writes float4s).
inline int sum_floats(int H, int W, int C) {
  const long long span_rows = kImgSpan / W + 2 + kBandSlackRows;
  const long long band = (span_rows < H ? span_rows : H) * W * C;
  const long long border = (long long)border_pixels(H, W) * C;
  const long long want = band > border ? band : border;
  const long long most = kMaxSumBytes / 4;
  return (int)((want < most ? want : most) & ~3LL);
}

template <int CT>
int launch_bwd_img(dim3 grid, int smem, cudaStream_t stream, const float* u, const float* gg, float* d,
                   int H, int W, int C, int P, int vec, int cap) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(grid_sample_bwd_img_kernel<CT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  grid_sample_bwd_img_kernel<CT><<<grid, kImgThreads, smem, stream>>>(u, gg, d, H, W, C, P, vec, cap);
  return 0;
}

// K1/K2's grid for n images: P in spans of kSpan points along x, the
// images along y.
inline dim3 point_grid(int n, int P) {
  return dim3((unsigned)((P + kSpan - 1) / kSpan), (unsigned)n);
}

// uv and duv move as one 8-B access a point where they are 8-B aligned
// (every image's rows then are too: a point is 8 B).
inline bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError(): nonzero if the launch was refused. K1 and K2 dispatch
// on C: compiled for C = 1 (the training path) and C = 3, a run-time loop
// for any other C.
int grid_sample_fwd(const void* img, const void* uv, void* out, int N, int H,
                    int W, int C, int P, cudaStream_t stream) {
  if ((long long)N * P == 0) return 0;
  const int vec = aligned8(uv);
  // one launch for up to 65,535 images; more take one launch each 65,535
  for (int n0 = 0; n0 < N; n0 += kMaxGridY) {
    const int n = N - n0 < kMaxGridY ? N - n0 : kMaxGridY;
    const float* i = static_cast<const float*>(img) + (long long)n0 * H * W * C;
    const float* u = static_cast<const float*>(uv) + (long long)n0 * P * 2;
    float* o = static_cast<float*>(out) + (long long)n0 * P * C;
    const dim3 grid = point_grid(n, P);
    if (C == 1)
      grid_sample_fwd_kernel<1><<<grid, kThreads, 0, stream>>>(i, u, o, H, W, C, P, vec);
    else if (C == 3)
      grid_sample_fwd_kernel<3><<<grid, kThreads, 0, stream>>>(i, u, o, H, W, C, P, vec);
    else
      grid_sample_fwd_kernel<0><<<grid, kThreads, 0, stream>>>(i, u, o, H, W, C, P, vec);
  }
  return (int)cudaGetLastError();
}

int grid_sample_bwd_uv(const void* img, const void* uv, const void* g,
                       void* duv, int N, int H, int W, int C, int P,
                       cudaStream_t stream) {
  if ((long long)N * P == 0) return 0;
  const int vec = aligned8(uv) && aligned8(duv);
  for (int n0 = 0; n0 < N; n0 += kMaxGridY) {
    const int n = N - n0 < kMaxGridY ? N - n0 : kMaxGridY;
    const float* i = static_cast<const float*>(img) + (long long)n0 * H * W * C;
    const float* u = static_cast<const float*>(uv) + (long long)n0 * P * 2;
    const float* gg = static_cast<const float*>(g) + (long long)n0 * P * C;
    float* d = static_cast<float*>(duv) + (long long)n0 * P * 2;
    const dim3 grid = point_grid(n, P);
    if (C == 1)
      grid_sample_bwd_uv_kernel<1><<<grid, kThreads, 0, stream>>>(i, u, gg, d, H, W, C, P, vec);
    else if (C == 3)
      grid_sample_bwd_uv_kernel<3><<<grid, kThreads, 0, stream>>>(i, u, gg, d, H, W, C, P, vec);
    else
      grid_sample_bwd_uv_kernel<0><<<grid, kThreads, 0, stream>>>(i, u, gg, d, H, W, C, P, vec);
  }
  return (int)cudaGetLastError();
}

// dimg must hold zeros, written on the same stream before this launch.
int grid_sample_bwd_img(const void* uv, const void* g, void* dimg, int N, int H,
                        int W, int C, int P, cudaStream_t stream) {
  if ((long long)N * P == 0) return 0;
  const int vec = aligned8(uv);
  const int cap = sum_floats(H, W, C);
  const int smem = 4 * cap;
  for (int n0 = 0; n0 < N; n0 += kMaxGridY) {
    const int n = N - n0 < kMaxGridY ? N - n0 : kMaxGridY;
    const float* u = static_cast<const float*>(uv) + (long long)n0 * P * 2;
    const float* gg = static_cast<const float*>(g) + (long long)n0 * P * C;
    float* d = static_cast<float*>(dimg) + (long long)n0 * H * W * C;
    const dim3 grid((unsigned)((P + kImgSpan - 1) / kImgSpan), (unsigned)n);
    const int code = C == 1   ? launch_bwd_img<1>(grid, smem, stream, u, gg, d, H, W, C, P, vec, cap)
                     : C == 3 ? launch_bwd_img<3>(grid, smem, stream, u, gg, d, H, W, C, P, vec, cap)
                              : launch_bwd_img<0>(grid, smem, stream, u, gg, d, H, W, C, P, vec, cap);
    if (code != 0) return code;
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory, in bytes, of each block of a K3 launch at this
// image size (ptxas's report counts only the static part).
int grid_sample_bwd_img_smem_bytes(int H, int W, int C) { return 4 * sum_floats(H, W, C); }

const char* grid_sample_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
