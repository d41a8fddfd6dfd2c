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
//            (+ 6.8 MB for the wrapper's zero fill of dimg)
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
// K3 (grid_sample_bwd_img), one thread a point: the image VJP is a scatter.
// A pixel collects from every point whose taps reach it, in no order known
// ahead, so it adds with fp32 atomics into a buffer the wrapper zeroed on
// the same stream. Neighbouring points of a warp near the identity hit
// neighbouring pixels, so the atomics resolve in L2 with little contention;
// points clamped onto the border all add to a few border pixels, and those
// atomics serialise (chip_smoke.py times both kinds of uv). Training never
// launches the image VJP: source frames are data.

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

// d_img[n, y, x, c] = Σ_p g[n, p, c]·w_tap(p) over the 4 clamped taps of
// every point: the scatter form of (Wy ⊙ g)·Wxᵀ (_bwd_dimg_kernel :162-163).
// A clamped tap pair (x1 = x0 at the right border, y1 = y0 at the bottom)
// adds both weights to one pixel, as the one-hot rows of the TPU kernel do.
// Atomic order varies, so the sum varies in its last bits from run to run.
__global__ void grid_sample_bwd_img_kernel(const float* __restrict__ uv,
                                           const float* __restrict__ g,
                                           float* __restrict__ dimg, int N,
                                           int H, int W, int C, int P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * P) return;
  const long long n = i / P;
  const Taps t = coords(uv[2 * i], uv[2 * i + 1], H, W);
  float* base = dimg + n * H * W * C;
  float* r0 = base + (long long)t.y0 * W * C;
  float* r1 = base + (long long)t.y1 * W * C;
  const float* gi = g + i * C;
  const float w00 = (1.0f - t.wx) * (1.0f - t.wy);
  const float w01 = t.wx * (1.0f - t.wy);
  const float w10 = (1.0f - t.wx) * t.wy;
  const float w11 = t.wx * t.wy;
  for (int c = 0; c < C; ++c) {
    const float gc = gi[c];
    atomicAdd(r0 + t.x0 * C + c, gc * w00);
    atomicAdd(r0 + t.x1 * C + c, gc * w01);
    atomicAdd(r1 + t.x0 * C + c, gc * w10);
    atomicAdd(r1 + t.x1 * C + c, gc * w11);
  }
}

constexpr int kImgThreads = 256;

inline int img_blocks_for(long long total) {
  return (int)((total + kImgThreads - 1) / kImgThreads);
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
  const long long total = (long long)N * P;
  if (total == 0) return 0;
  grid_sample_bwd_img_kernel<<<img_blocks_for(total), kImgThreads, 0, stream>>>(
      static_cast<const float*>(uv), static_cast<const float*>(g),
      static_cast<float*>(dimg), N, H, W, C, P);
  return (int)cudaGetLastError();
}

const char* grid_sample_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
