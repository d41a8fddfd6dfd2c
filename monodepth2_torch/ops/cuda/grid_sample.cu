// Bilinear, border-clamped grid sample for Hopper (sm_90a): the forward and
// the coordinate VJP of monodepth2_torch/ops/grid_sample.py.
//
// Replaces the Pallas TPU kernels in
// monodepth2_tpu/ops/pallas/grid_sample_kernel.py:
//   grid_sample_fwd     <- _fwd_kernel (:116, called by _fwd_call :296) and
//                          _fwd_kernel_colband (:175, _fwd_call_colband :318)
//   grid_sample_bwd_uv  <- _bwd_duv_kernel (:124, _bwd_duv_call :344) and
//                          _bwd_duv_kernel_colband (:186, _bwd_duv_call_colband :368)
// The TPU kernels sample through one-hot matrix contractions over 128-column
// windows because a TPU gathers slowly. Hopper gathers natively, so both
// kernels here are direct 4-tap gathers, exact in fp32, with no windows, no
// point chunks and no folding of C into N.
//
// Layouts (all float32, contiguous): img (N,H,W,C), uv (N,P,2) with
// uv[...,0] = x in (-1,1), out and g (N,P,C), duv (N,P,2).
//
// Bound on an H100 SXM (3.35 TB/s) at the training shape
// N = Src*S*batch = 32, H = 128, W = 416, P = H*W = 53,248, C = 1:
//   fwd:    img 6.8 MB + uv 13.6 MB + out 6.8 MB          = 27.3 MB ->  8.1 us
//   bwd_uv: img 6.8 MB + uv 13.6 MB + g 6.8 MB + duv 13.6 MB = 40.9 MB -> 12.2 us
// About 30 fp32 operations a point are far below the 67 TFLOP/s fp32 rate,
// so both are bound by bytes. The design follows from that: one thread per
// (image, point), so the uv reads and the out/duv writes are coalesced and
// each byte of them moves once; the 4 taps of one image (213 KB) are reused
// by neighbouring points from L1/L2 rather than device memory; each point's
// coordinate gradient is summed over C in registers, so no atomics and no
// second pass are needed. The image gradient (Pallas K3, _bwd_dimg_kernel
// :154) is not ported: training never asks for it.

#include <cuda_runtime.h>

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

__global__ void grid_sample_fwd_kernel(const float* __restrict__ img,
                                       const float* __restrict__ uv,
                                       float* __restrict__ out, int N, int H,
                                       int W, int C, int P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * P) return;
  const long long n = i / P;
  const Taps t = coords(uv[2 * i], uv[2 * i + 1], H, W);
  const float* base = img + n * H * W * C;
  const float* r0 = base + (long long)t.y0 * W * C;
  const float* r1 = base + (long long)t.y1 * W * C;
  float* o = out + i * C;
  for (int c = 0; c < C; ++c) {
    const float p00 = __ldg(r0 + t.x0 * C + c);
    const float p01 = __ldg(r0 + t.x1 * C + c);
    const float p10 = __ldg(r1 + t.x0 * C + c);
    const float p11 = __ldg(r1 + t.x1 * C + c);
    const float top = p00 * (1.0f - t.wx) + p01 * t.wx;
    const float bot = p10 * (1.0f - t.wx) + p11 * t.wx;
    o[c] = top * (1.0f - t.wy) + bot * t.wy;
  }
}

// d_u = Σ_c g·((p01−p00)(1−wy) + (p11−p10)wy), d_v = Σ_c g·(bot − top):
// the per-point form of Σ_h Wy ⊙ (img·(O1x−O0x)) and Σ_h (O1y−O0y) ⊙
// (img·Wx) (_bwd_duv_kernel :146-147), zeroed where the sample was clamped
// (:149-151) and scaled by (W−1)/2, (H−1)/2 (_sample_bwd :575-576).
__global__ void grid_sample_bwd_uv_kernel(const float* __restrict__ img,
                                          const float* __restrict__ uv,
                                          const float* __restrict__ g,
                                          float* __restrict__ duv, int N, int H,
                                          int W, int C, int P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * P) return;
  const long long n = i / P;
  const Taps t = coords(uv[2 * i], uv[2 * i + 1], H, W);
  const float* base = img + n * H * W * C;
  const float* r0 = base + (long long)t.y0 * W * C;
  const float* r1 = base + (long long)t.y1 * W * C;
  const float* gi = g + i * C;
  float du = 0.0f;
  float dv = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float p00 = __ldg(r0 + t.x0 * C + c);
    const float p01 = __ldg(r0 + t.x1 * C + c);
    const float p10 = __ldg(r1 + t.x0 * C + c);
    const float p11 = __ldg(r1 + t.x1 * C + c);
    const float gc = gi[c];
    const float top = p00 * (1.0f - t.wx) + p01 * t.wx;
    const float bot = p10 * (1.0f - t.wx) + p11 * t.wx;
    du += gc * ((p01 - p00) * (1.0f - t.wy) + (p11 - p10) * t.wy);
    dv += gc * (bot - top);
  }
  duv[2 * i] = t.inside_u ? du * ((W - 1) * 0.5f) : 0.0f;
  duv[2 * i + 1] = t.inside_v ? dv * ((H - 1) * 0.5f) : 0.0f;
}

constexpr int kThreads = 256;

inline int blocks_for(long long total) {
  return (int)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError(): nonzero if the launch was refused.
int grid_sample_fwd(const void* img, const void* uv, void* out, int N, int H,
                    int W, int C, int P, cudaStream_t stream) {
  const long long total = (long long)N * P;
  if (total == 0) return 0;
  grid_sample_fwd_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
      static_cast<const float*>(img), static_cast<const float*>(uv),
      static_cast<float*>(out), N, H, W, C, P);
  return (int)cudaGetLastError();
}

int grid_sample_bwd_uv(const void* img, const void* uv, const void* g,
                       void* duv, int N, int H, int W, int C, int P,
                       cudaStream_t stream) {
  const long long total = (long long)N * P;
  if (total == 0) return 0;
  grid_sample_bwd_uv_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
      static_cast<const float*>(img), static_cast<const float*>(uv),
      static_cast<const float*>(g), static_cast<float*>(duv), N, H, W, C, P);
  return (int)cudaGetLastError();
}

const char* grid_sample_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
