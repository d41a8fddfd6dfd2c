// Rigid transform and pinhole projection for Hopper (sm_90a): the forward and
// the VJP of monodepth2_torch/ops/geometry.py `project`,
//   c  = K (R p + t),  uv = (c.xy / (c.z + eps)) / (W-1, H-1) * 2 - 1.
//
// Replaces no TPU kernel: the JAX package leaves `project` to XLA
// (monodepth2_tpu/ops/geometry.py `project`), which fuses it into a few loops.
// Under ATen on the card it was ~10 forward and ~15 backward elementwise
// kernels and three small-N cuBLAS products a source, each pass over (B,P,3)
// fp32 tensors; and the product that gives dR, [B,3,P] x [B,P,3] with a
// reduction of P = H*W points, ran as one CTA a batch entry walking P in
// series: 2.92 ms of a 13.25 ms step at batch 4 (PERF.md).
//
// Layouts (float32, contiguous): points (B,P,3); K (3,3) shared (k_stride 0)
// or (B,3,3) per item (k_stride 9); R (B,3,3); t (B,3,1); uv and g (B,P,2);
// d_points (B,P,3); partial (B,nblk,12); dR (B,3,3); dt (B,3,1).
//
// Bound on an H100 SXM (3.35 TB/s) by bytes, at batch 4's shape B = 16,
// P = 53,248 (one source):
//   project_fwd: points 10.2 MB + uv 6.8 MB              = 17.0 MB -> 5.1 us
//   project_bwd: points 10.2 + g 6.8 + d_points 10.2 MB  = 27.3 MB -> 8.1 us
// About 30 and 60 fp32 operations a point are far below the 67 TFLOP/s fp32
// rate, so both are bound by bytes.
//
// project_fwd: one thread a point. K, R and t of the point's item are
// uniform loads into registers. The arithmetic takes the plain expression's
// operations in its order: each 3-term product is an fma chain over k = 0,
// 1, 2, as cuBLAS's k-loop runs it; the divisions by W-1 and H-1 are
// products with their float reciprocals, as ATen divides by a scalar. So the
// result matches the plain version on the card to rounding.
//
// project_bwd: one pass over the points, saving nothing from the forward. A
// thread takes kPoints points of its block's span, warp-strided (lane l
// takes l, l + 32, ... of its warp's rows, so each warp-wide access covers
// contiguous lines), issues all their loads, then recomputes q and c, forms
// g_c -> g_q = Kᵀ g_c, writes d_points = Rᵀ g_q and keeps dR = Σ g_q ⊗ p
// and dt = Σ g_q (12 floats) in registers. Warp shuffles and one shared row
// a warp sum them in a fixed tree, and the block writes its 12 partials.
// project_bwd_reduce_kernel then sums each item's partials in block order.
// No atomics: dR and dt are the same bits on every run and every graph
// replay. The gradient with respect to K is not computed (no caller asks for
// it; the wrapper refuses a K that requires grad).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 4;                  // points a thread, backward
constexpr int kSpan = kThreads * kPoints;   // points a block, backward
constexpr int kPartials = 12;               // dR (9, row-major) and dt (3)
constexpr int kReduceThreads = 128;

struct Camera {
  float k[9], r[9], t[3];
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ K, int k_stride,
                                              const float* __restrict__ R,
                                              const float* __restrict__ t, int b) {
  Camera cam;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    cam.k[i] = __ldg(K + (long long)b * k_stride + i);
    cam.r[i] = __ldg(R + (long long)b * 9 + i);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) cam.t[i] = __ldg(t + (long long)b * 3 + i);
  return cam;
}

// Row i of the row-major 3x3 m times x, as a k-loop of fmas.
__device__ __forceinline__ float row_dot(const float* m, int i, float x0, float x1, float x2) {
  return fmaf(m[3 * i + 2], x2, fmaf(m[3 * i + 1], x1, m[3 * i] * x0));
}

// Column j of the row-major 3x3 m times x: (mᵀ x)_j.
__device__ __forceinline__ float col_dot(const float* m, int j, float x0, float x1, float x2) {
  return fmaf(m[6 + j], x2, fmaf(m[3 + j], x1, m[j] * x0));
}

// c = K (R p + t), in the plain expression's order.
__device__ __forceinline__ void camera_point(const Camera& cam, float p0, float p1, float p2,
                                             float c[3]) {
  float q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) q[i] = row_dot(cam.r, i, p0, p1, p2) + cam.t[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = row_dot(cam.k, i, q[0], q[1], q[2]);
}

__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const float* __restrict__ points, const float* __restrict__ K,
                   const float* __restrict__ R, const float* __restrict__ t,
                   float* __restrict__ uv, int P, int blocks_per_item, int k_stride, float sx,
                   float sy, float eps) {
  const int b = blockIdx.x / blocks_per_item;
  const int i = (blockIdx.x - b * blocks_per_item) * kThreads + threadIdx.x;
  if (i >= P) return;
  const Camera cam = load_camera(K, k_stride, R, t, b);
  const long long n = (long long)b * P + i;
  float c[3];
  camera_point(cam, __ldg(points + 3 * n), __ldg(points + 3 * n + 1), __ldg(points + 3 * n + 2), c);
  const float denom = 1.0f / (c[2] + eps);
  float2 out;
  out.x = ((c[0] * denom) * sx) * 2.0f - 1.0f;
  out.y = ((c[1] * denom) * sy) * 2.0f - 1.0f;
  reinterpret_cast<float2*>(uv)[n] = out;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const float* __restrict__ points, const float* __restrict__ K,
                   const float* __restrict__ R, const float* __restrict__ t,
                   const float* __restrict__ g, float* __restrict__ d_points,
                   float* __restrict__ partial, int P, int blocks_per_item, int k_stride,
                   float sx, float sy, float eps) {
  __shared__ float rows[kThreads / 32][kPartials];
  const int b = blockIdx.x / blocks_per_item;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = (blockIdx.x - b * blocks_per_item) * kSpan + warp * 32 * kPoints + lane;
  const Camera cam = load_camera(K, k_stride, R, t, b);

  float p[kPoints][3], gg[kPoints][2];
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int i = first + 32 * k;
    if (i < P) {
      const long long n = (long long)b * P + i;
#pragma unroll
      for (int j = 0; j < 3; ++j) p[k][j] = __ldg(points + 3 * n + j);
      const float2 gk = __ldcs(reinterpret_cast<const float2*>(g) + n);
      gg[k][0] = gk.x;
      gg[k][1] = gk.y;
    }
  }

  float acc[kPartials];
#pragma unroll
  for (int c = 0; c < kPartials; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int i = first + 32 * k;
    if (i < P) {
      float c[3];
      camera_point(cam, p[k][0], p[k][1], p[k][2], c);
      const float denom = 1.0f / (c[2] + eps);
      // the backward of uv = (c.xy * denom) * (sx, sy) * 2 - 1
      const float gu = (gg[k][0] * 2.0f) * sx;
      const float gv = (gg[k][1] * 2.0f) * sy;
      // two products and a sum, as the plain version's reduction takes them (no fma)
      const float gden = __fadd_rn(__fmul_rn(gu, c[0]), __fmul_rn(gv, c[1]));
      const float gc0 = gu * denom;
      const float gc1 = gv * denom;
      const float gc2 = -gden * (denom * denom);
      float gq[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) gq[j] = col_dot(cam.k, j, gc0, gc1, gc2);
      const long long n = (long long)b * P + i;
#pragma unroll
      for (int j = 0; j < 3; ++j) d_points[3 * n + j] = col_dot(cam.r, j, gq[0], gq[1], gq[2]);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[3 * r + j] = fmaf(gq[r], p[k][j], acc[3 * r + j]);
        acc[9 + r] += gq[r];
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kPartials; ++c) acc[c] = warp_sum(acc[c]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kPartials; ++c) rows[warp][c] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x < kPartials) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += rows[w][threadIdx.x];
    partial[(long long)blockIdx.x * kPartials + threadIdx.x] = s;
  }
}

// One thread an (item, component): the item's block partials summed in
// block order, into dR (components 0-8) or dt (9-11).
__global__ void project_bwd_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ dR, float* __restrict__ dt,
                                          int B, int blocks_per_item) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B * kPartials) return;
  const int b = j / kPartials, c = j - b * kPartials;
  const float* src = partial + (long long)b * blocks_per_item * kPartials + c;
  float s = 0.0f;
  for (int k = 0; k < blocks_per_item; ++k) s += src[(long long)k * kPartials];
  if (c < 9)
    dR[b * 9 + c] = s;
  else
    dt[b * 3 + c - 9] = s;
}

}  // namespace

extern "C" {

// The blocks a project_bwd launch takes per item: the partials buffer holds
// (B, project_bwd_blocks(P), 12) floats.
int project_bwd_blocks(int P) { return (P + kSpan - 1) / kSpan; }

// Each launcher enqueues its kernels on `stream` and returns
// cudaGetLastError(): nonzero if a launch was refused.
int project_fwd(const void* points, const void* K, const void* R, const void* t, void* uv,
                int B, int P, int k_stride, int W, int H, float eps, cudaStream_t stream) {
  if ((long long)B * P == 0) return 0;
  const int blocks = (P + kThreads - 1) / kThreads;
  const float sx = 1.0f / (float)(W - 1);
  const float sy = 1.0f / (float)(H - 1);
  project_fwd_kernel<<<(unsigned)((long long)B * blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(points), static_cast<const float*>(K),
      static_cast<const float*>(R), static_cast<const float*>(t), static_cast<float*>(uv), P,
      blocks, k_stride, sx, sy, eps);
  return (int)cudaGetLastError();
}

// partial holds (B, project_bwd_blocks(P), 12) floats of scratch; dR and dt
// are written whole (zeros for P = 0).
int project_bwd(const void* points, const void* K, const void* R, const void* t,
                const void* g, void* d_points, void* partial, void* dR, void* dt, int B, int P,
                int k_stride, int W, int H, float eps, cudaStream_t stream) {
  if (B == 0) return 0;
  const int blocks = project_bwd_blocks(P);
  const float sx = 1.0f / (float)(W - 1);
  const float sy = 1.0f / (float)(H - 1);
  if (blocks > 0) {
    project_bwd_kernel<<<(unsigned)((long long)B * blocks), kThreads, 0, stream>>>(
        static_cast<const float*>(points), static_cast<const float*>(K),
        static_cast<const float*>(R), static_cast<const float*>(t),
        static_cast<const float*>(g), static_cast<float*>(d_points),
        static_cast<float*>(partial), P, blocks, k_stride, sx, sy, eps);
    const int code = (int)cudaGetLastError();
    if (code != 0) return code;
  }
  project_bwd_reduce_kernel<<<(B * kPartials + kReduceThreads - 1) / kReduceThreads,
                              kReduceThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dR), static_cast<float*>(dt), B,
      blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
