// Pairwise rotated IoU of K gts against N anchors, for a batch of B images
// that share one anchor set: out[b, k, n] = IoU(gt[b, k], anchor[n]).
// Two kernels, one per Pallas body: the rect kernel (rotated_iou_rect) and,
// further down, the generic kernel (rotated_iou_generic).
//
// The rect kernel replaces jdet_tpu/ops/pallas_iou.py::_iou_kernel_rect
// (the Pallas body behind the anchor assigner's IoU matrix). Same math,
// per pair: each box's
// edges are clipped against the other box's axis-aligned slab in that box's
// own frame (Liang-Barsky on a rectangle), the Green's-theorem cross terms
// of both directions are summed, shared (collinear) edges weigh 1/2, and the
// closed-loop origin correction cross(g_c - a_c, D1) joins the two frames.
// Corners are kept relative to each box's center (fp32 stays precise at
// image coordinates ~1e3). Forward only.
//
// Operands: boxes as (cx, cy, w, h, theta), float32, contiguous.
//   gt      (B, K, 5): a block's gts are expanded once into shared memory.
//   anchors (N, 5): shared by the B images; neighbouring threads read
//           neighbouring anchors.
//   out     (B, K, N) float32.
// Each box is expanded to the first 15 values of the plain version's rows
// (jdet_torch/ops/rotated_iou_kernel.py::_rect_rows): relx0-3, rely0-3,
// cx, cy, w/2, h/2, cos, sin, area. A thread expands its anchor only when
// the pair can touch.
//
// What bounds it on an H100: the B*K*N*4-byte output write (50 MB at
// B=2, K=32, N=196,416; 15 us at 3.35 TB/s), plus about 300 flops for each
// pair whose boxes can touch. Most pairs cannot: anchors tile the image,
// gts are small, and padding gts are parked at FAR_CENTER. The design
// answer is a per-pair early-out: one thread per (gt, anchor) pair tests
// the circle bound |c_a - c_g| < (w_g+h_g)/2 + (w_a+h_a)/2 and writes 0
// without the clip math when it fails (the TPU kernel's per-tile test gave
// the same zeros). Fusing the assigner's max/argmax so that the matrix is
// never written is left for later.
//
// Built without --use_fast_math: the parallel and collinear tolerances
// (1e-5 * scale + 1e-12 here, 1e-6 / 1e-5 * qn * |.| + 1e-12 in the generic
// kernel) compare against IEEE division and products.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 15;     // floats per expanded gt
constexpr int kBlockN = 128;  // anchors per block (threadIdx.x)
constexpr int kBlockK = 4;    // gts per block (threadIdx.y)
constexpr float kParEps = 1e-12f;

// Green contributions of the edges (px, py) clipped to the rect
// [-w2, w2] x [-h2, h2]: sum cross(u, v) and sum (v - u).
__device__ __forceinline__ void rect_clip_green(
    const float px[4], const float py[4], float w2, float h2, float tol,
    float& total, float& sum_dx, float& sum_dy) {
  total = 0.f;
  sum_dx = 0.f;
  sum_dy = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ax = px[i], ay = py[i];
    const float dx = px[(i + 1) & 3] - ax;
    const float dy = py[(i + 1) & 3] - ay;
    const bool par_x = fabsf(dx) <= tol;
    const bool par_y = fabsf(dy) <= tol;
    const float inv_x = 1.0f / (par_x ? 1.0f : dx);
    const float inv_y = 1.0f / (par_y ? 1.0f : dy);
    const float t1 = (-w2 - ax) * inv_x;
    const float t2 = (w2 - ax) * inv_x;
    const float t3 = (-h2 - ay) * inv_y;
    const float t4 = (h2 - ay) * inv_y;
    const float t_lo =
        fmaxf(fmaxf(par_x ? 0.f : fminf(t1, t2), par_y ? 0.f : fminf(t3, t4)),
              0.f);
    const float t_hi =
        fminf(fminf(par_x ? 1.f : fmaxf(t1, t2), par_y ? 1.f : fmaxf(t3, t4)),
              1.f);
    // an axis-parallel edge must lie inside that axis' slab
    const bool in_x = ax >= -w2 - tol && ax <= w2 + tol;
    const bool in_y = ay >= -h2 - tol && ay <= h2 + tol;
    const bool alive = (!par_x || in_x) && (!par_y || in_y);
    if (alive && t_lo < t_hi) {
      // collinear-with-boundary edges are shared boundary: weight 1/2
      const bool col = (par_x && fabsf(fabsf(ax) - w2) <= tol) ||
                       (par_y && fabsf(fabsf(ay) - h2) <= tol);
      const float wgt = col ? 0.5f : 1.0f;
      const float ux = ax + t_lo * dx, uy = ay + t_lo * dy;
      const float vx = ax + t_hi * dx, vy = ay + t_hi * dy;
      total += wgt * (ux * vy - vx * uy);
      const float span = wgt * (t_hi - t_lo);
      sum_dx += span * dx;
      sum_dy += span * dy;
    }
  }
}

// The center-relative corners of a (w, h, cos, sin) box.
__device__ __forceinline__ void rel_corners(float w, float h, float cos_t,
                                            float sin_t, float rx[4],
                                            float ry[4]) {
  const float cos2 = cos_t * 0.5f, sin2 = sin_t * 0.5f;
  rx[0] = -sin2 * h - cos2 * w;
  ry[0] = cos2 * h - sin2 * w;
  rx[1] = sin2 * h - cos2 * w;
  ry[1] = -cos2 * h - sin2 * w;
  rx[2] = -rx[0];
  ry[2] = -ry[0];
  rx[3] = -rx[1];
  ry[3] = -ry[1];
}

__global__ void __launch_bounds__(kBlockN* kBlockK)
    rotated_iou_rect_kernel(const float* __restrict__ gt,
                            const float* __restrict__ an,
                            float* __restrict__ out, int K, int N) {
  // per gt: relx0-3, rely0-3, cx, cy, w/2, h/2, cos, sin, area
  __shared__ float sg[kBlockK][kRows];
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.y * kBlockN + threadIdx.x;
  if (tid < kBlockK && k0 + tid < K) {
    const float* box = gt + (static_cast<size_t>(b) * K + k0 + tid) * 5;
    float* row = sg[tid];
    const float w = box[2], h = box[3];
    float sin_t, cos_t;
    sincosf(box[4], &sin_t, &cos_t);
    rel_corners(w, h, cos_t, sin_t, row, row + 4);
    row[8] = box[0];
    row[9] = box[1];
    row[10] = w * 0.5f;
    row[11] = h * 0.5f;
    row[12] = cos_t;
    row[13] = sin_t;
    row[14] = w * h;
  }
  __syncthreads();

  const int n = blockIdx.x * kBlockN + threadIdx.x;
  const int k = k0 + threadIdx.y;
  if (n >= N || k >= K) return;
  const float* g = sg[threadIdx.y];
  const float* a = an + static_cast<size_t>(n) * 5;
  const float gcx = g[8], gcy = g[9], gw2 = g[10], gh2 = g[11];
  const float aw = a[2], ah = a[3];
  const float aw2 = aw * 0.5f, ah2 = ah * 0.5f;

  const float dx_c = a[0] - gcx;
  const float dy_c = a[1] - gcy;
  // w2 + h2 >= half-diagonal, so rsum bounds the max overlap distance
  const float rsum = (gw2 + gh2) + (aw2 + ah2);
  float iou = 0.f;
  if (dx_c * dx_c + dy_c * dy_c < rsum * rsum) {
    const float gcos = g[12], gsin = g[13], g_area = g[14];
    float acos_, asin_;
    sincosf(a[4], &asin_, &acos_);
    const float a_area = aw * ah;
    float arx[4], ary[4];
    rel_corners(aw, ah, acos_, asin_, arx, ary);
    float pax[4], pay[4], pgx[4], pgy[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // anchor corners in the gt frame: R(-tg) @ (a_rel + d)
      const float wx = arx[c] + dx_c;
      const float wy = ary[c] + dy_c;
      pax[c] = gcos * wx + gsin * wy;
      pay[c] = gcos * wy - gsin * wx;
      // gt corners in the anchor frame: R(-ta) @ (g_rel - d)
      const float vx = g[c] - dx_c;
      const float vy = g[4 + c] - dy_c;
      pgx[c] = acos_ * vx + asin_ * vy;
      pgy[c] = acos_ * vy - asin_ * vx;
    }
    const float scale = fmaxf(gw2 + gh2, aw2 + ah2);
    const float tol = 1e-5f * scale + kParEps;
    float s1, d1x_l, d1y_l, s2, unused_x, unused_y;
    rect_clip_green(pax, pay, gw2, gh2, tol, s1, d1x_l, d1y_l);
    rect_clip_green(pgx, pgy, aw2, ah2, tol, s2, unused_x, unused_y);
    // origin correction: rotate direction 1's sum(v - u) back to world axes
    const float d1x = gcos * d1x_l - gsin * d1y_l;
    const float d1y = gsin * d1x_l + gcos * d1y_l;
    const float corr = dy_c * d1x - dx_c * d1y;  // cross(g_c - a_c, D1)
    const float s = s1 + s2 + corr;
    const float inter = fmaxf(0.5f * s, 0.f);
    const float uni = g_area + a_area - inter;
    iou = uni > 1e-9f ? inter / fmaxf(uni, 1e-9f) : 0.f;
  }
  out[(static_cast<size_t>(b) * K + k) * N + n] = iou;
}

// ---------------------------------------------------------------------------
// The generic kernel: the same IoU by general quad-quad clipping.
//
// Replaces jdet_tpu/ops/pallas_iou.py::_iou_kernel (with _green_sum and the
// operands of _planar_rows), the Pallas body that box_iou_rotated_pallas
// runs for kernel="generic". Per pair, both boxes are placed in the pair's
// midpoint frame (anchor corners + d/2, gt corners - d/2, d = a_c - g_c,
// corners relative to each box's own center, so fp32 stays precise at image
// coordinates ~1e3), each box's edges are clipped Liang-Barsky style against
// the other's four half-planes, and the Green's-theorem cross terms of both
// directions are summed; edges collinear with a clip line weigh 1/2. No
// early-out: the Pallas body has none, and this kernel's output must stay
// its output (a zero-size box, for one, is not 0 here as it is under the
// rect kernel's circle test).
//
// What bounds it on an H100: arithmetic. The reference's cost estimate is
// 700 flops per pair (pallas_iou.py:306), every pair pays it, and each of
// the 32 edge-line tests divides; at B=2, K=32, N=196,416 that is 8.8e9
// flops (0.13 ms at 67 TFLOP/s fp32) against 54 MB of traffic (16 us). The
// design is one thread per pair with no shared state beyond the block's 4
// gts, expanded once into shared memory; making it fast (fewer divisions,
// an early-out that keeps K2's values) is left for later.
//
// Operands as for the rect kernel: gt (B, K, 5), anchors (N, 5), out
// (B, K, N), float32 (cx, cy, w, h, theta). Each box is expanded to the
// plain version's generic rows (rotated_iou_kernel.py::_rect_rows columns
// 0-9 and 14): relx0-3, rely0-3, cx, cy, area.

constexpr int kGenRows = 11;  // floats per expanded gt

// Directed-boundary Green contribution of P's edges clipped to Q:
// sum over P's edges of cross(u, v) for the part [u, v] of the edge that
// lies inside Q = {p : cross(q_{j+1} - q_j, p - q_j) >= 0 for all j}.
__device__ __forceinline__ float green_sum(const float px[4],
                                           const float py[4],
                                           const float qx[4],
                                           const float qy[4]) {
  float qvx[4], qvy[4], qn[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    qvx[j] = qx[(j + 1) & 3] - qx[j];
    qvy[j] = qy[(j + 1) & 3] - qy[j];
    qn[j] = fabsf(qvx[j]) + fabsf(qvy[j]);
  }
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ax = px[i], ay = py[i];
    const float dx = px[(i + 1) & 3] - ax;
    const float dy = py[(i + 1) & 3] - ay;
    const float dn = fabsf(dx) + fabsf(dy);
    float t_lo = 0.f, t_hi = 1.f;
    bool alive = true, on_b = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // f(t) = cross(qv_j, p(t) - q_j) = f0 + t * df must stay >= 0
      const float rx = ax - qx[j];
      const float ry = ay - qy[j];
      const float f0 = qvx[j] * ry - rx * qvy[j];
      const float df = qvx[j] * dy - dx * qvy[j];
      const bool par = fabsf(df) <= 1e-6f * qn[j] * dn + kParEps;
      const bool col =
          par && fabsf(f0) <= 1e-5f * qn[j] * (fabsf(rx) + fabsf(ry)) + kParEps;
      on_b = on_b || col;
      alive = alive && (!par || col || f0 >= 0.f);
      const float tstar = -f0 / (par ? 1.f : df);
      if (!par && df > 0.f) t_lo = fmaxf(t_lo, tstar);
      if (!par && df < 0.f) t_hi = fminf(t_hi, tstar);
    }
    if (alive && t_lo < t_hi) {
      // an edge collinear with a clip line is shared boundary: weight 1/2
      const float wgt = on_b ? 0.5f : 1.0f;
      const float ux = ax + t_lo * dx, uy = ay + t_lo * dy;
      const float vx = ax + t_hi * dx, vy = ay + t_hi * dy;
      total += wgt * (ux * vy - vx * uy);
    }
  }
  return total;
}

__global__ void __launch_bounds__(kBlockN* kBlockK)
    rotated_iou_generic_kernel(const float* __restrict__ gt,
                               const float* __restrict__ an,
                               float* __restrict__ out, int K, int N) {
  // per gt: relx0-3, rely0-3, cx, cy, area
  __shared__ float sg[kBlockK][kGenRows];
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.y * kBlockN + threadIdx.x;
  if (tid < kBlockK && k0 + tid < K) {
    const float* box = gt + (static_cast<size_t>(b) * K + k0 + tid) * 5;
    float* row = sg[tid];
    float sin_t, cos_t;
    sincosf(box[4], &sin_t, &cos_t);
    rel_corners(box[2], box[3], cos_t, sin_t, row, row + 4);
    row[8] = box[0];
    row[9] = box[1];
    row[10] = box[2] * box[3];
  }
  __syncthreads();

  const int n = blockIdx.x * kBlockN + threadIdx.x;
  const int k = k0 + threadIdx.y;
  if (n >= N || k >= K) return;
  const float* g = sg[threadIdx.y];
  const float* a = an + static_cast<size_t>(n) * 5;
  float asin_, acos_;
  sincosf(a[4], &asin_, &acos_);
  float arx[4], ary[4];
  rel_corners(a[2], a[3], acos_, asin_, arx, ary);
  // pair midframe: anchor corners +d/2, gt corners -d/2, d = a_c - g_c
  const float hdx = 0.5f * (a[0] - g[8]);
  const float hdy = 0.5f * (a[1] - g[9]);
  float pax[4], pay[4], pgx[4], pgy[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    pax[c] = arx[c] + hdx;
    pay[c] = ary[c] + hdy;
    pgx[c] = g[c] - hdx;
    pgy[c] = g[4 + c] - hdy;
  }
  const float s = green_sum(pax, pay, pgx, pgy) + green_sum(pgx, pgy, pax, pay);
  const float inter = fmaxf(0.5f * s, 0.f);
  const float uni = g[10] + a[2] * a[3] - inter;
  out[(static_cast<size_t>(b) * K + k) * N + n] =
      uni > 1e-9f ? inter / fmaxf(uni, 1e-9f) : 0.f;
}

}  // namespace

// Each launches on stream s and returns cudaGetLastError() (0 on success).
extern "C" int rotated_iou_rect(const float* gt, const float* anchors,
                                float* out, int B, int K, int N,
                                cudaStream_t s) {
  const dim3 block(kBlockN, kBlockK);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (K + kBlockK - 1) / kBlockK, B);
  rotated_iou_rect_kernel<<<grid, block, 0, s>>>(gt, anchors, out, K, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rotated_iou_generic(const float* gt, const float* anchors,
                                   float* out, int B, int K, int N,
                                   cudaStream_t s) {
  const dim3 block(kBlockN, kBlockK);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (K + kBlockK - 1) / kBlockK, B);
  rotated_iou_generic_kernel<<<grid, block, 0, s>>>(gt, anchors, out, K, N);
  return static_cast<int>(cudaGetLastError());
}
