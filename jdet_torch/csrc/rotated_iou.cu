// Rotated IoU of K gts against N anchors, for a batch of B images, as
// three entry points: the rect matrix kernel (rotated_iou_rect), the max-IoU
// assigner fused onto the same IoU (max_iou_assign_rect) and, further down,
// the generic matrix kernel (rotated_iou_generic).
//
// The rect IoU replaces jdet_tpu/ops/pallas_iou.py::_iou_kernel_rect (the
// Pallas body behind the anchor assigner's IoU matrix). Same math, per
// pair: each box's edges are clipped against the other box's axis-aligned
// slab in that box's own frame (Liang-Barsky on a rectangle), the Green's-
// theorem cross terms of both directions are summed, shared (collinear)
// edges weigh 1/2, and the closed-loop origin correction
// cross(g_c - a_c, D1) joins the two frames. Corners are kept relative to
// each box's center (fp32 stays precise at image coordinates ~1e3).
// Forward only.
//
// Operands: boxes as (cx, cy, w, h, theta), float32, contiguous.
//   gt      (B, K, 5): a block's gts are expanded once into shared memory.
//   anchors (N, 5) shared by the B images, or (B, N, 5) one set per image
//           (the batch stride is 0 or N*5), in both the matrix kernel and
//           the fused assigner; neighbouring threads read neighbouring
//           anchors. S2ANet's ODM assigns on per-image refined anchors.
// Each box is expanded to the first 15 values of the plain version's rows
// (jdet_torch/ops/rotated_iou_kernel.py::_rect_rows): relx0-3, rely0-3,
// cx, cy, w/2, h/2, cos, sin, area. Every kernel here runs one copy of the
// expansion (expand_rect_row) and of the pair IoU (pair_iou, whose clip
// math touching_iou is not inlined), so the fused assigner's IoUs are the
// bits the matrix kernel writes, and its "IoU == the gt's max" test agrees
// with the plain PyTorch assigner run on the matrix.
//
// rotated_iou_rect: out (B, K, N) float32, one thread per pair. What
// bounds it on an H100: the B*K*N*4-byte output write (at the NMS's
// (30, 512, 512), 31 MB: 9 us at 3.35 TB/s), plus about 300 flops for each
// pair whose boxes can touch. Most pairs cannot, so each pair first tests
// the circle bound |c_a - c_g| < (w_g+h_g)/2 + (w_a+h_a)/2 and writes 0
// without the clip math when it fails (the TPU kernel's per-tile test gave
// the same zeros). Padding gts parked at FAR_CENTER fail it too.
//
// max_iou_assign_rect: the assigner of jdet_tpu/models/boxes/assigner.py
// (assign_wrt_overlaps :45 on the IoU of max_iou_assign_rotated :135), with
// the (B, K, N) matrix never written; with (B, N, 5) anchors it is the
// reference's per-image branch, the assigner vmapped over images and
// anchors (anchor_target.py:163-176). Outputs per (image, anchor): gt_inds
// int64 (-1 ignore, 0 negative, k+1 positive), max_overlaps float32 (-inf
// for a masked anchor, 0 in an image with no real gt) and labels int64.
// What bounds it: the bytes are the boxes in and 20 bytes out per (image,
// anchor) (at the train step's (4, 512, 196416), 20 MB: 6 us), and the
// operations are ~300 flops per touching pair of a real gt and an anchor
// (~3e6 pairs there: 1e9 flops, 15 us at 67 TFLOP/s fp32). Two passes,
// one thread per anchor, blocks of kAssignThreads anchors of one image:
//   pass 1: the block stages its image's real gts, kAssignThreads at a
//     time, in shared memory and keeps those whose circle can reach the
//     bounding box of the block's anchor circles (a conservative cull:
//     every gt it drops fails each pair's circle test, so its IoU is the 0
//     that pair_iou gives). Each thread takes its anchor's max IoU and the
//     first gt index reaching it; a real gt that is culled or does not
//     touch has IoU 0, so the max starts at 0 with the first real gt. The
//     gts' maxima over anchors (gt_max) come from warp reductions and an
//     atomicMax on the float's bits into a (B, K) int32 scratch that the
//     wrapper zeroes: IoU >= 0, so the bit order is the value order, and a
//     max does not depend on the order of the atomics.
//   pass 2: each eligible gt (real, gt_max >= min_pos_iou, some anchor
//     unmasked) claims the anchors whose IoU equals its gt_max; the largest
//     claiming gt index wins. For gt_max > 0 only touching pairs can be
//     equal, so pass 2 recomputes those of the block's culled list. A gt
//     with gt_max == 0 has IoU 0 against every anchor and so claims every
//     unmasked one (the reference's and mmdet's behaviour, e.g. for a gt
//     outside all anchors): per image, k0 = the largest such k, and an
//     anchor's claim is max(k0, its pass-2 claim).
//   Without the low-quality match (match_low_quality = 0, the Oriented
//   R-CNN RoI head's assigner) pass 1 keeps no gt maxima and pass 2 makes
//   no claim: it only writes the labels and sends masked anchors to -1.
//   The first-claim branch (gt_max_assign_all = 0, the reference's
//   assigner.py:101-112): each eligible gt claims only the lowest-index
//   anchor whose IoU equals its gt_max (a gt with gt_max == 0: the
//   image's first unmasked anchor, as the argmax over a row whose masked
//   entries are -inf finds it), and among the gts claiming one anchor the
//   largest index wins. Pass 1 also keeps each image's first unmasked
//   anchor; pass 2 keeps, per (image, gt), the least anchor index reaching
//   gt_max (an atomicMax of N - n, so that the zeroed scratch means "no
//   claim") and makes no claim itself; pass 3, one block per image, writes
//   each gt's claim unless a later gt of the image claims the same anchor
//   (a scan of the later gts' claims: K^2 / 2 reads of a (K,) row, ~0.13 M
//   at K = 512, against pass 2's ~3 M touching pairs). What bounds the
//   branch is what bounds the assigner: the hits it adds are a few per gt.
// The anchor mask is (N,), one for every image (batch stride 0), or
// (B, N), one per image (stride N, with per-image anchors: the RoI head's
// proposals, each image's gts prepended). "Some anchor of the image is
// unmasked" is kept per image, so an image whose anchors are all masked
// changes no other image.
//
// Built without --use_fast_math: the parallel and collinear tolerances
// (1e-5 * scale + 1e-12 here, 1e-6 / 1e-5 * qn * |.| + 1e-12 in the generic
// kernel) compare against IEEE division and products.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 15;     // floats per expanded gt
constexpr int kBlockN = 128;  // anchors per block (threadIdx.x)
constexpr int kBlockK = 4;    // gts per block (threadIdx.y)
constexpr int kAssignThreads = 128;  // anchors per block, gts per chunk
constexpr int kAssignWarps = kAssignThreads / 32;
constexpr float kParEps = 1e-12f;
constexpr unsigned kFullMask = 0xffffffffu;

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

// A (cx, cy, w, h, theta) gt expanded to its 15 rect rows:
// relx0-3, rely0-3, cx, cy, w/2, h/2, cos, sin, area.
__device__ __noinline__ void expand_rect_row(const float* box, float* row) {
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

// The circle pre-test: can the gt (expanded row g) and the anchor touch?
// w2 + h2 >= half-diagonal, so rsum bounds the max overlap distance.
// Rounded op by op (no contraction into FMAs), so every caller takes the
// same branch.
__device__ __forceinline__ bool circle_touch(const float* g, float acx,
                                             float acy, float aw, float ah) {
  const float dx = __fsub_rn(acx, g[8]);
  const float dy = __fsub_rn(acy, g[9]);
  const float rsum = __fadd_rn(__fadd_rn(g[10], g[11]),
                               __fadd_rn(__fmul_rn(aw, 0.5f),
                                         __fmul_rn(ah, 0.5f)));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <
         __fmul_rn(rsum, rsum);
}

// IoU of a gt row and an anchor (cx, cy, w, h, theta) that pass
// circle_touch.
__device__ __noinline__ float touching_iou(const float* g, float acx,
                                           float acy, float aw, float ah,
                                           float at) {
  const float gcx = g[8], gcy = g[9], gw2 = g[10], gh2 = g[11];
  const float gcos = g[12], gsin = g[13], g_area = g[14];
  const float aw2 = aw * 0.5f, ah2 = ah * 0.5f;
  const float dx_c = acx - gcx;
  const float dy_c = acy - gcy;
  float acos_, asin_;
  sincosf(at, &asin_, &acos_);
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
  return uni > 1e-9f ? inter / fmaxf(uni, 1e-9f) : 0.f;
}

// The pair IoU of every kernel here: 0 unless the circles touch.
__device__ __forceinline__ float pair_iou(const float* g, float acx,
                                          float acy, float aw, float ah,
                                          float at) {
  return circle_touch(g, acx, acy, aw, ah)
             ? touching_iou(g, acx, acy, aw, ah, at)
             : 0.f;
}

__global__ void __launch_bounds__(kBlockN* kBlockK)
    rotated_iou_rect_kernel(const float* __restrict__ gt,
                            const float* __restrict__ an,
                            float* __restrict__ out, int K, int N,
                            long long an_batch_stride) {
  __shared__ float sg[kBlockK][kRows];
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.y * kBlockN + threadIdx.x;
  if (tid < kBlockK && k0 + tid < K) {
    expand_rect_row(gt + (static_cast<size_t>(b) * K + k0 + tid) * 5, sg[tid]);
  }
  __syncthreads();

  const int n = blockIdx.x * kBlockN + threadIdx.x;
  const int k = k0 + threadIdx.y;
  if (n >= N || k >= K) return;
  const float* a = an + b * an_batch_stride + static_cast<size_t>(n) * 5;
  out[(static_cast<size_t>(b) * K + k) * N + n] =
      pair_iou(sg[threadIdx.y], a[0], a[1], a[2], a[3], a[4]);
}

// ---------------------------------------------------------------------------
// The fused assigner's two passes.

struct Anchor {
  bool active;  // in range and unmasked
  float cx, cy, w, h, t;
};

__device__ __forceinline__ Anchor load_anchor(const float* __restrict__ an,
                                              const unsigned char* an_mask,
                                              int n, int N) {
  Anchor a{false, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (n < N && (an_mask == nullptr || an_mask[n])) {
    const float* p = an + static_cast<size_t>(n) * 5;
    a = Anchor{true, p[0], p[1], p[2], p[3], p[4]};
  }
  return a;
}

// The bounding box of the block's active anchors' circles (center +-
// (w/2 + h/2)) into box[0..3] = xlo, xhi, ylo, yhi, and the largest |bound|
// into box[4]. Every thread calls it; returns whether any anchor of the
// block is active.
__device__ bool block_anchor_bounds(const Anchor& a, float* box,
                                    float (*red)[kAssignWarps]) {
  const float ra = a.w * 0.5f + a.h * 0.5f;
  // all four as minima: -xhi and -yhi
  float v[4] = {a.active ? a.cx - ra : INFINITY,
                a.active ? -(a.cx + ra) : INFINITY,
                a.active ? a.cy - ra : INFINITY,
                a.active ? -(a.cy + ra) : INFINITY};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[i] = fminf(v[i], __shfl_xor_sync(kFullMask, v[i], off));
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red[i][threadIdx.x >> 5] = v[i];
  }
  const bool any = __syncthreads_or(a.active);
  if (threadIdx.x == 0) {
    float m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = red[i][0];
      for (int w = 1; w < kAssignWarps; ++w) m[i] = fminf(m[i], red[i][w]);
    }
    box[0] = m[0];
    box[1] = -m[1];
    box[2] = m[2];
    box[3] = -m[3];
    box[4] = fmaxf(fmaxf(fabsf(m[0]), fabsf(m[1])),
                   fmaxf(fabsf(m[2]), fabsf(m[3])));
  }
  __syncthreads();
  return any;
}

// Can the gt (expanded row g) touch any anchor of the block whose circles'
// bounding box is `box`? Conservative: a pair passes circle_touch only if
// |dx| and |dy| are below rsum, and the slack of 1e-3 of the magnitudes
// involved covers the rounding of both tests many times over.
__device__ __forceinline__ bool may_touch_block(const float* g,
                                                const float* box) {
  const float rg = g[10] + g[11];
  const float tol =
      1e-3f * (1.f + fabsf(g[8]) + fabsf(g[9]) + rg + box[4]);
  return g[8] + rg > box[0] - tol && g[8] - rg < box[1] + tol &&
         g[9] + rg > box[2] - tol && g[9] - rg < box[3] + tol;
}

__global__ void __launch_bounds__(kAssignThreads)
    assign_pass1_kernel(const float* __restrict__ gt,
                        const unsigned char* __restrict__ gt_mask,
                        const float* __restrict__ an,
                        const unsigned char* an_mask,
                        unsigned* __restrict__ gt_max_bits,
                        int* __restrict__ any_anchor,
                        long long* __restrict__ gt_inds,
                        float* __restrict__ max_overlaps,
                        unsigned* __restrict__ first_active, int K, int N,
                        long long an_batch_stride, long long mask_batch_stride,
                        float pos_thr, float neg_thr, bool low_quality) {
  __shared__ float sg[kAssignThreads][kRows];
  __shared__ int slist[kAssignThreads];
  __shared__ unsigned smax[kAssignThreads];
  __shared__ float sbox[5];
  __shared__ float sred[4][kAssignWarps];
  __shared__ int scount, sfirst;

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int n = blockIdx.x * kAssignThreads + t;
  const Anchor a = load_anchor(an + b * an_batch_stride,
                               an_mask ? an_mask + b * mask_batch_stride : nullptr,
                               n, N);
  if (t == 0) sfirst = K;
  const bool any_active = block_anchor_bounds(a, sbox, sred);
  if (t == 0 && any_active) any_anchor[b] = 1;
  if (first_active != nullptr) {
    // the first-claim branch: the image's first unmasked anchor, as N - n
    const unsigned first = __reduce_max_sync(
        kFullMask, a.active ? static_cast<unsigned>(N - n) : 0u);
    if ((t & 31) == 0 && first) atomicMax(&first_active[b], first);
  }

  // the anchor's max IoU over the touching gts, ties to the smallest k
  float best = 0.f;
  int arg = K;
  for (int c0 = 0; c0 < K; c0 += kAssignThreads) {
    if (t == 0) scount = 0;
    smax[t] = 0u;
    __syncthreads();
    const int k = c0 + t;
    if (k < K && gt_mask[static_cast<size_t>(b) * K + k]) {
      atomicMin(&sfirst, k);
      if (any_active) {
        expand_rect_row(gt + (static_cast<size_t>(b) * K + k) * 5, sg[t]);
        if (may_touch_block(sg[t], sbox)) slist[atomicAdd(&scount, 1)] = t;
      }
    }
    __syncthreads();
    const int cnt = scount;
    for (int j = 0; j < cnt; ++j) {
      const int s = slist[j];
      const float iou =
          a.active ? pair_iou(sg[s], a.cx, a.cy, a.w, a.h, a.t) : 0.f;
      if (iou > best || (iou == best && c0 + s < arg)) {
        best = iou;
        arg = c0 + s;
      }
      if (low_quality) {
        const unsigned v =
            __reduce_max_sync(kFullMask, __float_as_uint(fabsf(iou)));
        if ((t & 31) == 0 && v) atomicMax(&smax[s], v);
      }
    }
    __syncthreads();
    if (smax[t]) atomicMax(&gt_max_bits[static_cast<size_t>(b) * K + k], smax[t]);
  }
  __syncthreads();

  if (n >= N) return;
  const bool any_gt = sfirst < K;
  // every real gt has IoU 0 here unless one is larger: argmax is the first
  if (!(best > 0.f)) arg = sfirst;
  const float mo = !any_gt ? 0.f : (a.active ? best : -INFINITY);
  long long assigned = (mo >= 0.f && mo < neg_thr) ? 0 : -1;
  // an all -inf column's argmax is 0
  if (mo >= pos_thr) assigned = (any_gt && a.active ? arg : 0) + 1;
  const size_t o = static_cast<size_t>(b) * N + n;
  max_overlaps[o] = mo;
  gt_inds[o] = assigned;
}

__global__ void __launch_bounds__(kAssignThreads)
    assign_pass2_kernel(const float* __restrict__ gt,
                        const unsigned char* __restrict__ gt_mask,
                        const long long* __restrict__ gt_labels,
                        const float* __restrict__ an,
                        const unsigned char* an_mask,
                        const unsigned* __restrict__ gt_max_bits,
                        const int* __restrict__ any_anchor,
                        long long* __restrict__ gt_inds,
                        long long* __restrict__ labels,
                        const unsigned* __restrict__ first_active,
                        unsigned* __restrict__ first_claim, int K, int N,
                        long long an_batch_stride, long long mask_batch_stride,
                        float min_pos, bool low_quality) {
  __shared__ float sg[kAssignThreads][kRows];
  __shared__ int slist[kAssignThreads];
  __shared__ float sgm[kAssignThreads];
  __shared__ float sbox[5];
  __shared__ float sred[4][kAssignWarps];
  __shared__ int scount, sk0;

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int n = blockIdx.x * kAssignThreads + t;
  const Anchor a = load_anchor(an + b * an_batch_stride,
                               an_mask ? an_mask + b * mask_batch_stride : nullptr,
                               n, N);
  if (t == 0) sk0 = -1;
  const bool any_active = block_anchor_bounds(a, sbox, sred);
  // with every anchor of the image masked, each gt_max is -inf: no gt is
  // eligible
  const bool anchors_seen = any_anchor[b] != 0;

  int claim = -1;
  for (int c0 = 0; low_quality && c0 < K; c0 += kAssignThreads) {
    if (t == 0) scount = 0;
    __syncthreads();
    const int k = c0 + t;
    if (anchors_seen && k < K && gt_mask[static_cast<size_t>(b) * K + k]) {
      const float gm =
          __uint_as_float(gt_max_bits[static_cast<size_t>(b) * K + k]);
      if (gm >= min_pos) {
        if (gm == 0.f && first_claim != nullptr) {
          // IoU 0 everywhere: the first unmasked anchor reaches gt_max
          first_claim[static_cast<size_t>(b) * K + k] = first_active[b];
        } else if (gm == 0.f) {
          atomicMax(&sk0, k);
        } else if (any_active) {
          expand_rect_row(gt + (static_cast<size_t>(b) * K + k) * 5, sg[t]);
          if (may_touch_block(sg[t], sbox)) {
            sgm[t] = gm;
            slist[atomicAdd(&scount, 1)] = t;
          }
        }
      }
    }
    __syncthreads();
    const int cnt = scount;
    if (a.active) {
      for (int j = 0; j < cnt; ++j) {
        const int s = slist[j];
        if (pair_iou(sg[s], a.cx, a.cy, a.w, a.h, a.t) == sgm[s]) {
          if (first_claim != nullptr) {
            atomicMax(&first_claim[static_cast<size_t>(b) * K + c0 + s],
                      static_cast<unsigned>(N - n));
          } else {
            claim = max(claim, c0 + s);
          }
        }
      }
    }
    __syncthreads();
  }

  if (n >= N) return;
  const size_t o = static_cast<size_t>(b) * N + n;
  long long assigned = gt_inds[o];
  claim = max(claim, sk0);
  if (claim >= 0) assigned = claim + 1;
  if (!a.active) assigned = -1;
  gt_inds[o] = assigned;
  labels[o] = assigned > 0
                  ? gt_labels[static_cast<size_t>(b) * K + assigned - 1]
                  : 0;
}

// The first-claim branch's scatter, one block per image: gt k's claim
// (anchor N - first_claim[k], if any) is written unless a later gt of the
// image claims the same anchor, so the largest claiming gt index wins.
__global__ void __launch_bounds__(kAssignThreads)
    assign_pass3_kernel(const long long* __restrict__ gt_labels,
                        const unsigned* __restrict__ first_claim,
                        long long* __restrict__ gt_inds,
                        long long* __restrict__ labels, int K, int N) {
  const int b = blockIdx.x;
  const unsigned* fc = first_claim + static_cast<size_t>(b) * K;
  for (int k = threadIdx.x; k < K; k += kAssignThreads) {
    const unsigned enc = fc[k];
    if (enc == 0u) continue;
    bool later = false;
    for (int j = k + 1; j < K && !later; ++j) later = fc[j] == enc;
    if (later) continue;
    const size_t o = static_cast<size_t>(b) * N + (N - static_cast<int>(enc));
    gt_inds[o] = k + 1;
    labels[o] = gt_labels[static_cast<size_t>(b) * K + k];
  }
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
// directions are summed; edges collinear with a clip line weigh 1/2. The
// plain version (rotated_iou_kernel.py::box_iou_rotated_generic_reference)
// is that arithmetic for every pair, as the Pallas body is.
//
// What bounds it on an H100: at the main path's (2, 32, 196416) and at the
// config's gt budget (2, 512, 196416), the B*K*N*4-byte output write (50 MB
// and 804 MB: 15 us and 0.24 ms at 3.35 TB/s). The clip costs ~700 flops
// and up to 32 IEEE divisions per pair, but only ~7% of those pairs need it
// (below); their flops alone take 0.01 and 0.14 ms at 67 TFLOP/s fp32.
// Counted in instructions rather than flops, the clip (32 line tests, each
// with its compares and division) takes several times that, and it is what
// keeps the kernel above the bytes bound (PERF.md has the times).
//
// Design: one thread per anchor of one image, blocks of kGenThreads
// neighbouring anchors and kGenChunk gts (grid: anchor blocks x gt chunks x
// images). A thread expands its anchor once (sincosf, the center-relative
// corners, area, radius w/2 + h/2, shorter side); the block stages its gts
// in shared memory, each expanded once alike, and its anchors too. The
// thread walks the staged gts, writes 0 to out[b, k, n] for each pair that
// takes the early-out (neighbouring threads hold neighbouring n, so each
// gt's row is written 128 B per warp) and queues the others in shared
// memory. Then the block's threads take the queued pairs one each, so that
// a warp runs the clip with all its lanes busy, not with the few of its
// anchors that touch one gt. A division of the clip is taken only on the
// branch that uses it (!par). The chunk is small (16 gts) because a block
// runs its queue alone: at (2, 32, 196416) a block of the coarsest level's
// anchors with all 32 gts queues up to 3,600 pairs, 29 rounds of its 128
// threads, and such blocks set the kernel's tail.
//
// The early-out, and why it keeps every value. A pair writes 0 without the
// clip when (1) its circles do not touch, |d|^2 >= (r_g + r_a)^2 with
// r = w/2 + h/2, rounded op by op as circle_touch, and (2) neither box is
// degenerate at the pair's scale: min(w, h) > 1e-3 * S for both boxes, with
// S = 1 + |dx| + |dy| + r_g + r_a (the same rounding in
// rotated_iou_kernel.py::generic_early_out_pairs). Why the clip would give
// exactly 0 there:
//   - A box lies in its disk of radius sqrt(w^2 + h^2)/2, and
//     r - sqrt(w^2 + h^2)/2 >= (1 - sqrt(2)/2) * min(w, h). So with (1) the
//     two boxes are at least G = 0.29 * (min_g + min_a) > 5.8e-4 * S apart.
//   - The clip keeps a part of an edge only if some point of it violates
//     each of the other box's half-planes by at most delta: the collinear
//     slack 1e-5 * qn * (|rx| + |ry|) is at most 2e-5 * S of distance, the
//     parallel slack 1e-6 * qn * dn at most 4e-6 * S, the 1e-12 term at
//     most 1e-12 / min(w, h) < 1e-9 (S >= 1), and fp32 rounding of corners,
//     f0, df and t* a few 1e-7 * S. A point within delta of each half-plane
//     of a rectangle is within sqrt(2) * delta < 4e-5 * S of it, far below G.
//     So every edge of both directions is dropped, the Green sum is exactly
//     0.f, and so is inter / union.
//   - (2) is what makes the slacks small next to G. Without it the clip is
//     not 0 far away: a zero-size box has qn = 0 on every edge, so every
//     edge of the other box counts as collinear, is kept at weight 1/2, and
//     the IoU is ~1 against every anchor, as in the Pallas body (a needle,
//     1e-4 x 50, gives ~4e-6). A test on min_g + min_a alone would send a
//     zero-size gt beside a large anchor to the early-out, so each box is
//     tested. Degenerate, needle and parked (FAR_CENTER, zero-size) boxes
//     always take the full path, whose value is the plain version's.
// The tests check on every pair that generic_early_out_pairs selects that
// the plain version gives exactly 0, on random sets around the circle
// boundary and on jdet_torch/utils/edge_cases.py::degenerate_boxes.
//
// Operands as for the rect kernel: gt (B, K, 5), anchors (N, 5), out
// (B, K, N), float32 (cx, cy, w, h, theta).

constexpr int kGenThreads = 128;  // anchors per block
constexpr int kGenChunk = 16;     // gts per block
constexpr int kGenRows = 13;      // floats per expanded box
constexpr float kDegenerate = 1e-3f;

// A (cx, cy, w, h, theta) box expanded to relx0-3, rely0-3, cx, cy, area,
// r = w/2 + h/2 (rounded as circle_touch rounds it), min(w, h).
__device__ __forceinline__ void expand_generic_row(const float* box,
                                                   float* row) {
  const float w = box[2], h = box[3];
  float sin_t, cos_t;
  sincosf(box[4], &sin_t, &cos_t);
  rel_corners(w, h, cos_t, sin_t, row, row + 4);
  row[8] = box[0];
  row[9] = box[1];
  row[10] = w * h;
  row[11] = __fadd_rn(__fmul_rn(w, 0.5f), __fmul_rn(h, 0.5f));
  row[12] = fminf(w, h);
}

// Does the pair of expanded rows g and a take the early-out (the circles do
// not touch, and neither box is degenerate at the pair's scale)? Rounded op
// by op, as generic_early_out_pairs rounds it.
__device__ __forceinline__ bool generic_early_out(const float* g,
                                                  const float* a) {
  const float dx = __fsub_rn(a[8], g[8]);
  const float dy = __fsub_rn(a[9], g[9]);
  const float rsum = __fadd_rn(g[11], a[11]);
  const bool apart = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) >=
                     __fmul_rn(rsum, rsum);
  const float scale = __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(1.f, fabsf(dx)), fabsf(dy)), g[11]), a[11]);
  const float lim = __fmul_rn(kDegenerate, scale);
  return apart && g[12] > lim && a[12] > lim;
}

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
      if (!par) {
        const float tstar = -f0 / df;
        if (df > 0.f) t_lo = fmaxf(t_lo, tstar);
        if (df < 0.f) t_hi = fminf(t_hi, tstar);
      }
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

// The full quad-quad IoU of the expanded rows g and a.
__device__ __forceinline__ float generic_iou(const float* g, const float* a) {
  // pair midframe: anchor corners +d/2, gt corners -d/2, d = a_c - g_c
  const float hdx = 0.5f * (a[8] - g[8]);
  const float hdy = 0.5f * (a[9] - g[9]);
  float pax[4], pay[4], pgx[4], pgy[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    pax[c] = a[c] + hdx;
    pay[c] = a[4 + c] + hdy;
    pgx[c] = g[c] - hdx;
    pgy[c] = g[4 + c] - hdy;
  }
  const float s = green_sum(pax, pay, pgx, pgy) + green_sum(pgx, pgy, pax, pay);
  const float inter = fmaxf(0.5f * s, 0.f);
  const float uni = g[10] + a[10] - inter;
  return uni > 1e-9f ? inter / fmaxf(uni, 1e-9f) : 0.f;
}

__global__ void __launch_bounds__(kGenThreads)
    rotated_iou_generic_kernel(const float* __restrict__ gt,
                               const float* __restrict__ an,
                               float* __restrict__ out, int K, int N) {
  __shared__ float sg[kGenChunk][kGenRows];
  __shared__ float sa[kGenThreads][kGenRows];
  // the block's pairs that do the clip, as j * kGenThreads + t
  __shared__ unsigned short sq[kGenChunk * kGenThreads];
  __shared__ int scount;
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kGenChunk;
  const int kc = min(kGenChunk, K - k0);
  const int t = threadIdx.x;
  // the last anchors (the coarsest level's, on the main path) touch the
  // most gts: their blocks go first, so that they do not finish last
  const int n0 = (gridDim.x - 1 - blockIdx.x) * kGenThreads;
  const int n = n0 + t;
  if (t == 0) scount = 0;
  if (t < kc) {
    expand_generic_row(gt + (static_cast<size_t>(b) * K + k0 + t) * 5, sg[t]);
  }
  float a[kGenRows];
  if (n < N) {
    expand_generic_row(an + static_cast<size_t>(n) * 5, a);
#pragma unroll
    for (int c = 0; c < kGenRows; ++c) sa[t][c] = a[c];
  }
  __syncthreads();

  float* o = out + (static_cast<size_t>(b) * K + k0) * N;
  if (n < N) {
    for (int j = 0; j < kc; ++j) {
      if (generic_early_out(sg[j], a)) {
        o[static_cast<size_t>(j) * N + n] = 0.f;
      } else {
        sq[atomicAdd(&scount, 1)] =
            static_cast<unsigned short>(j * kGenThreads + t);
      }
    }
  }
  __syncthreads();
  // the clip, one queued pair per thread: every lane of a warp has work
  const int cnt = scount;
  for (int i = t; i < cnt; i += kGenThreads) {
    const int j = sq[i] / kGenThreads, u = sq[i] % kGenThreads;
    o[static_cast<size_t>(j) * N + n0 + u] = generic_iou(sg[j], sa[u]);
  }
}

}  // namespace

// Each launches on stream s and returns cudaGetLastError() (0 on success).
// an_batch_stride: 0 for anchors shared by the batch, N * 5 for (B, N, 5).
extern "C" int rotated_iou_rect(const float* gt, const float* anchors,
                                float* out, int B, int K, int N,
                                long long an_batch_stride, cudaStream_t s) {
  const dim3 block(kBlockN, kBlockK);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (K + kBlockK - 1) / kBlockK, B);
  rotated_iou_rect_kernel<<<grid, block, 0, s>>>(gt, anchors, out, K, N,
                                                 an_batch_stride);
  return static_cast<int>(cudaGetLastError());
}

// Both passes of the fused assigner. anchors (N, 5) or (B, N, 5), by
// an_batch_stride as above. gt_mask (B, K) and anchor_mask (N,), one mask
// for every image (mask_batch_stride 0), or (B, N), one per image (stride
// N), are bools as bytes (anchor_mask may be null: every anchor
// unmasked); gt_labels (B, K) int64; scratch int32, zeroed by the caller:
// the gts' max IoU bits (B * K), then per image a flag "some anchor is
// unmasked" (B), and, for the first-claim branch (gt_max_assign_all 0,
// with match_low_quality), each gt's claimed anchor as N - n (B * K) and
// each image's first unmasked anchor as N - n (B). match_low_quality 0
// skips the gts' maxima and the claims.
extern "C" int max_iou_assign_rect(
    const float* gt, const unsigned char* gt_mask, const long long* gt_labels,
    const float* anchors, const unsigned char* anchor_mask, int* scratch,
    long long* gt_inds, float* max_overlaps, long long* labels, int B, int K,
    int N, long long an_batch_stride, long long mask_batch_stride,
    float pos_iou_thr, float neg_iou_thr, float min_pos_iou,
    int match_low_quality, int gt_max_assign_all, cudaStream_t s) {
  const dim3 grid((N + kAssignThreads - 1) / kAssignThreads, B);
  unsigned* gt_max_bits = reinterpret_cast<unsigned*>(scratch);
  int* any_anchor = scratch + static_cast<size_t>(B) * K;
  const bool low_quality = match_low_quality != 0;
  const bool first = low_quality && gt_max_assign_all == 0;
  unsigned* first_claim =
      first ? reinterpret_cast<unsigned*>(any_anchor + B) : nullptr;
  unsigned* first_active =
      first ? first_claim + static_cast<size_t>(B) * K : nullptr;
  assign_pass1_kernel<<<grid, kAssignThreads, 0, s>>>(
      gt, gt_mask, anchors, anchor_mask, gt_max_bits, any_anchor, gt_inds,
      max_overlaps, first_active, K, N, an_batch_stride, mask_batch_stride,
      pos_iou_thr, neg_iou_thr, low_quality);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  assign_pass2_kernel<<<grid, kAssignThreads, 0, s>>>(
      gt, gt_mask, gt_labels, anchors, anchor_mask, gt_max_bits, any_anchor,
      gt_inds, labels, first_active, first_claim, K, N, an_batch_stride,
      mask_batch_stride, min_pos_iou, low_quality);
  e = cudaGetLastError();
  if (e != cudaSuccess || !first) return static_cast<int>(e);
  assign_pass3_kernel<<<B, kAssignThreads, 0, s>>>(gt_labels, first_claim,
                                                   gt_inds, labels, K, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rotated_iou_generic(const float* gt, const float* anchors,
                                   float* out, int B, int K, int N,
                                   cudaStream_t s) {
  const dim3 grid((N + kGenThreads - 1) / kGenThreads,
                  (K + kGenChunk - 1) / kGenChunk, B);
  rotated_iou_generic_kernel<<<grid, kGenThreads, 0, s>>>(gt, anchors, out, K,
                                                          N);
  return static_cast<int>(cudaGetLastError());
}
