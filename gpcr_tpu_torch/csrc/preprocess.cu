// One view's preprocess of every splat in one launch: the near cull, the
// projection to pixels, the 3D covariance from scale and rotation, its EWA
// projection to 2D with the +0.3 low-pass, the conic, the 3-sigma radius
// (and with opacity_radius the opacity-aware tight one), the tile rect, the
// validity flags, and the renderer's fused feature row
// [SH rgb | xyz | ones | camera-facing normal] (C = 9, or 12 with normals).
//
// Replaces no TPU kernel: the JAX package preprocesses with XLA
// (gpcr_tpu/ops/rasterize.py::preprocess). The port's plain version is
// ops/preprocess.py::fuse_view_features followed by
// ops/rasterize.py::preprocess: about 370 elementwise, stack and cat
// launches per view, issued from Python, which left the card idle behind
// the host and moved each field through device memory a dozen times.
//
// What bounds it on Hopper: bytes. Per splat it reads ~105 B (means 12,
// scales 12, rotation 16, opacity 4, the SH rows the degree needs, 48 at
// degree 1, normal 12, valid 1) and writes ~93 B (C = 12); its ~300 float
// operations, eight IEEE divisions and four square roots are far below the
// card's rate. So the design moves each byte once:
// - one thread per splat computes every field in registers; the 3D
//   covariance is recomputed from scale and rotation for each view (as many
//   bytes as storing it, and no state between launches);
// - inputs are read through their strides, so the analytic path's expanded
//   rotation (stride 0) and the degree-1 rows of its (n, 13, 3) SH are read
//   in place, with no per-view copy;
// - the (n, C) feature rows and (n, 3) conics, whose rows are no multiple of
//   16 bytes at C = 9 or 3, are staged per CTA in shared memory and stored
//   in 16-byte words, as bin_stream.cu's rows kernel does; the rects go out
//   as one 16-byte word a splat, the 2D means as 8;
// - the view's two matrices and camera centre are read from the device (no
//   host read) into shared memory once per CTA.
//
// Numerics: every field equals the plain version's bits on the card. The
// build's -fmad=false keeps each product and sum rounded on its own, as
// PyTorch's one-op kernels round them, and the expressions keep the plain
// code's order: the quaternion unnormalised, true divisions by the focal
// lengths and by tz, ``1 / x`` as PyTorch's reciprocal, a division by the
// tile size as PyTorch's multiply by the CPU scalar's reciprocal, the
// ±1.3·tanfov clamp, ceil(3 sqrt(lmax)), the log of the tight radius,
// trunc before the rect's clamps, NaN-propagating clamps and max / min as
// ATen's, and Python's double constants rounded to float. Two sums over
// the three components of a vector are ATen CUDA reductions
// (torch.linalg.norm of the view direction, torch.sum of its product with
// the normal): their reduction gives each row two lanes, lane 0 summing
// elements 0 and 2 and lane 1 element 1, so both are (e0 + e2) + e1 here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the widest staged row: the feature row with normals
constexpr int kMaxChannels = 12;
// element strides: means (2), scales (2), rotations (2), opacity, SH (3:
// splat, coefficient, channel), normal (2), valid mask, view matrix (2),
// projection matrix (2), camera centre
constexpr int kStrides = 18;

struct Sources {
  const float* means;
  const float* scales;
  const float* rots;
  const float* opacity;
  const float* shs;
  const float* normal;  // null without normals
  const unsigned char* valid_mask;  // null: every splat
  const float* view;
  const float* proj;
  const float* campos;
  long long s[kStrides];
};

struct ViewParams {
  int n, width, height, grid_x, grid_y, tile_x, tile_y, with_normal,
      opacity_radius;
  float focal_x, focal_y, lim_x, lim_y, scale_modifier;
};

struct Outputs {
  unsigned char* valid;
  float* depth;
  float* mean2d;
  float* conic;
  float* radius;
  int* rect;
  float* feat;
};

// ATen's clamp, clamp_min, clamp_max, maximum and minimum on float: a NaN
// operand comes out as it went in
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// get_rect's bound: clamp(trunc(e / tile), 0, grid) as int32, the division
// by the CPU scalar as ATen does it (times its reciprocal)
__device__ __forceinline__ int tile_bound(float e, float inv_tile, int grid) {
  return (int)clamp_to(truncf(e * inv_tile), 0.0f, (float)grid);
}

// utils/sh.py::eval_sh of one channel (coefficient k at c[k * step]) at the
// unit direction (x, y, z), term by term in its order
template <int DEG>
__device__ __forceinline__ float eval_sh(const float* c, long long step,
                                         float x, float y, float z) {
  // Python's double constants of utils/sh.py, rounded to float as PyTorch
  // rounds a scalar operand
  constexpr float kC0 = (float)0.28209479177387814;
  constexpr float kC1 = (float)0.4886025119029199;
  constexpr float kC2[5] = {
      (float)1.0925484305920792, (float)-1.0925484305920792,
      (float)0.31539156525252005, (float)-1.0925484305920792,
      (float)0.5462742152960396};
  constexpr float kC3[7] = {
      (float)-0.5900435899266435, (float)2.890611442640554,
      (float)-0.4570457994644658, (float)0.3731763325901154,
      (float)-0.4570457994644658, (float)1.445305721320277,
      (float)-0.5900435899266435};
  constexpr float kC4[9] = {
      (float)2.5033429417967046, (float)-1.7701307697799304,
      (float)0.9461746957575601, (float)-0.6690465435572892,
      (float)0.10578554691520431, (float)-0.6690465435572892,
      (float)0.47308734787878004, (float)-1.7701307697799304,
      (float)0.6258357354491761};
  float r = kC0 * c[0];
  if (DEG > 0) {
    r = r - kC1 * y * c[step] + kC1 * z * c[2 * step] - kC1 * x * c[3 * step];
    if (DEG > 1) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      r = r + kC2[0] * xy * c[4 * step] + kC2[1] * yz * c[5 * step] +
          kC2[2] * (2.0f * zz - xx - yy) * c[6 * step] +
          kC2[3] * xz * c[7 * step] + kC2[4] * (xx - yy) * c[8 * step];
      if (DEG > 2) {
        r = r + kC3[0] * y * (3.0f * xx - yy) * c[9 * step] +
            kC3[1] * xy * z * c[10 * step] +
            kC3[2] * y * (4.0f * zz - xx - yy) * c[11 * step] +
            kC3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy) * c[12 * step] +
            kC3[4] * x * (4.0f * zz - xx - yy) * c[13 * step] +
            kC3[5] * z * (xx - yy) * c[14 * step] +
            kC3[6] * x * (xx - 3.0f * yy) * c[15 * step];
        if (DEG > 3) {
          r = r + kC4[0] * xy * (xx - yy) * c[16 * step] +
              kC4[1] * yz * (3.0f * xx - yy) * c[17 * step] +
              kC4[2] * xy * (7.0f * zz - 1.0f) * c[18 * step] +
              kC4[3] * yz * (7.0f * zz - 3.0f) * c[19 * step] +
              kC4[4] * (zz * (35.0f * zz - 30.0f) + 3.0f) * c[20 * step] +
              kC4[5] * xz * (7.0f * zz - 3.0f) * c[21 * step] +
              kC4[6] * (xx - yy) * (7.0f * zz - 1.0f) * c[22 * step] +
              kC4[7] * xz * (xx - 3.0f * yy) * c[23 * step] +
              kC4[8] * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy)) *
                  c[24 * step];
        }
      }
    }
  }
  return r;
}

// Rows [row0, row0 + rows) of an (n, width) float32 array from the CTA's
// stage (row t at stage[t * width]): the CTA's first row starts at a
// multiple of 1024 * width bytes, so its block is stored in 16-byte words
// and the last 0-3 floats one by one.
__device__ __forceinline__ void store_rows(float* dst, const float* stage,
                                           int rows, int width) {
  const int floats = rows * width;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  const float4* stage4 = reinterpret_cast<const float4*>(stage);
  for (int q = threadIdx.x; q < floats / 4; q += kThreads) dst4[q] = stage4[q];
  for (int e = floats / 4 * 4 + threadIdx.x; e < floats; e += kThreads)
    dst[e] = stage[e];
}

// Every output field of one splat (feat: the first 9 or 12 channels).
struct Splat {
  bool valid;
  float depth, radius, px, py, conic[3], feat[kMaxChannels];
  int rect[4];
};

// Splat g in one view; V, P: the view and projection matrices, both
// transposed, row-major (V[4 i + j] = viewmatrix[i, j]); cam: the camera
// centre.
template <int DEG>
__device__ __forceinline__ Splat preprocess_splat(long long g,
                                                  const Sources& src,
                                                  const ViewParams& v,
                                                  const float* V,
                                                  const float* P,
                                                  const float* cam) {
  Splat o;
  const long long* s = src.s;
  const float* mp = src.means + g * s[0];
  const float mx = mp[0], my = mp[s[1]], mz = mp[2 * s[1]];

  // splat.in_frustum / transform_point_4x3: [p, 1] @ V[:, :3]
  const float t0 = mx * V[0] + my * V[4] + mz * V[8] + V[12];
  const float t1 = mx * V[1] + my * V[5] + mz * V[9] + V[13];
  const float tz = mx * V[2] + my * V[6] + mz * V[10] + V[14];

  // splat.project_points and ndc2pix: 1 / x is ATen's reciprocal
  const float h0 = mx * P[0] + my * P[4] + mz * P[8] + P[12];
  const float h1 = mx * P[1] + my * P[5] + mz * P[9] + P[13];
  const float h3 = mx * P[3] + my * P[7] + mz * P[11] + P[15];
  const float p_w = 1.0f / (h3 + (float)1e-7);
  const float px = ((h0 * p_w + 1.0f) * (float)v.width - 1.0f) * 0.5f;
  const float py = ((h1 * p_w + 1.0f) * (float)v.height - 1.0f) * 0.5f;

  // splat.compute_cov3d: R (quaternion not normalised) times diag(s)
  const float* qp = src.rots + g * s[4];
  const float qr = qp[0], qx = qp[s[5]], qy = qp[2 * s[5]],
              qz = qp[3 * s[5]];
  const float* sp = src.scales + g * s[2];
  const float s0 = sp[0] * v.scale_modifier;
  const float s1 = sp[s[3]] * v.scale_modifier;
  const float s2 = sp[2 * s[3]] * v.scale_modifier;
  const float m00 = (1.0f - 2.0f * (qy * qy + qz * qz)) * s0;
  const float m01 = (2.0f * (qx * qy - qr * qz)) * s1;
  const float m02 = (2.0f * (qx * qz + qr * qy)) * s2;
  const float m10 = (2.0f * (qx * qy + qr * qz)) * s0;
  const float m11 = (1.0f - 2.0f * (qx * qx + qz * qz)) * s1;
  const float m12 = (2.0f * (qy * qz - qr * qx)) * s2;
  const float m20 = (2.0f * (qx * qz - qr * qy)) * s0;
  const float m21 = (2.0f * (qy * qz + qr * qx)) * s1;
  const float m22 = (1.0f - 2.0f * (qx * qx + qy * qy)) * s2;
  const float xx = m00 * m00 + m01 * m01 + m02 * m02;
  const float xy = m00 * m10 + m01 * m11 + m02 * m12;
  const float xz = m00 * m20 + m01 * m21 + m02 * m22;
  const float yy = m10 * m10 + m11 * m11 + m12 * m12;
  const float yz = m10 * m20 + m11 * m21 + m12 * m22;
  const float zz = m20 * m20 + m21 * m21 + m22 * m22;

  // splat.compute_cov2d: the clamped EWA Jacobian, true divisions
  const float tx = clamp_to(t0 / tz, -v.lim_x, v.lim_x) * tz;
  const float ty = clamp_to(t1 / tz, -v.lim_y, v.lim_y) * tz;
  const float j00 = v.focal_x / tz;
  const float j02 = -(v.focal_x * tx) / (tz * tz);
  const float j11 = v.focal_y / tz;
  const float j12 = -(v.focal_y * ty) / (tz * tz);
  const float a0 = j00 * V[0] + j02 * V[2];
  const float a1 = j00 * V[4] + j02 * V[6];
  const float a2 = j00 * V[8] + j02 * V[10];
  const float b0 = j11 * V[1] + j12 * V[2];
  const float b1 = j11 * V[5] + j12 * V[6];
  const float b2 = j11 * V[9] + j12 * V[10];
  const float va0 = xx * a0 + xy * a1 + xz * a2;
  const float va1 = xy * a0 + yy * a1 + yz * a2;
  const float va2 = xz * a0 + yz * a1 + zz * a2;
  const float vb0 = xx * b0 + xy * b1 + xz * b2;
  const float vb1 = xy * b0 + yy * b1 + yz * b2;
  const float vb2 = xz * b0 + yz * b1 + zz * b2;
  const float c0 = a0 * va0 + a1 * va1 + a2 * va2 + (float)0.3;
  const float c1 = a0 * vb0 + a1 * vb1 + a2 * vb2;
  const float c2 = b0 * vb0 + b1 * vb1 + b2 * vb2 + (float)0.3;

  // splat.conic_and_radius
  const float det = c0 * c2 - c1 * c1;
  const bool det_ok = det != 0.0f;
  const float det_inv = 1.0f / (det_ok ? det : 1.0f);
  o.conic[0] = c2 * det_inv;
  o.conic[1] = -c1 * det_inv;
  o.conic[2] = c0 * det_inv;
  const float mid = 0.5f * (c0 + c2);
  const float disc = sqrtf(clamp_min(mid * mid - det, (float)0.1));
  const float lmax = maximum(mid + disc, mid - disc);
  const float radius = ceilf(3.0f * sqrtf(lmax));
  float r_bin = radius;
  if (v.opacity_radius) {
    const float op = src.opacity[g * s[6]];
    const float thr = 2.0f * logf(255.0f * clamp_min(op, (float)1e-12));
    r_bin = thr > 0.0f
                ? minimum(radius,
                          ceilf(sqrtf(clamp_max(thr, 9.0f) * lmax)) + 1.0f)
                : 0.0f;
  }

  // splat.get_rect of the binning radius; valid, and the reported radius
  const float inv_tx = 1.0f / (float)v.tile_x;
  const float inv_ty = 1.0f / (float)v.tile_y;
  int* rect = o.rect;
  rect[0] = tile_bound(px - r_bin, inv_tx, v.grid_x);
  rect[1] = tile_bound(py - r_bin, inv_ty, v.grid_y);
  rect[2] = tile_bound(px + r_bin + (float)v.tile_x - 1.0f, inv_tx, v.grid_x);
  rect[3] = tile_bound(py + r_bin + (float)v.tile_y - 1.0f, inv_ty, v.grid_y);
  const bool kept = src.valid_mask == nullptr || src.valid_mask[g * s[12]];
  const bool seen = tz > (float)0.2 && det_ok && kept;
  bool valid = seen && (rect[2] - rect[0]) * (rect[3] - rect[1]) > 0;
  bool report = valid;
  if (v.opacity_radius) {
    // r_bin == 0 culls from binning only; the reported radius keeps the
    // 3-sigma rect's test
    valid = valid && r_bin > 0.0f;
    const int x0 = tile_bound(px - radius, inv_tx, v.grid_x);
    const int y0 = tile_bound(py - radius, inv_ty, v.grid_y);
    const int x1 = tile_bound(px + radius + (float)v.tile_x - 1.0f, inv_tx,
                              v.grid_x);
    const int y1 = tile_bound(py + radius + (float)v.tile_y - 1.0f, inv_ty,
                              v.grid_y);
    report = seen && (x1 - x0) * (y1 - y0) > 0;
  }

  // ops/preprocess.py::fuse_view_features: SH colour along the unit view
  // direction, +0.5, clamped at 0; xyz; ones; the normal turned to face
  // the camera
  const float dx = mx - cam[0], dy = my - cam[1], dz = mz - cam[2];
  const float norm = sqrtf((dx * dx + dz * dz) + dy * dy);
  const float ux = dx / norm, uy = dy / norm, uz = dz / norm;
  const float* shp = src.shs + g * s[7];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    o.feat[c] = clamp_min(
        eval_sh<DEG>(shp + c * s[9], s[8], ux, uy, uz) + 0.5f, 0.0f);
  o.feat[3] = mx;
  o.feat[4] = my;
  o.feat[5] = mz;
  o.feat[6] = o.feat[7] = o.feat[8] = 1.0f;
  if (v.with_normal) {
    const float* np = src.normal + g * s[10];
    const float nx = np[0], ny = np[s[11]], nz = np[2 * s[11]];
    const float sgn = ((dx * nx + dz * nz) + dy * ny) > 0.0f ? 1.0f : -1.0f;
    o.feat[9] = nx * -1.0f * sgn;
    o.feat[10] = ny * -1.0f * sgn;
    o.feat[11] = nz * -1.0f * sgn;
  }

  o.valid = valid;
  o.depth = tz;
  o.radius = report ? radius : 0.0f;
  o.px = px;
  o.py = py;
  return o;
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
preprocess_kernel(Sources src, ViewParams v, Outputs out) {
  __shared__ float mat[35];  // view (16), projection (16), camera centre (3)
  __shared__ float4 stage4[kThreads * kMaxChannels / 4];
  float* stage = reinterpret_cast<float*>(stage4);
  const int t = threadIdx.x;
  if (t < 16)
    mat[t] = src.view[(t / 4) * src.s[13] + (t % 4) * src.s[14]];
  else if (t < 32)
    mat[t] = src.proj[((t - 16) / 4) * src.s[15] + (t % 4) * src.s[16]];
  else if (t < 35)
    mat[t] = src.campos[(t - 32) * src.s[17]];
  __syncthreads();
  const long long row0 = (long long)blockIdx.x * kThreads;
  const int rows = (int)min((long long)kThreads, v.n - row0);
  const long long g = row0 + t;
  const int channels = v.with_normal ? 12 : 9;
  Splat o;
  if (t < rows) {
    o = preprocess_splat<DEG>(g, src, v, mat, mat + 16, mat + 32);
    out.valid[g] = o.valid;
    out.depth[g] = o.depth;
    out.radius[g] = o.radius;
    reinterpret_cast<float2*>(out.mean2d)[g] = make_float2(o.px, o.py);
    reinterpret_cast<int4*>(out.rect)[g] =
        make_int4(o.rect[0], o.rect[1], o.rect[2], o.rect[3]);
  }

  // unrolled, so that feat stays in registers
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    if (c < channels) stage[t * channels + c] = o.feat[c];
  __syncthreads();
  store_rows(out.feat + row0 * channels, stage, rows, channels);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c) stage[t * 3 + c] = o.conic[c];
  __syncthreads();
  store_rows(out.conic + row0 * 3, stage, rows, 3);
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a successful launch. Inputs, float32
// read through their element strides (``strides``: kStrides values in
// Sources::s order): means, scales (n, 3), rotations (n, 4) wxyz, opacity
// (n,), shs (n, sh_k, 3), normal (n, 3) or null without normals, valid_mask
// (n,) bool or null, view and projection matrices (4, 4) transposed, the
// camera centre (3,). Outputs, contiguous, 16-byte aligned: valid (n,)
// bool, depth, radius (n,), mean2d (n, 2), conic (n, 3), rect (n, 4) i32,
// feat (n, 9 or 12 with normals).
int gpcr_preprocess(const float* means, const float* scales, const float* rots,
                    const float* opacity, const float* shs,
                    const float* normal, const unsigned char* valid_mask,
                    const float* view, const float* proj, const float* campos,
                    const long long* strides, int n, int sh_k, int sh_degree,
                    int opacity_radius, int width, int height, int tile_x,
                    int tile_y, float focal_x, float focal_y, float lim_x,
                    float lim_y, float scale_modifier, unsigned char* valid,
                    float* depth, float* mean2d, float* conic, float* radius,
                    int* rect, float* feat, void* cuda_stream) {
  if (sh_degree < 0 || sh_degree > 4 ||
      sh_k < (sh_degree + 1) * (sh_degree + 1) || tile_x < 1 || tile_y < 1 ||
      n < 0)
    return (int)cudaErrorInvalidValue;
  const void* staged[4] = {mean2d, conic, rect, feat};
  for (const void* p : staged)
    if ((size_t)p % 16) return (int)cudaErrorMisalignedAddress;
  if (n == 0) return (int)cudaSuccess;
  Sources src{means, scales, rots, opacity, shs, normal, valid_mask,
              view, proj, campos, {}};
  for (int i = 0; i < kStrides; ++i) src.s[i] = strides[i];
  ViewParams v{n, width, height, (width + tile_x - 1) / tile_x,
               (height + tile_y - 1) / tile_y, tile_x, tile_y,
               normal != nullptr, opacity_radius, focal_x, focal_y, lim_x,
               lim_y, scale_modifier};
  Outputs out{valid, depth, mean2d, conic, radius, rect, feat};
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  switch (sh_degree) {
    case 0:
      preprocess_kernel<0><<<blocks, kThreads, 0, st>>>(src, v, out);
      break;
    case 1:
      preprocess_kernel<1><<<blocks, kThreads, 0, st>>>(src, v, out);
      break;
    case 2:
      preprocess_kernel<2><<<blocks, kThreads, 0, st>>>(src, v, out);
      break;
    case 3:
      preprocess_kernel<3><<<blocks, kThreads, 0, st>>>(src, v, out);
      break;
    default:
      preprocess_kernel<4><<<blocks, kThreads, 0, st>>>(src, v, out);
  }
  return (int)cudaGetLastError();
}

const char* gpcr_preprocess_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
