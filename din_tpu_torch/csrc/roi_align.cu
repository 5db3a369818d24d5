// K1: RoIAlign forward (TF crop_and_resize with transform_fpcoor).
//
// Replaces the Pallas TPU kernel din_tpu/ops/roi_align.py
// _roi_align_pallas_kernel (launched by _roi_align_pallas_fwd_impl), which
// built a one-hot interpolation matrix per frame and contracted it on the
// MXU.  On Hopper the natural form is the gather itself: each output row is
// a lerp of four NHWC pixel rows.
//
// Inputs: features [B,H,W,C] (f32 or bf16), boxes [B,N,4] (x1, y1, x2, y2,
// f32) and the output [B,N,KH,KW,C] in the features' dtype.  The block of a
// box computes its sample centres itself, bin = (y2 - y1) / KH and
// y_i = y1 + (i + 0.5) * bin - 0.5 (likewise x), in the order of the plain
// version's _sample_grid (din_tpu_torch/ops/roi_align.py) with each op
// rounded once (__fsub_rn, __fdiv_rn, __fmul_rn, __fadd_rn): nvcc would
// otherwise contract a*b+c into an FMA, and a centre rounded otherwise flips
// the in-range test of a sample that lands exactly on the border (the JAX
// kernel hit exactly this, din_tpu/ops/roi_align.py:199-206).  So the wrapper
// launches this one kernel and no torch op besides the output's allocation.
//
// Per sample: in-range test on [0,H-1]x[0,W-1] (a sample outside is 0 as a
// whole), clamp, floor/ceil corners, four-corner lerp accumulated in f32.
// The lerp rounds each product and sum on its own (__fmul_rn, __fadd_rn) in
// the plain version's order: an FMA would round differently, and where the
// four terms cancel to near 0 that difference is many bf16 ulps of the
// result.  So the kernel equals the plain version bit for bit.
//
// Bound: bytes.  It reads only the sampled pixel rows (at most 4*KH*KW*C
// values per box) and writes the output; at the flagship (20 frames, 12
// boxes, 5x5, C=512, bf16) that is ~1.5 MB each way, so launch latency is
// the real floor.  Design: one block per (frame, box); threads run across C,
// so every corner-row read of the NHWC map is coalesced.
#include "common.cuh"

namespace {

// sample centre i of a box side from lo to hi with k bins, rounded op by op
// as _sample_grid computes it: lo + (i + 0.5) * ((hi - lo) / k) - 0.5
__device__ __forceinline__ float sample_centre(float lo, float hi, int64_t k,
                                               int64_t i) {
  const float bin = __fdiv_rn(__fsub_rn(hi, lo), (float)k);
  const float off = __fmul_rn(__fadd_rn((float)i, 0.5f), bin);
  return __fsub_rn(__fadd_rn(lo, off), 0.5f);
}

template <typename T>
__global__ void roi_align_kernel(const T* __restrict__ feat,
                                 const float* __restrict__ boxes,
                                 T* __restrict__ out, int64_t H, int64_t W,
                                 int64_t C, int64_t N, int64_t KH,
                                 int64_t KW) {
  const int64_t bn = blockIdx.x;  // frame * N + box
  const int64_t b = bn / N;
  const T* fb = feat + b * H * W * C;
  const float bx1 = boxes[bn * 4], by1 = boxes[bn * 4 + 1];
  const float bx2 = boxes[bn * 4 + 2], by2 = boxes[bn * 4 + 3];
  T* ob = out + bn * KH * KW * C;
  const float hmax = (float)(H - 1);
  const float wmax = (float)(W - 1);
  for (int64_t i = 0; i < KH; ++i) {
    const float y = sample_centre(by1, by2, KH, i);
    const bool ok_y = (y >= 0.0f) && (y <= hmax);
    const float yc = fminf(fmaxf(y, 0.0f), hmax);
    const float y0f = floorf(yc);
    const float y1f = ceilf(yc);
    const float wy1 = yc - y0f;
    const float wy0 = 1.0f - wy1;
    for (int64_t j = 0; j < KW; ++j) {
      const float x = sample_centre(bx1, bx2, KW, j);
      const bool ok_x = (x >= 0.0f) && (x <= wmax);
      T* o = ob + (i * KW + j) * C;
      if (!(ok_y && ok_x)) {
        for (int64_t c = threadIdx.x; c < C; c += blockDim.x)
          o[c] = din_from_f32<T>(0.0f);
        continue;
      }
      const float xc = fminf(fmaxf(x, 0.0f), wmax);
      const float x0f = floorf(xc);
      const float x1f = ceilf(xc);
      const float wx1 = xc - x0f;
      const float wx0 = 1.0f - wx1;
      const float w00 = wy0 * wx0, w01 = wy0 * wx1;
      const float w10 = wy1 * wx0, w11 = wy1 * wx1;
      const int64_t y0 = (int64_t)y0f, y1 = (int64_t)y1f;
      const int64_t x0 = (int64_t)x0f, x1 = (int64_t)x1f;
      const T* r00 = fb + (y0 * W + x0) * C;
      const T* r01 = fb + (y0 * W + x1) * C;
      const T* r10 = fb + (y1 * W + x0) * C;
      const T* r11 = fb + (y1 * W + x1) * C;
      for (int64_t c = threadIdx.x; c < C; c += blockDim.x) {
        // rounded op by op in the plain version's order (no FMA), so the
        // kernel equals roi_align_ref bit for bit
        float v = __fmul_rn(din_to_f32(r00[c]), w00);
        v = __fadd_rn(v, __fmul_rn(din_to_f32(r01[c]), w01));
        v = __fadd_rn(v, __fmul_rn(din_to_f32(r10[c]), w10));
        v = __fadd_rn(v, __fmul_rn(din_to_f32(r11[c]), w11));
        o[c] = din_from_f32<T>(v);
      }
    }
  }
}

template <typename T>
void launch(const void* feat, const float* boxes, void* out, int64_t B,
            int64_t H, int64_t W, int64_t C, int64_t N, int64_t KH,
            int64_t KW, cudaStream_t stream) {
  if (B * N == 0 || C == 0) return;
  int threads = (int)((C + 31) / 32 * 32);
  if (threads > 256) threads = 256;
  roi_align_kernel<T><<<(unsigned)(B * N), threads, 0, stream>>>(
      static_cast<const T*>(feat), boxes, static_cast<T*>(out), H, W, C, N,
      KH, KW);
}

}  // namespace

extern "C" int din_roi_align(const void* feat, const void* boxes, void* out,
                             int64_t B, int64_t H, int64_t W, int64_t C,
                             int64_t N, int64_t KH, int64_t KW, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  if (dtype == DIN_F32)
    launch<float>(feat, bx, out, B, H, W, C, N, KH, KW, s);
  else if (dtype == DIN_BF16)
    launch<__nv_bfloat16>(feat, bx, out, B, H, W, C, N, KH, KW, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* din_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
