// K1b: RoIAlign backward, d(features) from d(crops).
//
// Not a port of a Pallas kernel: din_tpu computes this gradient with XLA
// einsums (din_tpu/ops/roi_align.py _pallas_bwd for impl='pallas', autodiff
// of _roi_align_onehot on the default path).  The port writes it as a kernel
// because a CUDA tensor must launch a kernel or raise.
//
// Inputs: g [B,N,KH,KW,C] (f32 or bf16), the sample centres ys [B,N,KH] and
// xs [B,N,KW] (f32) that K1 used, and a zeroed f32 scratch df [B,H,W,C].
// Each sample in range adds w*g to its four corner rows, with the weights
// K1 blends with (wy0*wx0, wy0*wx1, wy1*wx0, wy1*wx1); corners that coincide
// (an integer coordinate, or a clamp at the border) each add their own
// weight, as the one-hot sum does.  A sample outside the map adds nothing.
// The wrapper casts df to the features' dtype afterwards, as _pallas_bwd
// does (df in f32, then astype).  The products are rounded on their own
// (__fmul_rn), as the plain version rounds them; the atomics add them in an
// order that varies from run to run, so the kernel equals the plain version
// only up to f32 summation order.
//
// Bound: bytes, and tiny at the flagship (g is 6.1 MB in bf16, the touched
// rows of df a fraction of 36 MB): the kernel is launch-bound.  Design: one
// block per (frame, box), threads across C as in K1, so each corner-row
// update is a coalesced run of atomicAdds; rows shared by overlapping boxes
// meet in L2.
#include "common.cuh"

namespace {

template <typename T>
__global__ void roi_align_bwd_kernel(const T* __restrict__ g,
                                     const float* __restrict__ ys,
                                     const float* __restrict__ xs,
                                     float* __restrict__ df, int64_t H,
                                     int64_t W, int64_t C, int64_t N,
                                     int64_t KH, int64_t KW) {
  const int64_t bn = blockIdx.x;  // frame * N + box
  const int64_t b = bn / N;
  float* fb = df + b * H * W * C;
  const float* yrow = ys + bn * KH;
  const float* xrow = xs + bn * KW;
  const T* gb = g + bn * KH * KW * C;
  const float hmax = (float)(H - 1);
  const float wmax = (float)(W - 1);
  for (int64_t i = 0; i < KH; ++i) {
    const float y = yrow[i];
    if (!((y >= 0.0f) && (y <= hmax))) continue;
    const float yc = fminf(fmaxf(y, 0.0f), hmax);
    const float y0f = floorf(yc);
    const float y1f = ceilf(yc);
    const float wy1 = yc - y0f;
    const float wy0 = 1.0f - wy1;
    for (int64_t j = 0; j < KW; ++j) {
      const float x = xrow[j];
      if (!((x >= 0.0f) && (x <= wmax))) continue;
      const float xc = fminf(fmaxf(x, 0.0f), wmax);
      const float x0f = floorf(xc);
      const float x1f = ceilf(xc);
      const float wx1 = xc - x0f;
      const float wx0 = 1.0f - wx1;
      const float w00 = wy0 * wx0, w01 = wy0 * wx1;
      const float w10 = wy1 * wx0, w11 = wy1 * wx1;
      const int64_t y0 = (int64_t)y0f, y1 = (int64_t)y1f;
      const int64_t x0 = (int64_t)x0f, x1 = (int64_t)x1f;
      float* r00 = fb + (y0 * W + x0) * C;
      float* r01 = fb + (y0 * W + x1) * C;
      float* r10 = fb + (y1 * W + x0) * C;
      float* r11 = fb + (y1 * W + x1) * C;
      const T* gs = gb + (i * KW + j) * C;
      for (int64_t c = threadIdx.x; c < C; c += blockDim.x) {
        const float gv = din_to_f32(gs[c]);
        atomicAdd(r00 + c, __fmul_rn(gv, w00));
        atomicAdd(r01 + c, __fmul_rn(gv, w01));
        atomicAdd(r10 + c, __fmul_rn(gv, w10));
        atomicAdd(r11 + c, __fmul_rn(gv, w11));
      }
    }
  }
}

template <typename T>
void launch(const void* g, const float* ys, const float* xs, float* df,
            int64_t B, int64_t H, int64_t W, int64_t C, int64_t N, int64_t KH,
            int64_t KW, cudaStream_t stream) {
  if (B * N == 0 || C == 0) return;
  int threads = (int)((C + 31) / 32 * 32);
  if (threads > 256) threads = 256;
  roi_align_bwd_kernel<T><<<(unsigned)(B * N), threads, 0, stream>>>(
      static_cast<const T*>(g), ys, xs, df, H, W, C, N, KH, KW);
}

}  // namespace

extern "C" int din_roi_align_bwd(const void* g, const void* ys,
                                 const void* xs, void* df32, int64_t B,
                                 int64_t H, int64_t W, int64_t C, int64_t N,
                                 int64_t KH, int64_t KW, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y = static_cast<const float*>(ys);
  const float* x = static_cast<const float*>(xs);
  float* df = static_cast<float*>(df32);
  if (dtype == DIN_F32)
    launch<float>(g, y, x, df, B, H, W, C, N, KH, KW, s);
  else if (dtype == DIN_BF16)
    launch<__nv_bfloat16>(g, y, x, df, B, H, W, C, N, KH, KW, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
