// K1: RoIAlign forward (TF crop_and_resize with transform_fpcoor).
//
// Replaces the Pallas TPU kernel din_tpu/ops/roi_align.py
// _roi_align_pallas_kernel (launched by _roi_align_pallas_fwd_impl), which
// built a one-hot interpolation matrix per frame and contracted it on the
// MXU.  On Hopper the natural form is the gather itself: each output row is
// a lerp of four NHWC pixel rows.
//
// Inputs: features [B,H,W,C] (f32 or bf16), boxes [B,N,4] (x1, y1, x2, y2,
// f32) and the output [B,N,KH,KW,C] in the features' dtype.  Each thread
// computes its sample centre itself, bin = (y2 - y1) / KH and
// y_i = y1 + (i + 0.5) * bin - 0.5 (likewise x), with the helpers of
// roi_grid.cuh, which K1b shares: in the order of the plain version's
// _sample_grid (din_tpu_torch/ops/roi_align.py) with each op rounded once, as
// a centre rounded otherwise flips the in-range test of a sample that lands
// exactly on the border (the JAX kernel hit exactly this,
// din_tpu/ops/roi_align.py:199-206).  So the wrapper launches this one kernel
// and no torch op besides the output's allocation.
//
// Per sample: in-range test on [0,H-1]x[0,W-1] (a sample outside is 0 as a
// whole), clamp, floor/ceil corners, four-corner lerp accumulated in f32.
// The lerp rounds each product and sum on its own (__fmul_rn, __fadd_rn) in
// the plain version's order: an FMA would round differently, and where the
// four terms cancel to near 0 that difference is many bf16 ulps of the
// result.  So the kernel equals the plain version bit for bit.
//
// Bound: bytes.  The kernel reads each sampled pixel row once and writes
// the output once (at the flagship, 20 frames x 12 boxes x 5x5 x C=512 in
// bf16: 8.48 MB, 2.53 us at 3.35 TB/s); its 11 f32 operations per output
// value are far below the card's rate.  There is no product, so no wgmma,
// and the four rows of a sample sit at addresses that depend on the data,
// so no TMA tile describes them.  What the kernel has to do is keep enough
// loads in flight: one thread per (frame, box, sample, 16-byte channel
// vector), a flat grid of 256-thread blocks (at the flagship 6000 samples x
// 64 vectors, 1500 blocks, all resident at once), and each thread issues
// its four corner loads as 16-byte read-only loads (ld.global.nc.v4) before
// the blend, then writes one 16-byte store.  Neighbouring threads take
// neighbouring vectors of one pixel row, so every load and store of a warp
// is coalesced.  When C is not a multiple of the vector (8 bf16 or 4 f32)
// or a pointer is not 16-byte aligned, the rows do not start on 16-byte
// boundaries: every thread then covers its vector's channels with scalar
// loads and stores in the same kernel, with the same arithmetic.
// tests/test_torch_k1_layout.py emulates this map of threads to outputs.
#include "roi_grid.cuh"

namespace {

constexpr int kThreads = 256;

// 16 bytes of T as f32 values and back (bf16: element 2k is the low half
// of word k; the round to bf16 is to nearest even, as din_from_f32)
template <typename T>
struct DinVec;

template <>
struct DinVec<float> {
  static constexpr int n = 4;
  __device__ static void unpack(uint4 u, float (&f)[n]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[n]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct DinVec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(uint4 u, float (&f)[n]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static unsigned bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
  __device__ static uint4 pack(const float (&f)[n]) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = bits(f[2 * k]) | (bits(f[2 * k + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// the blend of one value, rounded op by op in the plain version's order
__device__ __forceinline__ float din_lerp4(float f00, float f01, float f10,
                                           float f11, float w00, float w01,
                                           float w10, float w11) {
  float v = __fmul_rn(f00, w00);
  v = __fadd_rn(v, __fmul_rn(f01, w01));
  v = __fadd_rn(v, __fmul_rn(f10, w10));
  return __fadd_rn(v, __fmul_rn(f11, w11));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ boxes,
                 T* __restrict__ out, int H, int W, int C, int N, int KH,
                 int KW, unsigned vecs, unsigned total, bool whole) {
  using V = DinVec<T>;
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  // thread t -> (sample s, vector v); s -> (frame, box, i, j)
  const unsigned s = t / vecs;
  const int v = (int)(t - s * vecs);
  const unsigned kk = (unsigned)(KH * KW);
  const unsigned bn = s / kk;
  const int ij = (int)(s - bn * kk);
  const int i = ij / KW;
  const int j = ij - i * KW;
  const int64_t b = bn / (unsigned)N;
  const float* bx = boxes + (int64_t)bn * 4;
  const DinRoiAxis ay = din_roi_axis(
      din_roi_sample_centre(__ldg(bx + 1), __ldg(bx + 3), KH, i),
      (float)(H - 1));
  const DinRoiAxis ax = din_roi_axis(
      din_roi_sample_centre(__ldg(bx), __ldg(bx + 2), KW, j),
      (float)(W - 1));
  const int c0 = v * V::n;
  T* o = out + (int64_t)s * C + c0;
  const bool ok = ay.ok && ax.ok;
  if (whole) {
    if (!ok) {
      *reinterpret_cast<uint4*>(o) = make_uint4(0u, 0u, 0u, 0u);
      return;
    }
  } else if (!ok) {
    for (int c = c0; c < c0 + V::n && c < C; ++c)
      o[c - c0] = din_from_f32<T>(0.0f);
    return;
  }
  const float w00 = __fmul_rn(ay.w_lo, ax.w_lo);
  const float w01 = __fmul_rn(ay.w_lo, ax.w_hi);
  const float w10 = __fmul_rn(ay.w_hi, ax.w_lo);
  const float w11 = __fmul_rn(ay.w_hi, ax.w_hi);
  const T* fb = feat + b * H * W * C + c0;
  const T* r00 = fb + ((int64_t)ay.lo * W + ax.lo) * C;
  const T* r01 = fb + ((int64_t)ay.lo * W + ax.hi) * C;
  const T* r10 = fb + ((int64_t)ay.hi * W + ax.lo) * C;
  const T* r11 = fb + ((int64_t)ay.hi * W + ax.hi) * C;
  if (whole) {
    // all four loads in flight before the blend
    const uint4 u00 = __ldg(reinterpret_cast<const uint4*>(r00));
    const uint4 u01 = __ldg(reinterpret_cast<const uint4*>(r01));
    const uint4 u10 = __ldg(reinterpret_cast<const uint4*>(r10));
    const uint4 u11 = __ldg(reinterpret_cast<const uint4*>(r11));
    float f00[V::n], f01[V::n], f10[V::n], f11[V::n], y[V::n];
    V::unpack(u00, f00);
    V::unpack(u01, f01);
    V::unpack(u10, f10);
    V::unpack(u11, f11);
#pragma unroll
    for (int e = 0; e < V::n; ++e)
      y[e] = din_lerp4(f00[e], f01[e], f10[e], f11[e], w00, w01, w10, w11);
    *reinterpret_cast<uint4*>(o) = V::pack(y);
    return;
  }
  // scalar tail: C is not a multiple of the vector or a row is unaligned
  for (int e = 0; e < V::n && c0 + e < C; ++e)
    o[e] = din_from_f32<T>(din_lerp4(
        din_to_f32(r00[e]), din_to_f32(r01[e]), din_to_f32(r10[e]),
        din_to_f32(r11[e]), w00, w01, w10, w11));
}

template <typename T>
int launch(const void* feat, const float* boxes, void* out, int64_t B,
           int64_t H, int64_t W, int64_t C, int64_t N, int64_t KH,
           int64_t KW, cudaStream_t stream) {
  if (B * N * KH * KW == 0 || C == 0) return 0;
  constexpr int n = DinVec<T>::n;
  const int64_t vecs = (C + n - 1) / n;
  const int64_t total = B * N * KH * KW * vecs;
  // the flat grid is indexed in 32 bits (the largest map the port runs
  // needs ~7e6 threads); larger work is refused, not wrapped
  if (total > (int64_t)UINT32_MAX - kThreads || H > INT32_MAX ||
      W > INT32_MAX || C > INT32_MAX || N > INT32_MAX || KH * KW > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const bool whole = C % n == 0 &&
                     ((reinterpret_cast<uintptr_t>(feat) |
                       reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  roi_align_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), boxes, static_cast<T*>(out), (int)H,
      (int)W, (int)C, (int)N, (int)KH, (int)KW, (unsigned)vecs,
      (unsigned)total, whole);
  return 0;
}

}  // namespace

extern "C" int din_roi_align(const void* feat, const void* boxes, void* out,
                             int64_t B, int64_t H, int64_t W, int64_t C,
                             int64_t N, int64_t KH, int64_t KW, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  int code;
  if (dtype == DIN_F32)
    code = launch<float>(feat, bx, out, B, H, W, C, N, KH, KW, s);
  else if (dtype == DIN_BF16)
    code = launch<__nv_bfloat16>(feat, bx, out, B, H, W, C, N, KH, KW, s);
  else
    return (int)cudaErrorInvalidValue;
  return code ? code : (int)cudaGetLastError();
}

extern "C" const char* din_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
