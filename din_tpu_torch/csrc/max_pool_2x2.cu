// K2: 2x2 stride-2 max-pool forward on NHWC maps, floor mode.
//
// Replaces the Pallas TPU kernel din_tpu/ops/pool.py _fwd_kernel (launched by
// _pallas_fwd_call), which pooled the TPU-only column-folded layout
// [F,H,W/2,2c].  Here the input is the canonical NHWC map (a channels_last
// conv output) [F,H,W,C] and the output [F,H/2,W/2,C]; an odd last row or
// column is dropped, as torch MaxPool2d does (VGG pool5 sees 45 rows at
// 720x1280).
//
// Bound: pure data movement, one read of the input and one write of the
// output at the card's memory rate (pool1 of one 720x1280 frame in bf16:
// 118 MB read, 29 MB written).  Design: one thread per output pixel and
// 16-byte channel vector (8 bf16 or 4 f32), neighbouring threads on
// neighbouring channels so each warp issues fully coalesced 16-byte loads;
// a scalar variant covers channel counts or pointers not 16-byte aligned.
// The max is exact, so the result equals the plain version bit for bit.
#include "common.cuh"

namespace {

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void max_pool_2x2_kernel(const T* __restrict__ x,
                                    T* __restrict__ y, int64_t H, int64_t W,
                                    int64_t C, int64_t OH, int64_t OW,
                                    int64_t total) {
  const int64_t cvs = C / V;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t cv = idx % cvs;
    int64_t p = idx / cvs;
    const int64_t ow = p % OW;
    p /= OW;
    const int64_t oh = p % OH;
    const int64_t f = p / OH;
    const T* base = x + ((f * H + 2 * oh) * W + 2 * ow) * C + cv * V;
    const Pack<T, V> a = *reinterpret_cast<const Pack<T, V>*>(base);
    const Pack<T, V> b = *reinterpret_cast<const Pack<T, V>*>(base + C);
    const Pack<T, V> c = *reinterpret_cast<const Pack<T, V>*>(base + W * C);
    const Pack<T, V> d =
        *reinterpret_cast<const Pack<T, V>*>(base + W * C + C);
    Pack<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      // window order (0,0) (0,1) (1,0) (1,1), row-major
      float m = din_to_f32(a.v[k]);
      m = din_nan_max(m, din_to_f32(b.v[k]));
      m = din_nan_max(m, din_to_f32(c.v[k]));
      m = din_nan_max(m, din_to_f32(d.v[k]));
      o.v[k] = din_from_f32<T>(m);
    }
    // output offset ((f*OH+oh)*OW+ow)*C + cv*V == idx*V
    *reinterpret_cast<Pack<T, V>*>(y + idx * V) = o;
  }
}

template <typename T, int V>
void launch(const void* x, void* y, int64_t F, int64_t H, int64_t W,
            int64_t C, cudaStream_t stream) {
  const int64_t OH = H / 2, OW = W / 2;
  const int64_t total = F * OH * OW * (C / V);
  if (total == 0) return;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  max_pool_2x2_kernel<T, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), H, W, C, OH, OW, total);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int din_max_pool_2x2(const void* x, void* y, int64_t F, int64_t H,
                                int64_t W, int64_t C, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(x) && aligned16(y);
  if (dtype == DIN_F32) {
    if (vec_ok && C % 4 == 0)
      launch<float, 4>(x, y, F, H, W, C, s);
    else
      launch<float, 1>(x, y, F, H, W, C, s);
  } else if (dtype == DIN_BF16) {
    if (vec_ok && C % 8 == 0)
      launch<__nv_bfloat16, 8>(x, y, F, H, W, C, s);
    else
      launch<__nv_bfloat16, 1>(x, y, F, H, W, C, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
