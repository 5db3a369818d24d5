// K2b: backward of the 2x2 stride-2 max-pool on NHWC maps, floor mode.
//
// Replaces the Pallas TPU kernel din_tpu/ops/pool.py _bwd_kernel (launched by
// _fp_bwd), which computed the same routing on the TPU-only column-folded
// layout [F,H,W/2,2c].  Here x is the pool's NHWC input [F,H,W,C] (saved by
// the forward, as the JAX custom VJP saves it), g the gradient of the output
// [F,H/2,W/2,C], and dx [F,H,W,C] in g's dtype.
//
// Routing, exactly as _bwd_kernel (and _fold_pool_xla): within each row of
// the window the first column wins a tie (a >= b); between the rows the
// first row wins a tie (max(row0) >= max(row1)).  That is the first argmax
// in row-major order, as torch MaxPool2d routes it.  The max is NaN-
// propagating like jnp.maximum, so a NaN in row 1 routes to row 0 exactly as
// the plain version does.  dx takes g's bits at the winner and 0 elsewhere.
// An odd last row or column, which the forward drops, gets 0.
//
// Bound: bytes.  It reads x and g once and writes dx once (pool1 of one
// 5-frame 720x1280 chunk in bf16: 590 + 147 + 590 MB).  Design: one thread
// per output pixel and 16-byte channel vector (8 bf16 or 4 f32), as K2, so
// every load and store of a warp is coalesced.  Each thread writes all four
// dx entries of its window (and the dropped edge beside it), so every dx
// element is written exactly once: no atomics, no zero-fill pass, and the
// result is deterministic and equals the plain version bit for bit.  A
// scalar variant covers channel counts or pointers not 16-byte aligned.
#include "common.cuh"

namespace {

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(p) = v;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> zeros() {
  Pack<T, V> z;
#pragma unroll
  for (int k = 0; k < V; ++k) z.v[k] = din_from_f32<T>(0.0f);
  return z;
}

template <typename T, int V>
__global__ void max_pool_2x2_bwd_kernel(const T* __restrict__ x,
                                        const T* __restrict__ g,
                                        T* __restrict__ dx, int64_t H,
                                        int64_t W, int64_t C, int64_t OH,
                                        int64_t OW, int64_t total) {
  const int64_t cvs = C / V;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const bool odd_h = (H & 1) != 0;
  const bool odd_w = (W & 1) != 0;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t cv = idx % cvs;
    int64_t p = idx / cvs;
    const int64_t ow = p % OW;
    p /= OW;
    const int64_t oh = p % OH;
    const int64_t f = p / OH;
    const int64_t r0 = ((f * H + 2 * oh) * W + 2 * ow) * C + cv * V;
    const int64_t r1 = r0 + W * C;
    const Pack<T, V> a0 = load<T, V>(x + r0);
    const Pack<T, V> b0 = load<T, V>(x + r0 + C);
    const Pack<T, V> a1 = load<T, V>(x + r1);
    const Pack<T, V> b1 = load<T, V>(x + r1 + C);
    // g offset ((f*OH+oh)*OW+ow)*C + cv*V == idx*V
    const Pack<T, V> gv = load<T, V>(g + idx * V);
    const T zero = din_from_f32<T>(0.0f);
    Pack<T, V> da0, db0, da1, db1;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float fa0 = din_to_f32(a0.v[k]), fb0 = din_to_f32(b0.v[k]);
      const float fa1 = din_to_f32(a1.v[k]), fb1 = din_to_f32(b1.v[k]);
      const bool m0 = fa0 >= fb0;  // column winner, row 0
      const bool m1 = fa1 >= fb1;  // column winner, row 1
      const bool mrow = din_nan_max(fa0, fb0) >= din_nan_max(fa1, fb1);
      const T gk = gv.v[k];
      da0.v[k] = (mrow && m0) ? gk : zero;
      db0.v[k] = (mrow && !m0) ? gk : zero;
      da1.v[k] = (!mrow && m1) ? gk : zero;
      db1.v[k] = (!mrow && !m1) ? gk : zero;
    }
    store<T, V>(dx + r0, da0);
    store<T, V>(dx + r0 + C, db0);
    store<T, V>(dx + r1, da1);
    store<T, V>(dx + r1 + C, db1);
    // floor mode: the row and column the forward dropped get 0, written by
    // the threads of the last window beside them
    const bool last_w = odd_w && ow == OW - 1;
    const bool last_h = odd_h && oh == OH - 1;
    if (last_w) {
      store<T, V>(dx + r0 + 2 * C, zeros<T, V>());
      store<T, V>(dx + r1 + 2 * C, zeros<T, V>());
    }
    if (last_h) {
      const int64_t r2 = r1 + W * C;
      store<T, V>(dx + r2, zeros<T, V>());
      store<T, V>(dx + r2 + C, zeros<T, V>());
      if (last_w) store<T, V>(dx + r2 + 2 * C, zeros<T, V>());
    }
  }
}

template <typename T, int V>
void launch(const void* x, const void* g, void* dx, int64_t F, int64_t H,
            int64_t W, int64_t C, cudaStream_t stream) {
  const int64_t OH = H / 2, OW = W / 2;
  const int64_t total = F * OH * OW * (C / V);
  if (total == 0) return;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  max_pool_2x2_bwd_kernel<T, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      H, W, C, OH, OW, total);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int din_max_pool_2x2_bwd(const void* x, const void* g, void* dx,
                                    int64_t F, int64_t H, int64_t W,
                                    int64_t C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(x) && aligned16(g) && aligned16(dx);
  if (dtype == DIN_F32) {
    if (vec_ok && C % 4 == 0)
      launch<float, 4>(x, g, dx, F, H, W, C, s);
    else
      launch<float, 1>(x, g, dx, F, H, W, C, s);
  } else if (dtype == DIN_BF16) {
    if (vec_ok && C % 8 == 0)
      launch<__nv_bfloat16, 8>(x, g, dx, F, H, W, C, s);
    else
      launch<__nv_bfloat16, 1>(x, g, dx, F, H, W, C, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
