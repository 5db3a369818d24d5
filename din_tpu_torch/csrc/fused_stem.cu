// K3: the fused VGG-16 stem forward, torchvision features[0:5] in one kernel:
// conv1_1 (3->64, 3x3, pad 1) + bias + ReLU, conv1_2 (64->64) + bias + ReLU,
// 2x2/2 max-pool, on NHWC maps in floor mode (as K2).
//
// Replaces the Pallas TPU kernel din_tpu/ops/stem_kernel.py _stem_kernel
// (launched by fused_stem_fwd), which worked on the TPU-only column-folded
// layout with an indicator channel for the bias and a 4-row DMA halo, all
// there for the TPU's 128 lanes and VMEM.  Here the input is the canonical
// prepped frame map x [F,H,W,3], the weights are given as w0 [27,64] and
// w2 [576,64] (rows (dh,dw,ci), columns the output channel) plus b0, b2 [64],
// all in x's dtype, and the output is y [F,H/2,W/2,64].
//
// Semantics (those of the plain version din_tpu_torch/ops/stem.py
// fused_stem_ref): conv1_1 sums in f32, adds the bias in f32, applies ReLU
// and rounds y1 once to x's dtype; y1 outside the frame is exactly 0
// (conv1_2's zero padding, not ReLU(b0)); conv1_2 sums in f32, adds the bias
// in f32, applies ReLU, takes the 2x2 max and rounds once.  Bias and ReLU
// are monotone, so max-then-bias-then-ReLU equals the plain version's order.
//
// Bound: operations.  A 5-frame 720x1280 chunk is 356 GFLOP (conv1_2 95 % of
// it) against 175 MB moved, far above the card's ~295 bf16 operations per
// byte, and conv1_1's and conv1_2's 590 MB intermediates never reach device
// memory.  Design, simple first: a persistent grid (as many blocks as fit on
// the SMs) walks over 16x16 tiles of conv1_2's output.  A block keeps conv1_2's
// weights in shared memory for all its tiles.  Per tile it loads the input
// with a 2-pixel halo (prefetched into registers during the previous tile's
// GEMM), computes y1 with a 1-pixel halo on CUDA cores and stores it in
// shared memory, and runs conv1_2 as an implicit GEMM (M = 256 pixels,
// N = 64, K = 576).  conv1_1 is only 27 MACs per value, and on CUDA cores its
// sum is the plain version's: one fmaf per tap in (dh, dw, ci) order, whose
// bf16 products are exact, so y1 equals the plain version's bit for bit (the
// tensor cores' accumulation would round differently, and a y1 rounded to
// the neighbouring bf16 value moves a small pooled output by several ulps).
// Each thread keeps two channels' weights in registers and slides over a
// strip of six pixels, so one broadcast load of the input feeds 4.5 FMAs.
// In bf16, conv1_2 runs on the tensor cores with mma.sync m16n8k16 (bf16 in,
// f32 accumulators), fragments loaded by ldmatrix from rows of 144 bytes
// (no bank conflicts); each warp owns two conv rows (one pooled row) and all
// 64 channels, so the bias, ReLU and pool come straight from its
// accumulators.  In f32 it runs on CUDA cores (used only by the small f32
// checks).  Measured at one 5-frame 720x1280 chunk (chip_smoke.py), 3.2x
// faster than the unfused cuDNN stem and about a quarter of the bound: the
// next steps are wgmma with TMA, and overlapping conv1_1 on CUDA cores with
// the previous tile's GEMM (warp specialisation).
#include "common.cuh"

namespace {

constexpr int TILE = 16;            // conv1_2 output tile, rows and columns
constexpr int Y1T = TILE + 2;       // y1 tile (1-pixel halo)
constexpr int XT = TILE + 4;        // input tile (2-pixel halo)
constexpr int C = 64;               // stem channels
constexpr int KW0 = 27;             // conv1_1 taps x input channels
constexpr int KW2 = 9 * C;          // conv1_2 GEMM depth
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32; // one pooled row of the 8x8 tile each
constexpr int GROUPS = THREADS / C; // threads per output channel
// shared-memory row strides in bf16 elements: 144-byte rows put the eight
// rows of an ldmatrix in eight different 16-byte bank groups
constexpr int Y1_LD_BF16 = 72;
constexpr int W2_LD = 72;

constexpr int P1 = Y1T * Y1T;                 // 324 y1 pixels
constexpr int STRIP = 6;                      // y1 pixels a thread slides over
constexpr int STRIPS = Y1T * (Y1T / STRIP);   // 54 strips of the y1 tile
constexpr int XS_PER_THREAD = (XT * XT * 3 + THREADS - 1) / THREADS;

// shared memory, in bytes
constexpr size_t kXsBytes = XT * XT * 3 * sizeof(float);
constexpr size_t kW2sBytes = KW2 * W2_LD * sizeof(__nv_bfloat16);
constexpr size_t kY1Bf16Bytes = P1 * Y1_LD_BF16 * sizeof(__nv_bfloat16);
constexpr size_t kY1F32Bytes = P1 * C * sizeof(float);
constexpr size_t kSmemBf16 = kW2sBytes + kY1Bf16Bytes + kXsBytes;
constexpr size_t kSmemF32 = kY1F32Bytes + kXsBytes;

__device__ __forceinline__ float relu(float v) {
  return v < 0.f ? 0.f : v;         // keeps NaN, like torch.relu
}

// the input tile with its 2-pixel halo, 0 outside the frame: thread i holds
// xs[i + k*THREADS] = x[f, y0-2+iy, x0-2+ix, c] for (iy*XT + ix)*3 + c = i
template <typename T>
__device__ void load_input(const T* __restrict__ x, float (&v)[XS_PER_THREAD],
                           int64_t f, int64_t y0, int64_t x0, int64_t H,
                           int64_t W) {
#pragma unroll
  for (int k = 0; k < XS_PER_THREAD; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int c = i % 3, p = i / 3;
    const int64_t gy = y0 - 2 + p / XT, gx = x0 - 2 + p % XT;
    v[k] = 0.f;
    if (i < XT * XT * 3 && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v[k] = din_to_f32(x[((f * H + gy) * W + gx) * 3 + c]);
  }
}

__device__ void store_input(const float (&v)[XS_PER_THREAD], float* xs) {
#pragma unroll
  for (int k = 0; k < XS_PER_THREAD; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < XT * XT * 3) xs[i] = v[k];
  }
}

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

__device__ __forceinline__ float2 make_pair(float a, float b, float2*) {
  return make_float2(a, b);
}
__device__ __forceinline__ __nv_bfloat162 make_pair(float a, float b,
                                                    __nv_bfloat162*) {
  return __floats2bfloat162_rn(a, b);
}

// conv1_1 on CUDA cores, y1 of the tile plus its 1-pixel halo: lane l of
// every warp owns channels 2l and 2l+1 (weights w0r, biases b0r) and the
// warp slides over strips of STRIP pixels, every WARPS-th strip.  Each
// pixel's sum is one fmaf per tap in (dh, dw, ci) order from 0, then the
// bias; pixels outside the frame are exactly 0.  y1s rows are LD elements.
template <typename TY, int LD>
__device__ void conv1_1(const float* xs, TY* y1s, const float (&w0r)[2][KW0],
                        const float (&b0r)[2], int64_t y0, int64_t x0,
                        int64_t H, int64_t W) {
  using P = typename Pair<TY>::type;
  const int c0 = 2 * (threadIdx.x % 32);
  for (int s = threadIdx.x / 32; s < STRIPS; s += WARPS) {
    const int oy = s / (Y1T / STRIP), ox0 = (s % (Y1T / STRIP)) * STRIP;
    float acc[2][STRIP];
#pragma unroll
    for (int px = 0; px < STRIP; ++px) acc[0][px] = acc[1][px] = 0.f;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      float xr[STRIP + 2][3];
      const float* row = xs + ((oy + dh) * XT + ox0) * 3;
#pragma unroll
      for (int j = 0; j < STRIP + 2; ++j)
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) xr[j][ci] = row[j * 3 + ci];
#pragma unroll
      for (int dw = 0; dw < 3; ++dw)
#pragma unroll
        for (int ci = 0; ci < 3; ++ci)
#pragma unroll
          for (int px = 0; px < STRIP; ++px)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              acc[c][px] = fmaf(xr[px + dw][ci],
                                w0r[c][(dh * 3 + dw) * 3 + ci], acc[c][px]);
    }
    const int64_t gy = y0 - 1 + oy;
#pragma unroll
    for (int px = 0; px < STRIP; ++px) {
      const int64_t gx = x0 - 1 + ox0 + px;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      *reinterpret_cast<P*>(y1s + (oy * Y1T + ox0 + px) * LD + c0) =
          make_pair(inside ? relu(acc[0][px] + b0r[0]) : 0.f,
                    inside ? relu(acc[1][px] + b0r[1]) : 0.f,
                    static_cast<P*>(nullptr));
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// four 8x8 b16 matrices; lane l gives the row address of matrix l/8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// conv1_2 + bias + ReLU + pool in bf16 on the tensor cores.  Warp w computes
// conv rows 2w and 2w+1 of the tile (two 16-pixel M-tiles) for all 64
// channels (eight 8-channel N-tiles) with mma.sync m16n8k16, its fragments
// loaded by ldmatrix; the pool takes the row pair within a lane and the
// column pair from the neighbouring lane (lane ^ 4), straight from the
// accumulators.
__device__ void conv1_2_bf16(const __nv_bfloat16* y1s,
                             const __nv_bfloat16* w2s,
                             const float (&b2r)[8][2],
                             __nv_bfloat16* __restrict__ out, int64_t f,
                             int64_t py0, int64_t px0, int64_t OH,
                             int64_t OW) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][n][j] = 0.f;
  // A: lane l reads pixel column l%16 at channel offset 8*(l/16);
  // B: lane l reads GEMM row (l%8) + 8*((l/8)%2) at column 8*(l/16)
  const __nv_bfloat16* a_base =
      y1s + (2 * warp * Y1T + lane % 16) * Y1_LD_BF16 + 8 * (lane / 16);
  const __nv_bfloat16* b_base =
      w2s + (lane % 8 + 8 * ((lane / 8) % 2)) * W2_LD + 8 * (lane / 16);
  for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
#pragma unroll
      for (int cb = 0; cb < 4; ++cb) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(a[i], a_base + ((i + dh) * Y1T + dw) * Y1_LD_BF16 + cb * 16);
        const __nv_bfloat16* bk =
            b_base + ((dh * 3 + dw) * C + cb * 16) * W2_LD;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          uint32_t b[4];
          ldsm_x4_t(b, bk + nb * 16);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * nb], a[i], b[0], b[1]);
            mma_bf16(acc[i][2 * nb + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
  }

  // accumulator (i, n, j): conv row 2w+i, pixel column g + 8*(j/2),
  // channel 8n + 2t + j%2, with g = lane/4, t = lane%4
  const int g = lane / 4, t = lane % 4;
  const int64_t oy = py0 + warp;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = din_nan_max(acc[0][n][j], acc[1][n][j]);
      m[j] = din_nan_max(m[j], __shfl_xor_sync(0xffffffffu, m[j], 4));
    }
    if (g % 2 == 0 && oy < OH) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t ox = px0 + g / 2 + 4 * h;
        if (ox < OW)
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((f * OH + oy) * OW + ox) * C + 8 * n + 2 * t) =
              __floats2bfloat162_rn(relu(m[2 * h] + b2r[n][0]),
                                    relu(m[2 * h + 1] + b2r[n][1]));
      }
    }
  }
}

// conv1_2 + bias + ReLU + pool in f32 on CUDA cores: thread (group, co)
// computes channel co of every GROUPS-th pooled pixel of the 8x8 tile, its
// weights read through the L1 cache
__device__ void conv1_2_f32(const float* y1s, const float* __restrict__ w2,
                            float b2r, float* __restrict__ out, int64_t f,
                            int64_t py0, int64_t px0, int64_t OH,
                            int64_t OW) {
  const int co = threadIdx.x % C;
  for (int pp = threadIdx.x / C; pp < (TILE / 2) * (TILE / 2);
       pp += GROUPS) {
    const int py = pp / (TILE / 2), px = pp % (TILE / 2);
    const int64_t oy = py0 + py, ox = px0 + px;
    if (oy >= OH || ox >= OW) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int dh = 0; dh < 3; ++dh) {
      for (int dw = 0; dw < 3; ++dw) {
        const float* wk = w2 + (dh * 3 + dw) * C * C + co;
        const float* yk = y1s + ((2 * py + dh) * Y1T + 2 * px + dw) * C;
        for (int ci = 0; ci < C; ++ci) {
          const float w = __ldg(wk + ci * C);
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
              acc[dy * 2 + dx] =
                  fmaf(yk[(dy * Y1T + dx) * C + ci], w, acc[dy * 2 + dx]);
        }
      }
    }
    float m = din_nan_max(din_nan_max(acc[0], acc[1]),
                          din_nan_max(acc[2], acc[3]));
    out[((f * OH + oy) * OW + ox) * C + co] = relu(m + b2r);
  }
}

__device__ __forceinline__ void tile_origin(int64_t t, int64_t tiles_y,
                                            int64_t tiles_x, int64_t& f,
                                            int64_t& y0, int64_t& x0) {
  const int64_t r = t / tiles_x;
  x0 = (t % tiles_x) * TILE;
  y0 = (r % tiles_y) * TILE;
  f = r / tiles_y;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    fused_stem_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                      const T* __restrict__ b0, const T* __restrict__ w2,
                      const T* __restrict__ b2, T* __restrict__ out,
                      int64_t F, int64_t H, int64_t W, int64_t tiles_y,
                      int64_t tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kBf16 = sizeof(T) == 2;
  const int64_t OH = H / 2, OW = W / 2;
  const int64_t ntiles = F * tiles_y * tiles_x;
  int64_t f, y0, x0;
  float pre[XS_PER_THREAD];
  if (blockIdx.x < ntiles) {
    tile_origin(blockIdx.x, tiles_y, tiles_x, f, y0, x0);
    load_input<T>(x, pre, f, y0, x0, H, W);
  }
  const int c0 = 2 * (threadIdx.x % 32);
  float w0r[2][KW0], b0r[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int k = 0; k < KW0; ++k) w0r[c][k] = din_to_f32(w0[k * C + c0 + c]);
    b0r[c] = din_to_f32(b0[c0 + c]);
  }

  // shared memory: [w2s (bf16 only)], y1s, xs
  unsigned char* sp = smem;
  __nv_bfloat16* w2s = nullptr;
  float b2r[8][2];
  if constexpr (kBf16) {
    w2s = reinterpret_cast<__nv_bfloat16*>(sp);
    sp += kW2sBytes;
    // conv1_2's weights once per block, 16 bytes a thread
    for (int i = threadIdx.x; i < KW2 * (C / 8); i += THREADS) {
      const int r = i / (C / 8), v = i % (C / 8);
      *reinterpret_cast<uint4*>(w2s + r * W2_LD + v * 8) =
          *reinterpret_cast<const uint4*>(w2 + r * C + v * 8);
    }
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        b2r[n][j] = din_to_f32(b2[8 * n + 2 * t + j]);
  } else {
    b2r[0][0] = b2[threadIdx.x % C];
  }
  T* y1s = reinterpret_cast<T*>(sp);
  sp += kBf16 ? kY1Bf16Bytes : kY1F32Bytes;
  float* xs = reinterpret_cast<float*>(sp);

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // xs was last read before this block's previous barrier
    store_input(pre, xs);
    __syncthreads();   // xs ready; every warp is done with y1s
    conv1_1<T, kBf16 ? Y1_LD_BF16 : C>(xs, y1s, w0r, b0r, y0, x0, H, W);
    __syncthreads();   // y1s ready
    const int64_t f_t = f, py0 = y0 / 2, px0 = x0 / 2;
    if (t + gridDim.x < ntiles) {   // the next tile's input, in flight
      tile_origin(t + gridDim.x, tiles_y, tiles_x, f, y0, x0);
      load_input<T>(x, pre, f, y0, x0, H, W);
    }
    if constexpr (kBf16)
      conv1_2_bf16(y1s, w2s, b2r, out, f_t, py0, px0, OH, OW);
    else
      conv1_2_f32(y1s, w2, b2r[0][0], out, f_t, py0, px0, OH, OW);
  }
}

template <typename T>
int launch(const void* x, const void* w0, const void* b0, const void* w2,
           const void* b2, void* out, int64_t F, int64_t H, int64_t W,
           cudaStream_t stream) {
  const int64_t OH = H / 2, OW = W / 2;
  const int64_t tiles_y = (OH + TILE / 2 - 1) / (TILE / 2);
  const int64_t tiles_x = (OW + TILE / 2 - 1) / (TILE / 2);
  const int64_t ntiles = F * tiles_y * tiles_x;
  if (ntiles == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(T) == 2 ? kSmemBf16 : kSmemF32;
  auto kern = fused_stem_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int64_t blocks = (int64_t)sms * per_sm;
  if (blocks > ntiles) blocks = ntiles;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0),
      static_cast<const T*>(b0), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), F, H, W, tiles_y,
      tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int din_fused_stem(const void* x, const void* w0, const void* b0,
                              const void* w2, const void* b2, void* out,
                              int64_t F, int64_t H, int64_t W, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DIN_F32)
    return launch<float>(x, w0, b0, w2, b2, out, F, H, W, s);
  if (dtype == DIN_BF16)
    return launch<__nv_bfloat16>(x, w0, b0, w2, b2, out, F, H, W, s);
  return (int)cudaErrorInvalidValue;
}
