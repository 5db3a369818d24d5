// K3: the fused VGG-16 stem forward, torchvision features[0:5] in one kernel:
// conv1_1 (3->64, 3x3, pad 1) + bias + ReLU, conv1_2 (64->64) + bias + ReLU,
// 2x2/2 max-pool, on NHWC maps in floor mode (as K2).
//
// Replaces the Pallas TPU kernel din_tpu/ops/stem_kernel.py _stem_kernel
// (launched by fused_stem_fwd), which worked on the TPU-only column-folded
// layout with an indicator channel for the bias and a 4-row DMA halo, all
// there for the TPU's 128 lanes and VMEM.  Here the input is the canonical
// prepped frame map x [F,H,W,3], the weights are torch's OIHW tensors
// w0 [64,3,3,3] and w2 [64,64,3,3] plus b0, b2 [64], all contiguous and in
// x's dtype, and the output is y [F,H/2,W/2,64].  The wrapper hands the
// tensors over as they are; the kernel lays out what it needs itself.
//
// Semantics (those of the plain version din_tpu_torch/ops/stem.py
// fused_stem_ref): conv1_1 sums in f32, adds the bias in f32, applies ReLU
// and rounds y1 once to x's dtype; y1 outside the frame is exactly 0
// (conv1_2's zero padding, not ReLU(b0)); conv1_2 sums in f32, adds the bias
// in f32, applies ReLU, takes the 2x2 max and rounds once.  Bias and ReLU
// are monotone, so max-then-bias-then-ReLU equals the plain version's order.
// conv1_1 runs on CUDA cores, one fmaf per tap in (dh, dw, ci) order from 0:
// with bf16 frames and weights every product is exact, so y1 equals the
// plain version's bit for bit (a tensor core's accumulation rounds
// otherwise, and a y1 on the neighbouring bf16 value moves a small pooled
// output by several ulps).  Only conv1_2's order of summation differs.
//
// Bound: operations.  A 5-frame 720x1280 chunk is 356 GFLOP (conv1_2 95 % of
// it) against 175 MB moved, far above the card's ~295 bf16 operations per
// byte; conv1_1's and conv1_2's 590 MB intermediates never reach device
// memory.  conv1_1 is ~9 GFMA per chunk on the f32 pipes, ~0.3 ms at their
// peak, about as long as conv1_2 at the tensor cores'.
//
// Design.  A persistent grid (one block per SM) gives each block a
// contiguous run of 16x16 tiles of conv1_2's output (8x8 pooled pixels);
// tiles run down the columns of a frame.
//
// bf16 (serving and every eval pass): warp-specialised, 384 threads.
// - Two producer warpgroups (warps 4-11) load each tile's input with its
//   2-pixel halo into registers (issued after the previous tile's empty
//   wait, so that no barrier waits on loads in flight), store it as f32
//   into shared memory, and compute y1 with its 1-pixel halo on CUDA cores
//   into a ring of two y1 buffers.  Lane l of each producer warp owns
//   channels 2l and 2l+1 (their 54 weights in registers) and the warp works
//   on units of two y1 rows x six pixels, whose 8-pixel input windows are
//   stored apart so that each input row is six 16-byte broadcast loads for
//   up to 216 FMAs.  A tile below the previous one copies that one's last
//   two y1 rows as its first two and computes only 16 new rows (24 units,
//   three per warp).
// - One consumer warpgroup (warps 0-3) runs conv1_2 on the buffer before as
//   an implicit GEMM (M = 256 pixels, N = 64 channels, K = 9 taps x 64
//   channels) with wgmma.mma_async m64n64k16 (bf16 in, f32 accumulators).
//   B, conv1_2's weights, is staged once per block into shared memory as
//   nine K-major tiles with the 128-byte swizzle, read by the tensor cores
//   through a matrix descriptor once per warpgroup instruction:
//     w2s[tap][o] is a 128-byte row holding w2[o, ci, dh, dw] for ci 0..63,
//     tap = 3*dh + dw, its 16-byte chunk ci/8 stored at chunk (ci/8) ^ (o%8),
//     so byte tap*8192 + o*128 + (((ci/8) ^ (o%8)) * 16) + (ci%8)*2.
//   A, the im2col windows of y1, comes from registers, loaded by ldmatrix:
//   each warp chooses its 16 rows, so y1 keeps its 18-pixel tile rows.  y1
//   pixel p is a 128-byte row of 64 channels whose 16-byte chunk j sits at
//   chunk j ^ (p%8): the eight rows of every ldmatrix land in eight
//   different bank groups.  Consumer warp w owns conv rows 4w .. 4w+3 as
//   M-tiles 0-3 (16 pixels each), so the 2x2 pool takes the row pair within
//   a lane and the column pair from lane ^ 4, straight from the
//   accumulators.  The six y1 rows 4w .. 4w+5 it reads for one (dw,
//   16-channel block) feed twelve wgmmas (three dh times four M-tiles); A
//   is double-buffered in registers, each group of twelve committed and
//   waited for one group later.  setmaxnreg gives the consumer 216
//   registers a thread (128 accumulators) and the producers 144.
// - mbarrier full/empty pairs hand the y1 buffers between the roles; no
//   __syncthreads after the weights are staged.
// Shared memory: 73,728 B of weights, 2 x 41,472 B of y1, 2 x 5,760 B of
// input windows, 4 barriers.  Inline PTX only (no CUTLASS headers), sm_90a.
//
// experiments/profile_stem.py times the roles alone through two diagnostic
// builds (DIN_STEM_PRODUCER_ONLY, DIN_STEM_CONSUMER_ONLY) that the port
// never loads.
//
// f32 (only the small f32 checks): 256 threads, one role, in turns: load,
// __syncthreads, conv1_1 as above into an f32 y1 tile, __syncthreads, conv1_2
// on CUDA cores (thread (group, co) computes channel co of every GROUPS-th
// pooled pixel, its weights read through the L1 cache).
#include "common.cuh"

namespace {

constexpr int TILE = 16;            // conv1_2 output tile, rows and columns
constexpr int Y1T = TILE + 2;       // y1 tile (1-pixel halo)
constexpr int XT = TILE + 4;        // input tile (2-pixel halo)
constexpr int C = 64;               // stem channels
constexpr int KW0 = 27;             // conv1_1 taps x input channels
constexpr int P1 = Y1T * Y1T;       // 324 y1 pixels
constexpr int XS_ELEMS = XT * XT * 3;         // the input tile's values
constexpr int STRIP = 6;                      // y1 pixels a lane slides over
constexpr int WINS = Y1T / STRIP;             // 3 strips per y1 row
constexpr int WIN = (STRIP + 2) * 3;          // input floats a strip reads
// the input tile in shared memory, row by row as the 3 overlapping 8-pixel
// windows the strips read (96 bytes each: six 16-byte loads per row)
constexpr size_t kXsBytes = XT * WINS * WIN * sizeof(float);

// f32 path
constexpr int F32_THREADS = 256;
constexpr int F32_WARPS = F32_THREADS / 32;
constexpr int GROUPS = F32_THREADS / C;       // threads per output channel
constexpr size_t kSmemF32 = P1 * C * sizeof(float) + kXsBytes;

// bf16 path
constexpr int CONSUMER_THREADS = 128;         // warpgroup 0
constexpr int CONSUMER_WARPS = CONSUMER_THREADS / 32;
constexpr int MT = TILE / CONSUMER_WARPS;     // conv rows (M-tiles) a warp owns
constexpr int PRODUCER_THREADS = 256;         // warpgroups 1 and 2
constexpr int PRODUCER_WARPS = PRODUCER_THREADS / 32;
constexpr int BF16_THREADS = CONSUMER_THREADS + PRODUCER_THREADS;
// registers per thread: the launch gives every thread LAUNCH_REGS (what
// __launch_bounds__ lets ptxas use); setmaxnreg then moves registers from
// the producers to the consumer, their sum staying what the launch gave
constexpr int LAUNCH_REGS = (65536 / BF16_THREADS) & ~7;
constexpr int CONSUMER_REGS = 216;
constexpr int PRODUCER_REGS = 144;
static_assert(CONSUMER_REGS * CONSUMER_THREADS +
                  PRODUCER_REGS * PRODUCER_THREADS <=
                  LAUNCH_REGS * BF16_THREADS,
              "the consumer would wait for registers never given back");
constexpr int STAGES = 2;                     // y1 buffers
constexpr int W2_TAP_BYTES = C * 128;         // one K-major 64x64 bf16 tile
constexpr int Y1_BYTES = P1 * 128;            // 64 bf16 channels per pixel
constexpr size_t kSmemBf16 = 1024             // slack to align to 1024
                             + 9 * W2_TAP_BYTES + STAGES * Y1_BYTES
                             + 2 * kXsBytes + 2 * STAGES * sizeof(uint64_t);

__device__ __forceinline__ float relu(float v) {
  return v < 0.f ? 0.f : v;         // keeps NaN, like torch.relu
}

// shared-memory accesses by 32-bit shared address (plain C++ pointers into
// dynamic shared memory compile to generic loads and stores here)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts_v4(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void sts_f32(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void sts_b32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void sts_b16(uint32_t a, unsigned short v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(a), "h"(v) : "memory");
}

// the input tile with its 2-pixel halo, 0 outside the frame: thread i of NT
// holds the values i + k*NT of x[f, y0-2+iy, x0-2+ix, c], (iy*XT + ix)*3 + c,
// as loaded (converted to f32 only when stored)
template <int NT, typename T>
struct InputTile {
  static constexpr int PER_THREAD = (XS_ELEMS + NT - 1) / NT;
  T v[PER_THREAD];

  __device__ __forceinline__ void load(const T* __restrict__ x, int tid,
                                       int f, int y0, int x0, int H, int W) {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int i = tid + k * NT;
      const int c = i % 3, p = i / 3;
      const int gy = y0 - 2 + p / XT, gx = x0 - 2 + p % XT;
      v[k] = din_from_f32<T>(0.f);
      if (i < XS_ELEMS && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v[k] = x[(((int64_t)f * H + gy) * W + gx) * 3 + c];
    }
  }

  // input pixel ix of a row lies in window w for 6w <= ix < 6w + 8
  __device__ __forceinline__ void store(uint32_t xs, int tid) const {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int i = tid + k * NT;
      if (i >= XS_ELEMS) continue;
      const int c = i % 3, p = i / 3, iy = p / XT, ix = p % XT;
      const int w_hi = min(ix / STRIP, WINS - 1);
      const float val = din_to_f32(v[k]);
#pragma unroll
      for (int w = w_hi - 1; w <= w_hi; ++w)
        if (w >= 0 && ix - STRIP * w < STRIP + 2)
          sts_f32(xs + ((iy * WINS + w) * WIN + (ix - STRIP * w) * 3 + c) * 4,
                  val);
    }
  }
};

// conv1_1's weights of channels 2*lane and 2*lane + 1, tap (dh, dw, ci) at
// index (dh*3 + dw)*3 + ci, read from OIHW w0
template <typename T>
__device__ __forceinline__ void load_w0(const T* __restrict__ w0,
                                        const T* __restrict__ b0, int lane,
                                        float (&w0r)[2][KW0],
                                        float (&b0r)[2]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int o = 2 * lane + c;
#pragma unroll
    for (int k = 0; k < KW0; ++k) {
      const int dh = k / 9, dw = (k / 3) % 3, ci = k % 3;
      w0r[c][k] = din_to_f32(w0[((o * 3 + ci) * 3 + dh) * 3 + dw]);
    }
    b0r[c] = din_to_f32(b0[o]);
  }
}

// conv1_1 on CUDA cores, y1 rows first_row .. Y1T-1 of the tile (with its
// 1-pixel halo): work units of two y1 rows x STRIP pixels (units first,
// first + step, ...), each lane computing its two channels, so every input
// row the unit reads feeds both output rows (four chains of FMAs per input
// value, where ptxas would otherwise run one or two).  Each pixel's sum is
// one fmaf per tap in (dh, dw, ci) order from 0 (input row r feeds output
// row j with dh = r - j, rows in ascending order), then the bias; pixels
// outside the frame are exactly 0.  store(p, v0, v1) writes y1 pixel p's
// two channels.
template <class Store>
__device__ __forceinline__ void conv1_1(uint32_t xs,
                                        const float (&w0r)[2][KW0],
                                        const float (&b0r)[2], int y0,
                                        int x0, int H, int W, int first_row,
                                        int first, int step, Store store) {
  const int units = (Y1T - first_row) / 2 * WINS;
  for (int u = first; u < units; u += step) {
    const int oy = first_row + 2 * (u / WINS), sc = u % WINS;
    const int ox0 = sc * STRIP;
    float acc[2][2][STRIP];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int px = 0; px < STRIP; ++px) acc[j][0][px] = acc[j][1][px] = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // the strip's window of input row oy + r: 8 pixels x 3 channels
      const uint32_t row = xs + ((oy + r) * WINS + sc) * WIN * 4;
      float xr[WIN];
#pragma unroll
      for (int q = 0; q < WIN / 4; ++q) {
        const float4 v = lds128(row + 16 * q);
        xr[4 * q] = v.x;
        xr[4 * q + 1] = v.y;
        xr[4 * q + 2] = v.z;
        xr[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int dw = 0; dw < 3; ++dw)
#pragma unroll
        for (int ci = 0; ci < 3; ++ci)
#pragma unroll
          for (int px = 0; px < STRIP; ++px)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int dh = r - j;
              if (dh < 0 || dh > 2) continue;
#pragma unroll
              for (int c = 0; c < 2; ++c)
                acc[j][c][px] = fmaf(xr[(px + dw) * 3 + ci],
                                     w0r[c][(dh * 3 + dw) * 3 + ci],
                                     acc[j][c][px]);
            }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool row_inside = (unsigned)(y0 - 1 + oy + j) < (unsigned)H;
#pragma unroll
      for (int px = 0; px < STRIP; ++px) {
        const bool inside =
            row_inside && (unsigned)(x0 - 1 + ox0 + px) < (unsigned)W;
        store((oy + j) * Y1T + ox0 + px,
              inside ? relu(acc[j][0][px] + b0r[0]) : 0.f,
              inside ? relu(acc[j][1][px] + b0r[1]) : 0.f);
      }
    }
  }
}

// frame and top-left conv1_2 pixel of tile t; tiles run down the columns
// of a frame, so tile t + 1 lies below tile t unless t + 1 starts a column
// (frames, rows and columns fit in 32 bits; only global offsets need 64)
__device__ __forceinline__ void tile_origin(int t, int tiles_y, int tiles_x,
                                            int& f, int& y0, int& x0) {
  const int r = t / tiles_y;
  y0 = (t % tiles_y) * TILE;
  x0 = (r % tiles_x) * TILE;
  f = r / tiles_x;
}

// the block's contiguous share [begin, end) of the ntiles tiles
__device__ __forceinline__ void block_tiles(int ntiles, int& begin,
                                            int& end) {
  begin = (int)((int64_t)blockIdx.x * ntiles / gridDim.x);
  end = (int)((int64_t)(blockIdx.x + 1) * ntiles / gridDim.x);
}

// ---------------------------------------------------------------- f32 path

// conv1_2 + bias + ReLU + pool in f32 on CUDA cores: thread (group, co)
// computes channel co of every GROUPS-th pooled pixel of the 8x8 tile, its
// OIHW weights read through the L1 cache
__device__ void conv1_2_f32(const float* y1s, const float* __restrict__ w2,
                            float b2r, float* __restrict__ out, int f,
                            int py0, int px0, int OH, int OW) {
  const int co = threadIdx.x % C;
  for (int pp = threadIdx.x / C; pp < (TILE / 2) * (TILE / 2);
       pp += GROUPS) {
    const int py = pp / (TILE / 2), px = pp % (TILE / 2);
    const int oy = py0 + py, ox = px0 + px;
    if (oy >= OH || ox >= OW) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int dh = 0; dh < 3; ++dh) {
      for (int dw = 0; dw < 3; ++dw) {
        const float* wk = w2 + co * 9 * C + dh * 3 + dw;
        const float* yk = y1s + ((2 * py + dh) * Y1T + 2 * px + dw) * C;
        for (int ci = 0; ci < C; ++ci) {
          const float w = __ldg(wk + ci * 9);
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
    out[(((int64_t)f * OH + oy) * OW + ox) * C + co] = relu(m + b2r);
  }
}

__global__ void __launch_bounds__(F32_THREADS, 1)
    fused_stem_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w0,
                          const float* __restrict__ b0,
                          const float* __restrict__ w2,
                          const float* __restrict__ b2,
                          float* __restrict__ out, int H, int W,
                          int ntiles, int tiles_y, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* y1s = reinterpret_cast<float*>(smem);
  const uint32_t xs = smem_u32(smem + P1 * C * sizeof(float));
  const int OH = H / 2, OW = W / 2;
  const int lane = threadIdx.x % 32;
  float w0r[2][KW0], b0r[2];
  load_w0(w0, b0, lane, w0r, b0r);
  const float b2r = b2[threadIdx.x % C];
  InputTile<F32_THREADS, float> in;
  auto store = [y1s, lane](int p, float v0, float v1) {
    *reinterpret_cast<float2*>(y1s + p * C + 2 * lane) = make_float2(v0, v1);
  };
  int begin, end;
  block_tiles(ntiles, begin, end);
  for (int t = begin; t < end; ++t) {
    int f, y0, x0;
    tile_origin(t, tiles_y, tiles_x, f, y0, x0);
    in.load(x, threadIdx.x, f, y0, x0, H, W);
    in.store(xs, threadIdx.x);   // xs was last read before the last barrier
    __syncthreads();             // xs ready; every thread is done with y1s
    conv1_1(xs, w0r, b0r, y0, x0, H, W, 0, threadIdx.x / 32, F32_WARPS,
            store);
    __syncthreads();             // y1s ready
    conv1_2_f32(y1s, w2, b2r, out, f, y0 / 2, x0 / 2, OH, OW);
  }
}

// --------------------------------------------------------------- bf16 path

// four 8x8 b16 matrices; lane l gives the row address of matrix l/8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// waits until the barrier's phase of the given parity has completed; each
// try_wait may suspend the thread (up to the hint, in ns) until it has
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity), "r"(10000000u)
        : "memory");
  } while (!done);
}

// the producers' own barrier (id 1; __syncthreads is id 0)
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCER_THREADS) : "memory");
}

// the calling warpgroup's registers per thread become N
template <int N>
__device__ __forceinline__ void set_max_regs() {
  if constexpr (N > LAUNCH_REGS)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
  else if constexpr (N < LAUNCH_REGS)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of v across the asm around it
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// shared-memory matrix descriptor of a K-major operand with the 128-byte
// swizzle: start address, leading offset 1 (unused by this layout), 1024
// bytes between groups of eight 128-byte rows, layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (64x64 f32, this warp's 16 rows) = a (registers, 16x16 bf16 per warp)
// * B (descriptor, 16x64 bf16, K-major) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// byte offset of (pixel p, 16-byte chunk j) in a swizzled y1 buffer
__device__ __forceinline__ uint32_t y1_offset(int p, int j) {
  return p * 128 + ((j ^ (p & 7)) << 4);
}

// shared addresses of the block's buffers: conv1_2's weights (1024-byte
// aligned: the swizzle repeats every 1024 bytes), y1 buffer s at
// y1 + s*Y1_BYTES, input tile k%2 at xs + (k%2)*kXsBytes, and the full and
// empty barriers of y1 buffer s at full + 8s and empty + 8s
struct Smem {
  uint32_t w2s, y1, xs, full, empty;

  __device__ explicit Smem(const unsigned char* raw) {
    w2s = (smem_u32(raw) + 1023) & ~1023u;
    y1 = w2s + 9 * W2_TAP_BYTES;
    xs = y1 + STAGES * Y1_BYTES;
    full = xs + 2 * kXsBytes;
    empty = full + 8 * STAGES;
  }
};

// A fragments of y1 rows r0 .. r0 + MT + 1 (the conv rows of this warp's
// M-tiles and their dh halo) at column offset dw, channels 16cb .. 16cb+15:
// lane l addresses pixel column l%16, chunk 2cb + l/16
__device__ __forceinline__ void load_a(uint32_t (&a)[MT + 2][4], uint32_t y1,
                                       int r0, int lane, int dw, int cb) {
#pragma unroll
  for (int r = 0; r < MT + 2; ++r) {
    const int p = (r0 + r) * Y1T + lane % 16 + dw;
    ldsm_x4(a[r], y1 + y1_offset(p, 2 * cb + lane / 16));
  }
}

// consumer warp w: conv1_2 of conv rows MT*w .. MT*w + MT-1 of each tile
// with wgmma (M-tile i = conv row MT*w + i), then bias, ReLU, pool and the
// store of pooled rows MT/2*w .. MT/2*w + MT/2-1
__device__ __forceinline__ void consumer(const Smem& sm,
                                         const __nv_bfloat16* __restrict__ b2,
                                         __nv_bfloat16* __restrict__ out,
                                         int ntiles, int tiles_y, int tiles_x,
                                         int OH, int OW) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint64_t desc0 = desc_sw128(sm.w2s);
  int begin, end;
  block_tiles(ntiles, begin, end);
  for (int t = begin, k = 0; t < end; ++t, ++k) {
    const int s = k % STAGES;
    mbar_wait(sm.full + 8 * s, (k / STAGES) & 1);
    const uint32_t y1 = sm.y1 + s * Y1_BYTES;
#ifdef DIN_STEM_PRODUCER_ONLY   // diagnostic build, experiments/profile_stem.py
    mbar_arrive(sm.empty + 8 * s);
    continue;
#endif
    float acc[MT][32];
    uint32_t a[2][MT + 2][4];
    load_a(a[0], y1, MT * warp, lane, 0, 0);
#pragma unroll
    for (int it = 0; it < 12; ++it) {        // (dw, 16-channel block)
      const int dw = it / 4, cb = it % 4;
      wgmma_fence();
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const uint64_t desc =
            desc0 + (((dh * 3 + dw) * W2_TAP_BYTES + cb * 32) >> 4);
        const int scale = (it > 0 || dh > 0) ? 1 : 0;   // 0: d = a*b
#pragma unroll
        for (int i = 0; i < MT; ++i)
          wgmma_m64n64k16(acc[i], a[it % 2][i + dh], desc, scale);
      }
      wgmma_commit();
      if (it + 1 < 12) {
        wgmma_wait<1>();                     // frees a[(it + 1) % 2]
        load_a(a[(it + 1) % 2], y1, MT * warp, lane, (it + 1) / 4,
               (it + 1) % 4);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 32; ++j) fence_operand(acc[i][j]);
    mbar_arrive(sm.empty + 8 * s);

    // accumulator (i, 4n + j): conv row MT*w + i, pixel column
    // g + 8*(j/2), channel 8n + 2*t4 + j%2
    int f, y0, x0;
    tile_origin(t, tiles_y, tiles_x, f, y0, x0);
#pragma unroll
    for (int pr = 0; pr < MT / 2; ++pr) {
      const int oy = y0 / 2 + (MT / 2) * warp + pr;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float m[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m[j] = din_nan_max(acc[2 * pr][4 * n + j],
                             acc[2 * pr + 1][4 * n + j]);
          m[j] = din_nan_max(m[j], __shfl_xor_sync(0xffffffffu, m[j], 4));
        }
        if (g % 2 == 0 && oy < OH) {
          const float bias0 = din_to_f32(b2[8 * n + 2 * t4]);
          const float bias1 = din_to_f32(b2[8 * n + 2 * t4 + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ox = x0 / 2 + g / 2 + 4 * h;
            if (ox < OW)
              *reinterpret_cast<__nv_bfloat162*>(
                  out + (((int64_t)f * OH + oy) * OW + ox) * C + 8 * n +
                  2 * t4) =
                  __floats2bfloat162_rn(relu(m[2 * h] + bias0),
                                        relu(m[2 * h + 1] + bias1));
          }
        }
      }
    }
  }
}

// producer warps: each tile's input, then its y1 into the ring.  A tile
// below the previous one takes that one's last two y1 rows as its first
// two (the buffers' swizzle repeats every 8 pixels, and the two rows lie
// 16 * 18 = 288 pixels apart) and computes only its 16 new rows.
__device__ __forceinline__ void producer(const Smem& sm,
                                         const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ w0,
                                         const __nv_bfloat16* __restrict__ b0,
                                         int H, int W, int ntiles,
                                         int tiles_y, int tiles_x) {
  const int pt = threadIdx.x - CONSUMER_THREADS;
  const int pwarp = pt / 32, lane = pt % 32;
  float w0r[2][KW0], b0r[2];
  load_w0(w0, b0, lane, w0r, b0r);
  int begin, end;
  block_tiles(ntiles, begin, end);
  // the next tile's input is loaded into registers after this tile's
  // empty-wait: a barrier waits for loads in flight, and conv1_1 now lies
  // between the loads and the next barrier
  InputTile<PRODUCER_THREADS, __nv_bfloat16> in;
  int f, y0, x0;
  tile_origin(begin, tiles_y, tiles_x, f, y0, x0);
  in.load(x, pt, f, y0, x0, H, W);
  for (int t = begin, k = 0; t < end; ++t, ++k) {
    // input tile k % 2 was last read by conv1_1 two tiles ago, before
    // every producer reached the previous producers_sync
    const uint32_t xs = sm.xs + (k % 2) * kXsBytes;
    in.store(xs, pt);
    producers_sync();   // xs ready; the previous tile's y1 complete
    const int ty0 = y0, tx0 = x0;
    const int s = k % STAGES;
    mbar_wait(sm.empty + 8 * s, ((k / STAGES) & 1) ^ 1);
    if (t + 1 < end) {
      tile_origin(t + 1, tiles_y, tiles_x, f, y0, x0);
      in.load(x, pt, f, y0, x0, H, W);
    }
    const uint32_t y1 = sm.y1 + s * Y1_BYTES;
#ifdef DIN_STEM_CONSUMER_ONLY   // diagnostic build, experiments/profile_stem.py
    mbar_arrive(sm.full + 8 * s);
    continue;
#endif
    const bool below = t > begin && t % tiles_y != 0;
    if (below) {
      const uint32_t src = sm.y1 + ((k + STAGES - 1) % STAGES) * Y1_BYTES +
                           16 * Y1T * 128;
      for (int i = pt; i < 2 * Y1T * 128 / 16; i += PRODUCER_THREADS)
        sts_v4(y1 + 16 * i, lds128(src + 16 * i));
    }
    const uint32_t y1_lane = y1 + (lane % 4) * 4;
    conv1_1(xs, w0r, b0r, ty0, tx0, H, W, below ? 2 : 0, pwarp,
            PRODUCER_WARPS, [y1_lane, lane](int p, float v0, float v1) {
              const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
              sts_b32(y1_lane + y1_offset(p, lane / 4),
                      *reinterpret_cast<const uint32_t*>(&v));
            });
    mbar_arrive(sm.full + 8 * s);
  }
}

__global__ void __launch_bounds__(BF16_THREADS, 1)
    fused_stem_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w0,
                           const __nv_bfloat16* __restrict__ b0,
                           const __nv_bfloat16* __restrict__ w2,
                           const __nv_bfloat16* __restrict__ b2,
                           __nv_bfloat16* __restrict__ out, int H, int W,
                           int ntiles, int tiles_y, int tiles_x) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem sm(smem_raw);
  // conv1_2's weights, once per block, into the swizzled K-major tiles;
  // source element i = (o*64 + ci)*9 + tap of OIHW w2
  for (int i = threadIdx.x; i < C * C * 9; i += BF16_THREADS) {
    const int tap = i % 9, ci = (i / 9) % C, o = i / (9 * C);
    sts_b16(sm.w2s + tap * W2_TAP_BYTES + o * 128 +
                (((ci / 8) ^ (o % 8)) << 4) + (ci % 8) * 2,
            __bfloat16_as_ushort(w2[i]));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full + 8 * s, PRODUCER_THREADS);
      mbar_init(sm.empty + 8 * s, CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the weights were written through the generic proxy; wgmma reads them
  // through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x < CONSUMER_THREADS) {
    set_max_regs<CONSUMER_REGS>();
    consumer(sm, b2, out, ntiles, tiles_y, tiles_x, H / 2, W / 2);
  } else {
    set_max_regs<PRODUCER_REGS>();
    producer(sm, x, w0, b0, H, W, ntiles, tiles_y, tiles_x);
  }
}

// persistent grid: as many blocks as fit on the SMs, at most one per tile;
// regs > 0 requires ptxas to have given the kernel exactly that many
// registers a thread, as set_max_regs assumes (a role asking for more
// registers than the other gave back would wait forever)
template <typename Kern>
cudaError_t persistent_grid(Kern kern, int threads, size_t smem, int regs,
                            int64_t ntiles, unsigned& blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess) return e;
  if (regs && attr.numRegs != regs) return cudaErrorInvalidConfiguration;
  const int64_t n = (int64_t)sms * per_sm;
  blocks = (unsigned)(n < ntiles ? n : ntiles);
  return cudaSuccess;
}

}  // namespace

extern "C" int din_fused_stem(const void* x, const void* w0, const void* b0,
                              const void* w2, const void* b2, void* out,
                              int64_t F, int64_t H, int64_t W, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles_y = (H / 2 + TILE / 2 - 1) / (TILE / 2);
  const int64_t tiles_x = (W / 2 + TILE / 2 - 1) / (TILE / 2);
  const int64_t ntiles = F * tiles_y * tiles_x;
  if (ntiles == 0) return (int)cudaSuccess;
  // tile indices, rows and columns in 32 bits (offsets stay 64-bit)
  if (ntiles > INT32_MAX || F * H > INT32_MAX || W > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  unsigned blocks = 0;
  cudaError_t e;
  if (dtype == DIN_F32) {
    if ((e = persistent_grid(fused_stem_f32_kernel, F32_THREADS, kSmemF32, 0,
                             ntiles, blocks)) != cudaSuccess)
      return (int)e;
    fused_stem_f32_kernel<<<blocks, F32_THREADS, kSmemF32, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w0),
        static_cast<const float*>(b0), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), (int)H,
        (int)W, (int)ntiles, (int)tiles_y, (int)tiles_x);
  } else if (dtype == DIN_BF16) {
    if ((e = persistent_grid(fused_stem_bf16_kernel, BF16_THREADS, kSmemBf16,
                             LAUNCH_REGS, ntiles, blocks)) != cudaSuccess)
      return (int)e;
    using bf = __nv_bfloat16;
    fused_stem_bf16_kernel<<<blocks, BF16_THREADS, kSmemBf16, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(w0),
        static_cast<const bf*>(b0), static_cast<const bf*>(w2),
        static_cast<const bf*>(b2), static_cast<bf*>(out), (int)H, (int)W,
        (int)ntiles, (int)tiles_y, (int)tiles_x);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
