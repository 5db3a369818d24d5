// K1b: RoIAlign backward, d(features) from d(crops).
//
// Not a port of a Pallas kernel: din_tpu computes this gradient with XLA
// einsums (din_tpu/ops/roi_align.py _pallas_bwd for impl='pallas', autodiff
// of _roi_align_onehot on the default path).  The port writes it as a kernel
// because a CUDA tensor must launch a kernel or raise.
//
// Inputs: g [B,N,KH,KW,C] (f32 or bf16, contiguous), boxes [B,N,4] (x1, y1,
// x2, y2, f32) and the output df [B,H,W,C] in g's dtype, which the kernel
// writes whole, zeros included: no scratch map, no cast pass.  Each sample
// in range adds w*g to its four corner rows, with the weights K1 blends
// with; corners that coincide (an integer coordinate, or a clamp at the
// border) each add their own weight, as the one-hot sum does.  A sample
// outside the map adds nothing.  The kernel computes the sample centres
// from the boxes with the helpers it shares with K1 (roi_grid.cuh).
//
// Order.  The plain version (roi_align_bwd_ref) adds, with index_add_ into
// an f32 map, corner 00 of every sample in (frame, box, i, j) order, then
// corner 01, 10 and 11, and casts the map at the end.  Here every output
// element is owned by one thread, which adds its contributions in exactly
// that order, each product and sum rounded on its own (__fmul_rn,
// __fadd_rn), and rounds once to the output's dtype.  So the kernel is
// deterministic and equals the plain version run on the CPU bit for bit.
//
// Bound: bytes, and tiny at the flagship (g 6.1 MB in bf16, df 18 MB, a few
// microseconds at the HBM rate): the launch and the latency of a block's
// dependent steps are the real floor, and a band where many samples meet
// (players side by side) is the tail.  Design: one block per (frame, band
// of kRows rows, slice of 8*lanes channels); 8 channels a thread (one
// 16-byte load of bf16), so the few threads of a pixel each take many
// channels.  A block
//   1. computes the frame's sample grid into shared memory: the corners and
//      weights of each (box, i) and (box, j), the centres with the helpers
//      it shares with K1 (roi_grid.cuh);
//   2. walks the frame's 4*N*KH*KW contributions in the plain version's
//      order, kPer a thread, keeps those whose corner row lies in its band
//      and compacts them in order (a prefix sum of the hits);
//   3. sorts that list stably by pixel in one warp (per-pixel counts, then
//      each entry to its pixel's next slot, its rank among equal pixels by
//      __match_any_sync), the pixels of each of kGroups groups together;
//   4. in each group (the pixels p with p % kGroups equal), each thread sums
//      its 8 channels of one pixel at a time in registers, walking the
//      group's part of the sorted list UNROLL entries at a time so that
//      their g reads are in flight together, and writes a pixel when the
//      list moves past it; pixels with no entry are written 0.
// So a hot band's entries split over kGroups thread groups; each output
// element is still summed by one thread in the plain version's order.
// The constants below were the fastest at the flagship on an H100 among
// development builds of 1-4 rows, 1-8 groups and 8-32 reads in flight.
#include "roi_grid.cuh"

namespace {

constexpr int kRows = 1;     // rows of a band
constexpr int kGroups = 4;   // pixel groups of a block
constexpr int kLanes = 128;  // at most this many threads in a group
constexpr int kPer = 4;      // contributions a thread tests per round
constexpr int kMaxWarps = kGroups * kLanes / 32;

// VEC consecutive channels of g as loaded (one 16-byte load for 8 bf16, two
// for 8 f32), converted to f32 where they are used
template <typename T, int VEC>
struct Raw;

template <>
struct Raw<__nv_bfloat16, 8> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float get(int i) const {
    const unsigned w = i < 2 ? u.x : i < 4 ? u.y : i < 6 ? u.z : u.w;
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Raw<float, 8> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float get(int i) const {
    const float4& h = i < 4 ? a : b;
    const int j = i & 3;
    return j == 0 ? h.x : j == 1 ? h.y : j == 2 ? h.z : h.w;
  }
};

template <typename T>
struct Raw<T, 1> {
  T x;
  __device__ __forceinline__ void load(const T* p) { x = p[0]; }
  __device__ __forceinline__ float get(int) const { return din_to_f32(x); }
};

// writes VEC f32 sums in the output's dtype (round to nearest even)
template <int VEC>
__device__ __forceinline__ void store_sums(float* p, const float* v) {
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    p[0] = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_sums(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 8) {
    uint4 u;
    unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    p[0] = __float2bfloat16(v[0]);
  }
}

template <typename T, int VEC, int UNROLL, int G>
__global__ void roi_align_bwd_kernel(const T* __restrict__ g,
                                     const float* __restrict__ boxes,
                                     T* __restrict__ df, int H, int W, int C,
                                     int N, int KH, int KW, int R) {
  extern __shared__ int smem[];
  const int threads = blockDim.x;
  const int lanes = threads / G;  // threads of one pixel group
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, warps = threads >> 5;
  const int group = t / lanes;
  const int c = (blockIdx.x * lanes + t - group * lanes) * VEC;
  const bool own = c < C;  // C is a multiple of VEC
  const int r0 = blockIdx.y * R;
  const int64_t b = blockIdx.z;
  const int npix = min(R, H - r0) * W;
  const int M = (npix + G - 1) / G;  // pixels of a group
  const int S = N * KH * KW;
  const int Q = 4 * S;

  // the frame's grid: per (box, i) and (box, j) the corners (-1 where the
  // coordinate is out of range) and weights; per sample its two entries
  int4* ytab = reinterpret_cast<int4*>(smem);  // [N*KH]
  int4* xtab = ytab + N * KH;                  // [N*KW]
  int2* stab = reinterpret_cast<int2*>(xtab + N * KW);  // [S]
  // the band's contributions: in the plain version's order, then sorted
  // stably by pixel, the pixels of group 0 (p % G == 0) first; an entry is
  // the pixel (low 16 bits) and the sample (high 16 bits), and its weight
  int* l_ps = reinterpret_cast<int*>(stab + S);  // [Q]
  float* l_w = reinterpret_cast<float*>(l_ps + Q);
  int* s_ps = reinterpret_cast<int*>(l_w + Q);
  float* s_w = reinterpret_cast<float*>(s_ps + Q);
  int* cursor = reinterpret_cast<int*>(s_w + Q);  // [G*M] per-pixel counts
  int* gstart = cursor + G * M;                  // [G+1] each group's range
  int* wcount = gstart + G + 1;                  // [kMaxWarps]

  const float* fb = boxes + b * N * 4;
  for (int u = t; u < N * (KH + KW); u += threads) {
    const bool is_y = u < N * KH;
    const int k = is_y ? KH : KW;
    const int v = is_y ? u : u - N * KH;
    const int n = v / k;
    const float* bx = fb + n * 4 + (is_y ? 1 : 0);  // (y1, y2) or (x1, x2)
    const DinRoiAxis a = din_roi_axis(
        din_roi_sample_centre(bx[0], bx[2], k, v - n * k),
        (float)((is_y ? H : W) - 1));
    (is_y ? ytab : xtab)[v] =
        make_int4(a.ok ? a.lo : -1, a.ok ? a.hi : -1, __float_as_int(a.w_lo),
                  __float_as_int(a.w_hi));
  }
  for (int s = t; s < S; s += threads) {
    const int n = s / (KH * KW);
    const int ij = s - n * (KH * KW);
    const int i = ij / KW;
    stab[s] = make_int2(n * KH + i, n * KW + ij - i * KW);
  }
  for (int p = t; p < G * M; p += threads) cursor[p] = 0;
  __syncthreads();

  // 1. the band's contributions in the plain version's order q, kPer
  // consecutive ones a thread, compacted in order (a prefix sum of the hits)
  int count = 0;  // the same in every thread
  for (int q0 = 0; q0 < Q; q0 += threads * kPer) {
    // contribution q: corner k (0: y0 x0, 1: y0 x1, 2: y1 x0, 3: y1 x1) of
    // sample s = (box n, i, j)
    int ps[kPer];
    float ws[kPer];
    int hits = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = q0 + kPer * t + u;
      ps[u] = -1;
      if (q < Q) {
        const int k = (q >= S) + (q >= 2 * S) + (q >= 3 * S);
        const int s = q - k * S;
        const int2 yx = stab[s];
        const int4 ay = ytab[yx.x];
        const int4 ax = xtab[yx.y];
        const int yy = (k & 2) ? ay.y : ay.x;
        const int xx = (k & 1) ? ax.y : ax.x;
        if (xx >= 0 && yy >= r0 && yy < r0 + R) {
          const int p = (yy - r0) * W + xx;
          ps[u] = p | (s << 16);
          ws[u] = __fmul_rn(__int_as_float((k & 2) ? ay.w : ay.z),
                            __int_as_float((k & 1) ? ax.w : ax.z));
          atomicAdd(cursor + (p % G) * M + p / G, 1);  // a count: any order
          ++hits;
        }
      }
    }
    int incl = hits;  // inclusive prefix sum over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) wcount[warp] = incl;
    __syncthreads();
    int at = count + incl - hits;
    for (int v = 0; v < warps; ++v) {
      at += (v < warp) ? wcount[v] : 0;
      count += wcount[v];
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (ps[u] >= 0) {
        l_ps[at] = ps[u];
        l_w[at] = ws[u];
        ++at;
      }
    }
    __syncthreads();  // wcount is written again by the next round
  }

  // 2. one warp sorts the list by pixel, stably: the per-pixel counts become
  // start offsets, then each entry in list order goes to its pixel's next
  // slot (its rank among the equal pixels of its 32, by __match_any_sync)
  if (warp == 0) {
    int carry = 0;
    for (int k0 = 0; k0 < G * M; k0 += 32) {
      const int k = k0 + lane;
      const int n = k < G * M ? cursor[k] : 0;
      int incl = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      if (k < G * M) {
        cursor[k] = carry + incl - n;
        if (k % M == 0) gstart[k / M] = carry + incl - n;
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) gstart[G] = count;
    __syncwarp();
    for (int e0 = 0; e0 < count; e0 += 32) {
      const int e = e0 + lane;
      const int ps = e < count ? l_ps[e] : -1 - lane;  // unique when unused
      const int p = ps & 0xffff;
      const int key = (p % G) * M + p / G;
      const unsigned same = __match_any_sync(0xffffffffu, e < count ? key : ps);
      if (e < count) {
        const int at = cursor[key] + __popc(same & ((1u << lane) - 1u));
        s_ps[at] = ps;
        s_w[at] = l_w[e];
      }
      __syncwarp();
      if (e < count && (same >> lane) == 1u)  // the last lane of its pixel
        cursor[key] += __popc(same);
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. each thread sums its VEC channels of one pixel of its group at a time
  // in registers, walking the group's part of the sorted list UNROLL entries
  // at a time (their g reads in flight at once), and writes a pixel when the
  // list moves past it; pixels with no entry are written 0
  if (!own) return;
  T* out = df + ((b * H + r0) * W) * C + c;
  const T* gc = g + b * S * C + c;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  int cur = group;  // the pixel being summed; the group's before it are written
  const int end = gstart[group + 1];
  for (int e0 = gstart[group]; e0 < end; e0 += UNROLL) {
    Raw<T, VEC> gv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (e0 + u < end) gv[u].load(gc + (s_ps[e0 + u] >> 16) * C);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (e0 + u < end) {
        const int p = s_ps[e0 + u] & 0xffff;
        for (; cur < p; cur += G) {
          store_sums<VEC>(out + (int64_t)cur * C, acc);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
        }
        const float w = s_w[e0 + u];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v] = __fadd_rn(acc[v], __fmul_rn(gv[u].get(v), w));
      }
    }
  }
  for (; cur < npix; cur += G) {
    store_sums<VEC>(out + (int64_t)cur * C, acc);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  }
}

constexpr int64_t kMaxSmem = 227 * 1024;

template <typename T, int VEC, int UNROLL>
int launch_vec(const void* g, const float* boxes, void* df, int64_t B,
               int64_t H, int64_t W, int64_t C, int64_t N, int64_t KH,
               int64_t KW, cudaStream_t stream) {
  const int64_t need = (C / VEC + 31) / 32 * 32;
  const int64_t lanes = need < kLanes ? need : kLanes;
  const int64_t slices = (C / VEC + lanes - 1) / lanes;
  const int64_t R = H < kRows ? H : kRows;
  const int64_t G = kGroups;
  const int64_t bands = (H + R - 1) / R;
  const int64_t S = N * KH * KW;
  const int64_t M = (R * W + G - 1) / G;
  const int64_t smem = N * (KH + KW) * 16 + S * 8 + 4 * S * 16 +
                       (G * M + G + 1 + kMaxWarps) * 4;
  // an entry packs the pixel in the band and the sample into 16 bits each
  if (smem > kMaxSmem || B > 65535 || bands > 65535 || R * W > 0xffff ||
      S > 0x7fff || S * C > 0x7fffffff ||
      C > 0x7fffffff || G * lanes > 1024)
    return (int)cudaErrorInvalidValue;
  auto kernel = roi_align_bwd_kernel<T, VEC, UNROLL, kGroups>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3((unsigned)slices, (unsigned)bands, (unsigned)B),
           (unsigned)(G * lanes), (size_t)smem, stream>>>(
      static_cast<const T*>(g), boxes, static_cast<T*>(df), (int)H,
      (int)W, (int)C, (int)N, (int)KH, (int)KW, (int)R);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* g, const float* boxes, void* df, int64_t B, int64_t H,
           int64_t W, int64_t C, int64_t N, int64_t KH, int64_t KW,
           cudaStream_t stream) {
  // N*KH*KW == 0 leaves the map 0, which the kernel writes all the same
  if (B * H * W * C == 0) return 0;
  // 8 channels a thread where every row is 16-byte aligned, else 1
  const bool aligned = C % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(df) % 16 == 0;
  if (aligned)
    return launch_vec<T, 8, sizeof(T) == 2 ? 16 : 8>(g, boxes, df, B, H, W,
                                                     C, N, KH, KW, stream);
  return launch_vec<T, 1, 16>(g, boxes, df, B, H, W, C, N, KH, KW, stream);
}

}  // namespace

extern "C" int din_roi_align_bwd(const void* g, const void* boxes, void* df,
                                 int64_t B, int64_t H, int64_t W, int64_t C,
                                 int64_t N, int64_t KH, int64_t KW, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  if (dtype == DIN_F32)
    return launch<float>(g, bx, df, B, H, W, C, N, KH, KW, s);
  if (dtype == DIN_BF16)
    return launch<__nv_bfloat16>(g, bx, df, B, H, W, C, N, KH, KW, s);
  return (int)cudaErrorInvalidValue;
}
