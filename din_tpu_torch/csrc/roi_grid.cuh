// The RoIAlign sample grid, shared by K1 (roi_align.cu) and K1b
// (roi_align_bwd.cu), so that the two kernels cannot drift apart at the map
// border: a centre rounded differently flips a sample's in-range test.
//
// Both follow the plain version (din_tpu_torch/ops/roi_align.py
// _sample_grid and _corner_weights) op by op, each op rounded once
// (__fsub_rn, __fdiv_rn, __fmul_rn, __fadd_rn): nvcc would otherwise
// contract a*b+c into an FMA and move some centres by one ulp
// (tests/test_torch_roi_grid.py pins the order).
#pragma once

#include "common.cuh"

// sample centre i of a box side from lo to hi with k bins, rounded op by op
// as _sample_grid computes it: lo + (i + 0.5) * ((hi - lo) / k) - 0.5
__device__ __forceinline__ float din_roi_sample_centre(float lo, float hi,
                                                       int k, int i) {
  const float bin = __fdiv_rn(__fsub_rn(hi, lo), (float)k);
  const float off = __fmul_rn(__fadd_rn((float)i, 0.5f), bin);
  return __fsub_rn(__fadd_rn(lo, off), 0.5f);
}

// One axis of a sample: the in-range test on [0, cmax] (a sample outside is
// 0 as a whole), then the floor/ceil corners of the clamped coordinate and
// their lerp weights, as _corner_weights computes them.
struct DinRoiAxis {
  int lo, hi;
  float w_lo, w_hi;
  bool ok;
};

__device__ __forceinline__ DinRoiAxis din_roi_axis(float c, float cmax) {
  DinRoiAxis a;
  a.ok = (c >= 0.0f) && (c <= cmax);
  const float cc = fminf(fmaxf(c, 0.0f), cmax);
  const float lo = floorf(cc);
  const float hi = ceilf(cc);
  a.w_hi = __fsub_rn(cc, lo);
  a.w_lo = __fsub_rn(1.0f, a.w_hi);
  a.lo = (int)lo;
  a.hi = (int)hi;
  return a;
}
