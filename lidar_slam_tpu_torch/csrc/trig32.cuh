// core/trig32.sincos32 on the device, shared by K3 (scan_match.cu) and K5
// (scan_intake.cu).
//
// The same Cody-Waite reduction and cephes polynomials as core/trig32.py,
// operation by operation in float32; the build passes --fmad=false, so no
// multiply and add are contracted into an FMA and every result is the
// plain version's bit for bit.

#pragma once

#include <cmath>

namespace {

// core/trig32's constants, the exact float32 values
constexpr float TWO_OVER_PI = 0x1.45f306p-1f;
constexpr float PIO2_H1 = 0x1.92p+0f;
constexpr float PIO2_H2 = 0x1.fb4p-12f;
constexpr float PIO2_H3 = 0x1.4442dp-24f;
constexpr float S1 = -0x1.555546p-3f;
constexpr float S2 = 0x1.11073cp-7f;
constexpr float S3 = -0x1.9943f2p-13f;
constexpr float C1 = 0x1.55554ap-5f;
constexpr float C2 = -0x1.6c0c34p-10f;
constexpr float C3 = 0x1.99eb9cp-16f;

// gridmap.roundf_like: trunc(x + sign(x) * 0.5), torch.sign(0) = 0
__device__ __forceinline__ float roundf_like(float x) {
  const float s = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return truncf(x + s * 0.5f);
}

// trig32.sincos32, operation by operation
__device__ void sincos32(float x, float* sin_out, float* cos_out) {
  const float t = x * TWO_OVER_PI;
  const float k = roundf_like(t);
  const float r = ((x - k * PIO2_H1) - k * PIO2_H2) - k * PIO2_H3;
  const float r2 = r * r;
  const float sp = (r2 * S3 + S2) * r2 + S1;
  const float sinr = (sp * r2) * r + r;
  const float cp = (r2 * C3 + C2) * r2 + C1;
  const float cosr = (cp * r2) * r2 + (1.0f - r2 * 0.5f);
  int q = static_cast<int>(k) % 4;   // torch.remainder: a floor-mod
  if (q < 0) q += 4;
  *sin_out = q == 0 ? sinr : (q == 1 ? cosr : (q == 2 ? -sinr : -cosr));
  *cos_out = q == 0 ? cosr : (q == 1 ? -sinr : (q == 2 ? -cosr : sinr));
}

}  // namespace
