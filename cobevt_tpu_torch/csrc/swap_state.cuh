// The (B, L, H, W, D) state of the FuseBEVT encoder as K4
// (fused_swap_fusion.cu) and K6 (fused_swap_fusion_streaming.cu) address
// it: the sublayer's dimensions, and the map from the window-major token
// order to the state, so window and grid cells are read and written by
// index math and no factor-swap copy exists.
#pragma once

namespace swap_state {

struct Dims {
  int B, L, H, W, D, w, heads, mlp, grid;
};

// element offset in the (B, L, H, W, D) state of row rr of the window-major
// token order: window g = rr / T (b, wx, wy), token (l, p, s) of the window
__device__ __forceinline__ long long state_offset(const Dims& d,
                                                  long long rr) {
  const int X = d.H / d.w, Y = d.W / d.w;
  const int w2 = d.w * d.w;
  const int T = d.L * w2;
  const long long g = rr / T;
  const int j = (int)(rr - g * T);
  const int b = (int)(g / (X * Y));
  const int wi = (int)(g - (long long)b * X * Y);
  const int wx = wi / Y, wy = wi - (wi / Y) * Y;
  const int l = j / w2;
  const int p = (j - l * w2) / d.w;
  const int s = j - l * w2 - p * d.w;
  const int y = d.grid ? p * X + wx : wx * d.w + p;
  const int x = d.grid ? s * Y + wy : wy * d.w + s;
  return (((long long)(b * d.L + l) * d.H + y) * d.W + x) * d.D;
}

inline Dims make_dims(const int* v) {
  Dims d;
  d.B = v[0];
  d.L = v[1];
  d.H = v[2];
  d.W = v[3];
  d.D = v[4];
  d.w = v[5];
  d.heads = v[6];
  d.mlp = v[7];
  d.grid = v[8];
  return d;
}

inline bool dims_ok(const Dims& d) {
  return d.B > 0 && d.L > 0 && d.w > 0 && d.H % d.w == 0 && d.W % d.w == 0 &&
         d.D % 16 == 0 && d.mlp % 16 == 0 && d.heads > 0 &&
         d.D % d.heads == 0;
}

}  // namespace swap_state
