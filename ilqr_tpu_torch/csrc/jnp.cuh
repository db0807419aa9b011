// The JAX package's NaN-propagating elementwise max/min/clip, per lane.
#pragma once

namespace jnp {

// jnp.maximum / jnp.minimum: a NaN in either operand propagates
// (fmaxf/fminf would drop it).
__device__ __forceinline__ float maximum(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float minimum(float a, float b) {
  return (a < b || a != a) ? a : b;
}
// jnp.clip(v, lo, hi) = minimum(maximum(v, lo), hi)
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return minimum(maximum(v, lo), hi);
}

}  // namespace jnp
