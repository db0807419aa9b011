// Forward-mode dual numbers for the model device functions (counterpart of
// the jax.jvp / JVP-of-JVP calls of ilqr_tpu/ops/pallas_derivs.py).
//
// Dual<T>{v, d} carries a value and one directional derivative. With
// T = float it gives first derivatives; with T = Dual<float> (a dual whose
// parts are duals) it gives the mixed second derivative of two directions:
// the outer layer carries the first direction, the inner layer the second,
// exactly as JAX nests jvp(jvp(f, ti), tj). Each rule is JAX's jvp rule in
// JAX's operation order, so with --fmad=false every value is the IEEE f32
// result the plain version (ops/kernel_derivs.Dual) computes op by op:
//
//   a·b  → a.d·b.v + a.v·b.d            (mul)
//   c/a  → ((−a.d)·c)·(1/(a.v·a.v))     (div by a dual, constant numerator)
//   a/b  → a.d/b.v + ((−b.d)·a.v)·(1/(b.v·b.v))
//   a/c  → a.d/c                        (div by a constant)
//   sin  → a.d·cos(a.v);  cos → −(a.d·sin(a.v))
//   tan  → a.d·(1 + t·t), t = tan(a.v)  (jax/_src/lax/lax.py tan_p)
//   abs  → a.v ≥ 0 ? a.d : −a.d         (lax.py _abs_jvp_rule; the test
//                                        reads the innermost primal)
//
// A float operand is a constant: it carries no derivative term. The model
// headers call sin_of/cos_of/sincos_of/tan_of/abs_of, whose float
// overloads are the full-accuracy sinf/cosf/sincosf/tanf and fabsf, so a
// model function templated on the scalar computes with S = float exactly
// the operations it computed before templating.
#pragma once

namespace dual {

template <class T>
struct Dual {
  T v, d;
};

template <class T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a,
                                             const Dual<T>& b) {
  return {a.v + b.v, a.d + b.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a,
                                             const Dual<T>& b) {
  return {a.v - b.v, a.d - b.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a,
                                             const Dual<T>& b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a,
                                             const Dual<T>& b) {
  return {a.v / b.v, a.d / b.v + ((-b.d) * a.v) * (1.0f / (b.v * b.v))};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a) {
  return {-a.v, -a.d};
}

// with a constant
template <class T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a, float c) {
  return {a.v + c, a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator+(float c, const Dual<T>& a) {
  return {c + a.v, a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, float c) {
  return {a.v - c, a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(float c, const Dual<T>& a) {
  return {c - a.v, -a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, float c) {
  return {a.v * c, a.d * c};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(float c, const Dual<T>& a) {
  return {c * a.v, c * a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(float c, const Dual<T>& a) {
  return {c / a.v, ((-a.d) * c) * (1.0f / (a.v * a.v))};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, float c) {
  return {a.v / c, a.d / c};
}

// The value a chain of duals is taken at
__device__ __forceinline__ float primal(float x) { return x; }
template <class T>
__device__ __forceinline__ float primal(const Dual<T>& x) {
  return primal(x.v);
}

// sin and cos of one angle; float is the full-accuracy sincosf
__device__ __forceinline__ void sincos_of(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ float sin_of(float x) { return sinf(x); }
__device__ __forceinline__ float cos_of(float x) { return cosf(x); }
__device__ __forceinline__ float tan_of(float x) { return tanf(x); }
__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
template <class T>
__device__ __forceinline__ Dual<T> cos_of(const Dual<T>& x);
template <class T>
__device__ __forceinline__ Dual<T> sin_of(const Dual<T>& x) {
  return {sin_of(x.v), x.d * cos_of(x.v)};
}
template <class T>
__device__ __forceinline__ Dual<T> cos_of(const Dual<T>& x) {
  return {cos_of(x.v), -(x.d * sin_of(x.v))};
}
template <class T>
__device__ __forceinline__ Dual<T> tan_of(const Dual<T>& x) {
  const T t = tan_of(x.v);
  return {t, x.d * (1.0f + t * t)};
}
template <class T>
__device__ __forceinline__ Dual<T> abs_of(const Dual<T>& x) {
  return {abs_of(x.v), primal(x.v) >= 0.0f ? x.d : -x.d};
}
template <class T>
__device__ __forceinline__ void sincos_of(const Dual<T>& x, Dual<T>* s,
                                          Dual<T>* c) {
  T sv, cv;
  sincos_of(x.v, &sv, &cv);
  *s = {sv, x.d * cv};
  *c = {cv, -(x.d * sv)};
}

}  // namespace dual
