// K1's dequantization of packed Q4 nibbles into bf16 MMA operands, shared by
// its decode GEMV (q4_matmul.cu) and its GEMM (q4_gemm.cuh), so that the two
// form every weight of every mode the same way, bit for bit.
//
// A byte permute puts one column's bytes of two packed rows into a word; a
// mask and an xor make each nibble the bf16 136 + q (0x4300 | (q ^ 8)); an
// exact bf16 subtract gives q. A bf16 scale (and LLAMAVK_Q4_MUL=bf16's
// rounded f32 scale) multiplies with `__hmul2`: the product of the exact q
// by a bf16 scale is exact in f32, so the one rounding of the bf16 multiply
// is bf16(f32(q) * s), the plain version's weight. An f32 scale multiplies
// q (made an f32 by shifting its bf16 bits) in f32 and rounds once to bf16.
// The helpers take the kernel's instruction choices as a flag, the same
// bits either way: the GEMV's (GEMM = false) hold no conversion instruction
// (roundings by integer operations, `rne_hi`; the mask and xor in one LOP3
// of inline PTX); the GEMM's round by F2FP and leave the mask and xor to
// the compiler, which measured faster there (PERF.md §6).
// LLAMAVK_Q4_DOT=f32 feeds the f32 w = q * s as NP bf16 parts w0 + w1
// (+ w2), one MMA pass each into the same f32 accumulators: each x * part
// product is exact in f32. q has <= 4 significant bits and a bf16 scale 8,
// so two parts hold w exactly (the second one `__hfma2(q, s, -w0)`, exact
// in bf16); an f32 scale's 24 bits take a third part, which leaves at most
// 2^-27 |w| out.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace q4dq {

constexpr uint32_t MAGIC2 = 0x43084308u;  // two bf16 136.0 (0x4300 | 8)

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, 4);
  return v;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// x rounded to bf16, to nearest even, by integer operations (finite x): the
// bf16 bits in the high half of the result, the low half not zeroed
__device__ __forceinline__ uint32_t rne_hi(float x) {
  const uint32_t u = __float_as_uint(x);
  return u + 0x7fffu + ((u >> 16) & 1u);
}

// the high halves of a and b as one word, a's in the low half
__device__ __forceinline__ uint32_t high_halves(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// the __byte_perm selector of byte c (0-3) of two packed words a and b: a's
// in bytes 0 and 2 of the result, b's in 1 and 3
__device__ __forceinline__ uint32_t pair_sel(int c) {
  return c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12);
}

// (v & 0x000f000f) ^ MAGIC2: as the compiler picks (GEMM), or in one LOP3
// by inline PTX (the compiler emits two: a LOP3 takes one immediate, so the
// magic goes in as a register)
template <bool GEMM>
__device__ __forceinline__ uint32_t nibbles_to_magic(uint32_t v) {
  if constexpr (GEMM) return (v & 0x000f000fu) ^ MAGIC2;
  uint32_t d;
  asm("lop3.b32 %0, %1, 0x000f000f, %2, 0x6a;\n" : "=r"(d) : "r"(v), "r"(MAGIC2));
  return d;
}

// The magic pairs of byte c (0-3) of two packed words a and b: `lo` holds
// the low nibbles (a's in the low half), `hi` the high nibbles.
template <bool GEMM>
__device__ __forceinline__ void magic_pairs(uint32_t a, uint32_t b, int c, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t v = __byte_perm(a, b, pair_sel(c));
  lo = nibbles_to_magic<GEMM>(v);
  hi = nibbles_to_magic<GEMM>(v >> 4);
}

// A column's scale as the weights take it: the pair (s, s) of bf16 for the
// bf16 multiply, else the f32 value (exact for a bf16 plane)
struct Scale {
  uint32_t s2;
  float f;
};

// the scale in half `h` (0: low) of a word of two bf16 scales
__device__ __forceinline__ Scale scale_bf16(uint32_t word, int h) {
  return {__byte_perm(word, 0, h ? 0x3232 : 0x1010),
          __uint_as_float(h ? word & 0xffff0000u : word << 16)};
}

// an f32 scale; under LLAMAVK_Q4_MUL=bf16 (RS) its bf16 rounding for the
// bf16 multiply
template <bool RS, bool GEMM>
__device__ __forceinline__ Scale scale_f32(float f) {
  Scale s;
  s.f = f;
  if constexpr (!RS)
    s.s2 = 0u;
  else if constexpr (GEMM)
    s.s2 = as_u32(__float2bfloat162_rn(f));
  else
    s.s2 = __byte_perm(rne_hi(f), 0, 0x3232);
  return s;
}

// the rne_hi bits of bf16 part p of w: the p-th term of w = w0 + w1 (+ w2),
// each the bf16 rounding of what the earlier ones leave
__device__ __forceinline__ uint32_t part_hi(float w, int p) {
  uint32_t h = rne_hi(w);
  for (int i = 0; i < p; ++i) {
    w = __fsub_rn(w, __uint_as_float(h & 0xffff0000u));
    h = rne_hi(w);
  }
  return h;
}

// the same by the F2F conversion
__device__ __forceinline__ float part_cvt(float w, int p) {
  float h = __bfloat162float(__float2bfloat16_rn(w));
  for (int i = 0; i < p; ++i) {
    w = __fsub_rn(w, h);
    h = __bfloat162float(__float2bfloat16_rn(w));
  }
  return h;
}

// the two q of `magic` (two bf16 136 + q) as f32s: the exact bf16 q, its
// bits shifted into an f32's high half
__device__ __forceinline__ void q_pair_f32(uint32_t magic, float& lo, float& hi) {
  const uint32_t qb = as_u32(__hsub2(as_bf2(magic), as_bf2(MAGIC2)));  // exact
  lo = __uint_as_float(qb << 16);
  hi = __uint_as_float(qb & 0xffff0000u);
}

// The A register of two weights of one column from `magic` (two bf16
// 136 + q) and the column's scale: bf16(q * s), or bf16 part p of the f32
// q * s under the f32 dot (NP > 1).
template <typename ST, bool RS, int NP, bool GEMM>
__device__ __forceinline__ uint32_t weight_pair(uint32_t magic, const Scale& s, int p) {
  if constexpr (sizeof(ST) == 2 || RS) {  // a bf16 (or RS-rounded) scale
    const __nv_bfloat162 q = __hsub2(as_bf2(magic), as_bf2(MAGIC2));  // exact
    const __nv_bfloat162 w0 = __hmul2(q, as_bf2(s.s2));
    if (NP == 1 || p == 0) return as_u32(w0);
    // q s - w0 holds <= 4 significant bits: exact in bf16
    return as_u32(__hfma2(q, as_bf2(s.s2), as_bf2(as_u32(w0) ^ 0x80008000u)));
  } else {
    float qa, qb;
    q_pair_f32(magic, qa, qb);
    const float a = __fmul_rn(qa, s.f), b = __fmul_rn(qb, s.f);
    if constexpr (GEMM) {
      if constexpr (NP == 1) return as_u32(__floats2bfloat162_rn(a, b));
      return as_u32(__floats2bfloat162_rn(part_cvt(a, p), part_cvt(b, p)));
    }
    return high_halves(part_hi(a, p), part_hi(b, p));
  }
}

}  // namespace q4dq
