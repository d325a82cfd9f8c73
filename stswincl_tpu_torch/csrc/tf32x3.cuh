// fp32-accurate products on the tensor cores: the 3xTF32 split.
//
// The tensor cores have no fp32 product. One TF32 pass keeps 10 of an
// operand's 23 mantissa bits (relative error about 2^-11), which an fp32
// model does not ask for. Split each operand x into hi = x rounded to TF32,
// to nearest with ties away from zero (what `cvt.rna.tf32.f32` gives), and
// lo = x - hi (exact in fp32), which the mma reads as TF32 by ignoring its
// low 13 bits (lo truncated: an error below 2^-21 |x|); then
//   a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi
// leaves out only a_lo b_lo (about 2^-22 of a b) and lo's truncation, so
// the sum lands within fp32 accuracy at a third of the TF32 rate (494.7 /
// 3 = 164.9 TFLOP/s on the H100). hi is formed with integer operations
// (the magnitude bits plus half of the last kept bit, the low 13 cleared):
// the conversion instruction runs on the SM's slower conversion unit, and
// every operand value is split in the products' inner loops. The three
// products accumulate in fp32 in the mma, the small terms first; the
// mma's accumulation drops the bits past its sum's last (a bias toward
// zero), so the callers add each k step's (or k tile's) products to their
// own fp32 sums, rounded to nearest.
// Its users: the fp32 attention core (fp32_attention.cuh) and the
// attention backward of K5's fp32 form (fp32_attention_bwd.cuh), both on
// mma.sync; the fp32 GEMM tile on wgmma, the weight gradients' too, rounds
// lo as well (`split_rn`, fp32_gemm.cuh).
// `tests/test_torch_tf32x3.py` emulates this split in PyTorch and holds it,
// and one TF32 pass, against the fp32 bound of the kernels' checks.
#pragma once

#include <cstdint>

namespace tf32x3 {

// x -> (hi, lo), each a TF32 operand in a 32-bit register
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8 fp32) += a (16 x 8 tf32, row) b (8 x 8 tf32, col), one pass.
// Not volatile: the mma has no effect but its outputs, so the compiler may
// interleave the independent accumulators' chains of three.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of m16n8k8 split: fragment element i (lane g = lane / 4,
// t = lane % 4: i = 0 row g col t, 1 row g + 8 col t, 2 row g col t + 4,
// 3 row g + 8 col t + 4) from the fp32 values v[i].
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float v0, float v1, float v2,
                                      float v3) {
    split(v0, hi[0], lo[0]);
    split(v1, hi[1], lo[1]);
    split(v2, hi[2], lo[2]);
    split(v3, hi[3], lo[3]);
  }
};

// The B fragment (b0: row t col g, b1: row t + 4 col g) split.
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float v0, float v1) {
    split(v0, hi[0], lo[0]);
    split(v1, hi[1], lo[1]);
  }
};

// d = a b (one pass), the accumulator starting at 0: the first product of
// a sum that its caller adds to its own fp32 sums, rounded to nearest (the
// mma's own accumulation drops the bits past the sum's last, a bias toward
// zero, so a long chain of them drifts).
__device__ __forceinline__ void mma1688_from0(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// d[j0 + u] += a b[u] in fp32 accuracy for U independent accumulators (u <
// U): the k step's product formed from 0 in three TF32 passes, a_lo b_hi,
// a_hi b_lo, a_hi b_hi (the small terms first), each pass over all U
// before the next so that each mma of a chain of three has U - 1 others
// between it and the one it waits for, then added to d in fp32, rounded
// to nearest (see `mma1688_from0`). j0 is a constant once the caller's
// loop is unrolled. MIRROR takes the two small terms in the other order,
// a_hi b_lo first: the product of the transposed operands (b^T a^T) term
// for term in the order of the plain one, as the attention backward's key
// pass forms k q^T where its query pass formed q k^T.
template <int U, int N, bool MIRROR = false>
__device__ __forceinline__ void mma3_add(float (&d)[N][4], int j0,
                                         const FragA& a,
                                         const FragB (&b)[U]) {
  float t[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (MIRROR)
      mma1688_from0(t[u], a.hi, b[u].lo[0], b[u].lo[1]);
    else
      mma1688_from0(t[u], a.lo, b[u].hi[0], b[u].hi[1]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (MIRROR)
      mma1688(t[u], a.lo, b[u].hi[0], b[u].hi[1]);
    else
      mma1688(t[u], a.hi, b[u].lo[0], b[u].lo[1]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) mma1688(t[u], a.hi, b[u].hi[0], b[u].hi[1]);
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j0 + u][e] += t[u][e];
}

}  // namespace tf32x3
