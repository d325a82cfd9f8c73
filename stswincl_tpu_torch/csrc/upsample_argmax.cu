// K4: composed bilinear upsample + class argmax, head-resolution logits
// (B, NC, h, w) -> (B, OH, OW) int32 predictions.
//
// Replaces: stswincl_tpu/ops/pallas_upsample_argmax.py
//   upsample_argmax_pallas (:53) -> _kernel (:36).
//
// Bound on the H100: device memory. The full-resolution logits (B * NC *
// OH * OW fp32, 126 MB at bs 2 of the EndoVis protocol) never leave the
// SM; the int32 prediction (10.5 MB there) is the only large write, and
// the logits and matrices read are under 1.2 MB. The TPU kernel ran the
// two interpolation products densely on its matrix unit. Here they are
// banded: each row of a bilinear matrix (composed or not) has at most a
// few consecutive nonzeros (3 in both eval protocols), so about 96 % of
// a dense product's multiply-adds are with exact zeros.
//
// Design: each row of mh and of mw comes with its span, the half-open
// range [lo, hi) of its nonzero columns (`ops.upsample_argmax.
// interp_spans`, computed once per matrix pair). One block per (batch,
// 16-row output band, 128-column output band):
//   - its band of x is the min of lo and the max of hi over its own rows
//     (of mh) and columns (of mw), empty spans left out: a matrix need not
//     have monotone spans, and a dense one gives the full band;
//   - it stages, for as many classes at once as fit, that band of x in
//     shared memory (where even one class's band does not fit, as with a
//     large dense pair, x is read through L1 instead), and on the general
//     path below its slice of mw (the band's columns x 128 outputs);
//   - it forms t = mh @ x for its own rows on the band's columns only, each
//     t summing its row's span, then each output sums its own column's
//     span of t; a running max / argmax stays in registers across the
//     classes, with a strict `>` so that ties go to the first class;
//   - where every row's span and every lane's 4 columns' spans together
//     take at most UA_TAPS (4) taps and a warp's t fits its lanes (both
//     eval protocols: 3 taps, 10-13 band columns), the taps sit in
//     registers, padded with zero weights: a lane forms one t of its
//     warp's two rows a class, the warp reads them by shuffle, and each
//     output is UA_TAPS unrolled multiply-adds, with no shared-memory t and
//     no barrier inside the class loop. Spans of any length (a dense pair)
//     take loops, with t through shared memory;
//   - a lane owns 4 consecutive outputs of a row and stores them as one
//     16-byte store (a warp writes 512 contiguous bytes).
// Every sum runs in ascending index order over the span. An exact zero
// added to an fp32 sum of finite values changes nothing, so the sums equal
// those of the dense loop over every index (the padded taps add zeros too).
// Without `exact` the logits, both matrices and t are rounded to bf16
// first, as the TPU kernel's bf16 matmul inputs are (the products of two
// bf16 values are exact in fp32); sums are fp32. With `exact` everything
// is fp32.

#include <climits>

#include "common.cuh"

namespace {

constexpr int UA_HB = 16, UA_OB = 128, UA_THREADS = 256;
constexpr int UA_WARPS = UA_THREADS / 32;
constexpr int UA_RPW = UA_HB / UA_WARPS;  // output rows a warp
constexpr int UA_CPL = UA_OB / 32;        // output columns a lane (4)
constexpr int UA_TAPS = 4;                // the unrolled sums' taps
static_assert(UA_CPL == 4, "one 16-byte store of int32 a lane");

template <bool EXACT>
__device__ __forceinline__ float rnd(float v) {
  return EXACT ? v : __bfloat162float(__float2bfloat16_rn(v));
}

// The span of matrix row i, clamped to [0, n): empty when lo >= hi.
__device__ __forceinline__ int2 span_of(const int* __restrict__ spans, int i,
                                        int n) {
  const int2 s = __ldg(reinterpret_cast<const int2*>(spans) + i);
  return make_int2(max(s.x, 0), min(s.y, n));
}

// Shared memory: `smem_floats` floats (the wrapper's envelope, the same as
// the dense kernel's: w * 128 + 16 * (h + w)); carved at run time as
//   [8 ints: the block's band, its longest spans]
//   [mw slice: nc x 128, the general path's][x band: CC x nr x nc]
//   [t: CC x 16 x nc, the general path's]
// with CC classes a chunk.
template <bool EXACT>
__global__ void __launch_bounds__(UA_THREADS, 3)
    upsample_argmax_kernel(const float* __restrict__ x,
                           const float* __restrict__ mh,
                           const float* __restrict__ mw,
                           const int* __restrict__ rspan,
                           const int* __restrict__ cspan, int* __restrict__ out,
                           int NC, int h, int w, int OH, int OW,
                           int smem_floats) {
  extern __shared__ __align__(16) float sm[];
  // rlo, rhi, clo, chi, the longest row span, the widest lane's columns
  int* band = reinterpret_cast<int*>(sm);
  const int b = blockIdx.z, r0 = blockIdx.y * UA_HB, o0 = blockIdx.x * UA_OB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    band[0] = band[2] = INT_MAX;
    band[1] = band[3] = INT_MIN;
    band[4] = band[5] = 0;
  }
  // the warp's output rows: their spans and first UA_TAPS taps (zero past
  // the span), read before anything waits on them
  int2 rsw[UA_RPW];
  float cfw[UA_RPW][UA_TAPS];
#pragma unroll
  for (int i = 0; i < UA_RPW; ++i) {
    const int rg = r0 + warp * UA_RPW + i;
    rsw[i] = rg < OH ? span_of(rspan, rg, h) : make_int2(0, 0);
#pragma unroll
    for (int t = 0; t < UA_TAPS; ++t)
      cfw[i][t] = rsw[i].x + t < rsw[i].y
                      ? rnd<EXACT>(__ldg(mh + (long long)rg * h + rsw[i].x + t))
                      : 0.0f;
  }
  // this lane's output columns, their spans and the window they share
  int2 cs[UA_CPL];
  int ulo = INT_MAX, uhi = INT_MIN;
#pragma unroll
  for (int e = 0; e < UA_CPL; ++e) {
    const int o = o0 + lane * UA_CPL + e;
    cs[e] = o < OW ? span_of(cspan, o, w) : make_int2(0, 0);
    if (cs[e].x < cs[e].y) {
      ulo = min(ulo, cs[e].x);
      uhi = max(uhi, cs[e].y);
    }
  }
  // the short-span path's output weights: column e's weight of input
  // column ulo + u of the window, zero off e's span
  float wd[UA_CPL][UA_TAPS];
#pragma unroll
  for (int e = 0; e < UA_CPL; ++e)
#pragma unroll
    for (int u = 0; u < UA_TAPS; ++u) {
      const int k = (ulo < uhi ? ulo : 0) + u;
      wd[e][u] = k >= cs[e].x && k < cs[e].y
                     ? rnd<EXACT>(__ldg(mw + (long long)(o0 + lane * UA_CPL +
                                                         e) * w + k))
                     : 0.0f;
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < UA_RPW; ++i)  // the band over nonempty spans
    if (lane == i && rsw[i].x < rsw[i].y) {
      atomicMin(band + 0, rsw[i].x);
      atomicMax(band + 1, rsw[i].y);
      atomicMax(band + 4, rsw[i].y - rsw[i].x);
    }
  if (warp == 0 && ulo < uhi) {
    atomicMin(band + 2, ulo);
    atomicMax(band + 3, uhi);
    atomicMax(band + 5, uhi - ulo);
  }
  __syncthreads();
  int rlo = band[0], rhi = band[1], clo = band[2], chi = band[3];
  if (rlo >= rhi) rlo = rhi = 0;  // no nonzero row: t is 0
  if (clo >= chi) clo = chi = 0;  // no nonzero column: y is 0
  const int nr = rhi - rlo, nc = chi - clo;
  // the same in every thread: every span of the block within UA_TAPS taps
  // and the warp's t (UA_RPW rows x nc) within its 32 lanes
  const bool fast = band[4] <= UA_TAPS && band[5] <= UA_TAPS &&
                    UA_RPW * nc <= 32;

  // classes a chunk: with x's band staged when one class of it fits
  float* mws = sm + 8;  // [nc][UA_OB]: mws[k][o] = mw[o0 + o, clo + k]
  float* buf = mws + nc * UA_OB;
  const int room = smem_floats - 8 - nc * UA_OB;
  const int per_t = UA_HB * nc;
  const int per_staged = nr * nc + per_t;
  const bool staged = per_staged > 0 && room / per_staged >= 1;
  int CC = per_t == 0 ? NC : room / (staged ? per_staged : per_t);
  CC = CC < NC ? CC : NC;
  float* xs = buf;                                // [CC][nr][nc]
  float* ts = buf + (staged ? CC * nr * nc : 0);  // [CC][UA_HB][nc]
  const float* xb = x + (long long)b * NC * h * w;
  // x[c0 + cc, j, clo + k] as staged or read (rounded)
  const auto xat = [&](int c0, int cc, int j, int k) {
    return staged ? xs[(cc * nr + j - rlo) * nc + k]
                  : rnd<EXACT>(__ldg(xb + ((long long)(c0 + cc) * h + j) * w +
                                     clo + k));
  };
  const auto stage = [&](int c0, int cn) {
    if (!staged) return;
    for (int i = tid; i < cn * nr * nc; i += UA_THREADS) {
      const int cc = i / (nr * nc), q = i - cc * nr * nc;
      const int j = q / nc, k = q - j * nc;
      xs[i] = rnd<EXACT>(
          __ldg(xb + ((long long)(c0 + cc) * h + rlo + j) * w + clo + k));
    }
  };

  float best[UA_RPW][UA_CPL];
  int idx[UA_RPW][UA_CPL];
#pragma unroll
  for (int i = 0; i < UA_RPW; ++i)
#pragma unroll
    for (int e = 0; e < UA_CPL; ++e) {
      best[i][e] = -INFINITY;
      idx[i][e] = 0;
    }
  // y > best, strict: ties keep the earlier class
  const auto take = [&](int i, const float (&y)[UA_CPL], int c) {
#pragma unroll
    for (int e = 0; e < UA_CPL; ++e)
      if (y[e] > best[i][e]) {
        best[i][e] = y[e];
        idx[i][e] = c;
      }
  };

  if (fast && nc > 0) {
    // lane (ti, tk) forms t of the warp's row ti at band column tk, one
    // class at a time, and the warp's lanes read it by shuffle: no shared t
    const bool tl = lane < UA_RPW * nc;
    const int ti = tl ? lane / nc : 0, tk = tl ? lane - ti * nc : 0;
    int2 trs = rsw[0];
    float tcf[UA_TAPS];
#pragma unroll
    for (int t = 0; t < UA_TAPS; ++t) tcf[t] = cfw[0][t];
#pragma unroll
    for (int i = 1; i < UA_RPW; ++i)
      if (ti == i) {
        trs = rsw[i];
#pragma unroll
        for (int t = 0; t < UA_TAPS; ++t) tcf[t] = cfw[i][t];
      }
    int tjj[UA_TAPS];  // the taps' rows of x, the span's first past it
#pragma unroll
    for (int t = 0; t < UA_TAPS; ++t)
      tjj[t] = trs.x + t < trs.y ? trs.x + t : trs.x;
    const bool tlive = tl && trs.x < trs.y;
    // the band column of the window's u-th input column (clamped into the
    // band; its weights are 0 past the lane's spans)
    int kw[UA_TAPS];
    const int base = ulo < uhi ? ulo : clo;
#pragma unroll
    for (int u = 0; u < UA_TAPS; ++u) kw[u] = min(base + u, chi - 1) - clo;
    for (int c0 = 0; c0 < NC; c0 += CC) {
      const int cn = NC - c0 < CC ? NC - c0 : CC;
      if (c0 > 0) __syncthreads();  // the last chunk done with xs
      stage(c0, cn);
      __syncthreads();
      for (int cc = 0; cc < cn; ++cc) {
        float tval = 0.0f;
        if (tlive) {
#pragma unroll
          for (int t = 0; t < UA_TAPS; ++t)
            tval += tcf[t] * xat(c0, cc, tjj[t], tk);
          tval = rnd<EXACT>(tval);
        }
#pragma unroll
        for (int i = 0; i < UA_RPW; ++i) {
          float tv[UA_TAPS], y[UA_CPL];
#pragma unroll
          for (int u = 0; u < UA_TAPS; ++u)
            tv[u] = __shfl_sync(0xffffffffu, tval, i * nc + kw[u]);
#pragma unroll
          for (int e = 0; e < UA_CPL; ++e) {
            y[e] = 0.0f;
#pragma unroll
            for (int u = 0; u < UA_TAPS; ++u) y[e] += tv[u] * wd[e][u];
          }
          take(i, y, c0 + cc);
        }
      }
    }
  } else if (nc > 0) {
    // spans of any length: t through shared memory, a thread a (row,
    // column) of it at a time, every class of the chunk
    const int tr = tid % UA_HB, trg = r0 + tr;
    const int2 rs = trg < OH ? span_of(rspan, trg, h) : make_int2(0, 0);
    const float* mrow = mh + (long long)trg * h;
    for (int i = tid; i < nc * UA_OB; i += UA_THREADS) {
      const int o = i / nc, k = i - o * nc;  // reads along a row of mw
      const int og = o0 + o;
      mws[k * UA_OB + o] =
          og < OW ? rnd<EXACT>(__ldg(mw + (long long)og * w + clo + k)) : 0.0f;
    }
    for (int c0 = 0; c0 < NC; c0 += CC) {
      const int cn = NC - c0 < CC ? NC - c0 : CC;
      __syncthreads();  // mws written / the last chunk done with xs and ts
      stage(c0, cn);
      __syncthreads();
      for (int k = tid / UA_HB; k < nc; k += UA_THREADS / UA_HB)
        for (int cc = 0; cc < cn; ++cc) {
          float acc = 0.0f;
          for (int j = rs.x; j < rs.y; ++j)
            acc += rnd<EXACT>(__ldg(mrow + j)) * xat(c0, cc, j, k);
          ts[(cc * UA_HB + tr) * nc + k] = rnd<EXACT>(acc);
        }
      __syncthreads();
      for (int cc = 0; cc < cn; ++cc)
#pragma unroll
        for (int i = 0; i < UA_RPW; ++i) {
          const float* trow = ts + (cc * UA_HB + warp * UA_RPW + i) * nc;
          float y[UA_CPL];
#pragma unroll
          for (int e = 0; e < UA_CPL; ++e) {
            const float* mcol = mws + lane * UA_CPL + e;
            y[e] = 0.0f;
            for (int k = cs[e].x; k < cs[e].y; ++k)
              y[e] += trow[k - clo] * mcol[(k - clo) * UA_OB];
          }
          take(i, y, c0 + cc);
        }
    }
  }
  // nc == 0: no nonzero column, every y is 0 and class 0 stays

  const int og = o0 + lane * UA_CPL;
#pragma unroll
  for (int i = 0; i < UA_RPW; ++i) {
    const int r = r0 + warp * UA_RPW + i;
    if (r >= OH) continue;
    int* orow = out + ((long long)b * OH + r) * OW;
    if (OW % UA_CPL == 0 && og + UA_CPL <= OW) {
      *reinterpret_cast<int4*>(orow + og) =
          make_int4(idx[i][0], idx[i][1], idx[i][2], idx[i][3]);
    } else {
#pragma unroll
      for (int e = 0; e < UA_CPL; ++e)
        if (og + e < OW) orow[og + e] = idx[i][e];
    }
  }
}

template <bool EXACT>
cudaError_t launch(const float* x, const float* mh, const float* mw,
                   const int* rspan, const int* cspan, int* out, int B, int NC,
                   int h, int w, int OH, int OW, cudaStream_t s) {
  const int floats = w * UA_OB + UA_HB * (h + w);
  const size_t smem = sizeof(float) * size_t(floats);
  // raised on each device to the largest asked there
  static size_t granted[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > granted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        upsample_argmax_kernel<EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted[dev] = smem;
  }
  const dim3 grid((OW + UA_OB - 1) / UA_OB, (OH + UA_HB - 1) / UA_HB, B);
  upsample_argmax_kernel<EXACT><<<grid, UA_THREADS, smem, s>>>(
      x, mh, mw, rspan, cspan, out, NC, h, w, OH, OW, floats);
  return cudaGetLastError();
}

}  // namespace

// x: (B, NC, h, w) fp32; mh: (OH, h) fp32; mw: (OW, w) fp32; rspan: (OH, 2)
// and cspan: (OW, 2) int32, the [lo, hi) nonzero columns of each row of mh
// and mw (8-byte aligned); out: (B, OH, OW) int32 (16-byte aligned).
extern "C" int stswin_upsample_argmax(const void* x, const void* mh,
                                      const void* mw, const void* rspan,
                                      const void* cspan, void* out, int B,
                                      int NC, int h, int w, int OH, int OW,
                                      int exact, void* stream) {
  if (B <= 0 || NC <= 0 || h <= 0 || w <= 0 || OH <= 0 || OW <= 0 ||
      reinterpret_cast<uintptr_t>(rspan) % 8 ||
      reinterpret_cast<uintptr_t>(cspan) % 8 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* mhf = static_cast<const float*>(mh);
  const float* mwf = static_cast<const float*>(mw);
  const int* rs = static_cast<const int*>(rspan);
  const int* cs = static_cast<const int*>(cspan);
  int* o = static_cast<int*>(out);
  return exact ? launch<true>(xf, mhf, mwf, rs, cs, o, B, NC, h, w, OH, OW, s)
               : launch<false>(xf, mhf, mwf, rs, cs, o, B, NC, h, w, OH, OW,
                               s);
}
