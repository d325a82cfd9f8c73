// Row 16's fp32 form: its C entries and the first form's instances (the
// kernel, what it replaces and its design: fp32_whole_block.cuh; the wide
// instances: fp32_whole_block_wide.cu).

#include <atomic>

#include "fp32_whole_block.cuh"

namespace {

using namespace whole_block_f32;

// launches whose attention phase ran the streamed pair since the last
// reset (`stswin_whole_block_f32_streamed_launches`)
std::atomic<long long> streamed_launches{0};

// Whether a shape runs the first form's instance (WIDE false): C % 128 up
// to 1024, hidden % 128, TN dividing 128, hd % 32 and a resident pair.
bool narrow(int C, int hidden, int TN, int hd) {
  return C % 128 == 0 && C <= 1024 && hidden % 128 == 0 && TM % TN == 0 &&
         hd % 32 == 0 && !whole_layout(TN, hd).streamed;
}

// run<NT, WIDE> for windows of TN tokens (TN <= 176), NT the standalone
// core's: the first form's instances here, the wide ones in
// fp32_whole_block_wide.cu; the launches that ran the streamed pair
// counted
cudaError_t run_for(int C, int hidden, int TN, int hd, const WholeF32* p,
                    int grid, cudaStream_t stream, int* per_sm) {
  if (narrow(C, hidden, TN, hd)) {
    switch (attn32::score_tiles(TN)) {
      case 4:
        return run<4, false>(TN, hd, p, grid, stream, per_sm);
      case 8:
        return run<8, false>(TN, hd, p, grid, stream, per_sm);
      default:
        return run<16, false>(TN, hd, p, grid, stream, per_sm);
    }
  }
  const cudaError_t err = run_wide(TN, hd, p, grid, stream, per_sm);
  if (err == cudaSuccess && !per_sm && whole_layout(TN, hd).streamed)
    ++streamed_launches;
  return err;
}

}  // namespace

// The workspace slots `stswin_whole_block_f32` wants for windows of TN =
// T * ws * ws tokens and head_dim C / heads: the blocks of the kernel the
// card holds at once (SMs times resident blocks an SM), written to
// `*slots`.
extern "C" int stswin_whole_block_f32_slots(int T, int C, int heads, int ws,
                                            int* slots) {
  if (heads <= 0 || C % heads || !attn32::takes(T * ws * ws, C / heads))
    return cudaErrorInvalidValue;
  int per_sm = 0;  // the instance of hidden 4C (the same occupancy)
  const cudaError_t err = run_for(C, 4 * C, T * ws * ws, C / heads, nullptr,
                                  0, nullptr, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0 || !sm_count()) return cudaErrorInvalidConfiguration;
  *slots = per_sm * sm_count();
  return cudaSuccess;
}

// The shared memory `stswin_whole_block_f32` launches with for windows of
// TN tokens of head_dim hd: `*total` bytes a block, in which `*group`
// attention pairs (resident, or streamed where the resident pair does not
// fit) share the ring's region. No CUDA call.
extern "C" int stswin_whole_block_f32_layout(int TN, int hd, int* group,
                                             long long* total) {
  if (!attn32::takes(TN, hd)) return cudaErrorInvalidValue;
  const Layout L = whole_layout(TN, hd);
  *group = L.group;
  *total = static_cast<long long>(L.total);
  return cudaSuccess;
}

// The launches whose attention phase ran the streamed pair since the last
// call with `reset` set (a query, not a launch); `reset` sets the count to
// 0 after reading it.
extern "C" int stswin_whole_block_f32_streamed_launches(int reset,
                                                        long long* out) {
  *out = reset ? streamed_launches.exchange(0) : streamed_launches.load();
  return cudaSuccess;
}

// The arguments of the bf16 entry `stswin_whole_block`, every tensor fp32:
// x, out (B, T, H, W, C), image layout; wqkv (3C, C), wproj (C, C), w1
// (hidden, C), w2 (C, hidden) in the torch Linear layout; bqkv, bproj, s2,
// b2, b1, bw2, s1, b1n; bias (heads, TN, TN), TN = T * ws * ws. Workspace
// of `slots` slots of R = 128 rows (256 past 128 tokens): ws_wide (slots,
// R, max(3C, hidden)), ws_narrow and ws_s (slots, R, C). x, the weights,
// the vectors and the workspace 16-byte aligned. Takes the bf16 entry's
// shapes (K1's and K2's envelope: C and hidden multiples of 8, head_dim %
// 8 and TN % 16 up to 176), and returns cudaErrorInvalidValue on anything
// else.
extern "C" int stswin_whole_block_f32(
    const void* x, const void* wqkv, const void* bqkv, const void* wproj,
    const void* bproj, const void* bias, const void* s2, const void* b2,
    const void* w1, const void* b1, const void* w2, const void* bw2,
    const void* s1, const void* b1n, void* ws_wide, void* ws_narrow,
    void* ws_s, void* out, int B, int T, int H, int W, int C, int hidden,
    int heads, int ws, int slots, int act, float scale, float eps,
    void* stream) {
  for (const void* q : {x, wqkv, bqkv, wproj, bproj, s2, b2, w1, b1, w2, bw2,
                        s1, b1n, static_cast<const void*>(ws_wide),
                        static_cast<const void*>(ws_narrow),
                        static_cast<const void*>(ws_s),
                        static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(q) % 16) return cudaErrorInvalidValue;
  if (C <= 0 || C % 8 || hidden <= 0 || hidden % 8 || heads <= 0 ||
      C % heads || ws <= 0 || H % ws || W % ws || slots <= 0 ||
      !attn32::takes(T * ws * ws, C / heads))
    return cudaErrorInvalidValue;
  WholeF32 p;
  p.x = static_cast<const float*>(x);
  p.wqkv = static_cast<const float*>(wqkv);
  p.bqkv = static_cast<const float*>(bqkv);
  p.wproj = static_cast<const float*>(wproj);
  p.bproj = static_cast<const float*>(bproj);
  p.bias = static_cast<const float*>(bias);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.bw2 = static_cast<const float*>(bw2);
  p.s1 = static_cast<const float*>(s1);
  p.b1n = static_cast<const float*>(b1n);
  p.out = static_cast<float*>(out);
  p.ws_wide = static_cast<float*>(ws_wide);
  p.ws_narrow = static_cast<float*>(ws_narrow);
  p.ws_s = static_cast<float*>(ws_s);
  p.img = RowMap{1, T, H, W, ws, 0};
  p.M = B * T * H * W;
  p.C = C;
  p.hidden = hidden;
  p.wide = 3 * C > hidden ? 3 * C : hidden;
  p.heads = heads;
  p.TN = T * ws * ws;
  p.hd = C / heads;
  // whole windows a tile: as many as fit 128 rows, or one over 2 x 128
  p.tile_rows = (p.TN <= TM ? TM / p.TN : 1) * p.TN;
  p.slot_rows = p.TN <= TM ? TM : 2 * TM;
  p.tiles = (p.M + p.tile_rows - 1) / p.tile_rows;
  const Layout L = whole_layout(p.TN, p.hd);
  p.group = L.group;
  p.pt = L.pt;
  p.pair_floats = static_cast<int>(L.pair / sizeof(float));
  p.streamed = L.streamed;
  p.act = act;
  p.scale = scale;
  p.eps = eps;
  if (p.M <= 0) return cudaErrorInvalidValue;
  const int grid = p.tiles < slots ? p.tiles : slots;
  return run_for(C, hidden, p.TN, p.hd, &p, grid,
                 static_cast<cudaStream_t>(stream), nullptr);
}
