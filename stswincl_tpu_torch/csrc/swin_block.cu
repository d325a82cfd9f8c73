// Row 16, the whole W-MSA swin block in one launch: its C entries and the
// first kernel's instances (the kernel, what it replaces and its design:
// swin_block.cuh; the wide instances: swin_block_wide.cu).

#include <atomic>

#include "swin_block.cuh"

namespace {

using namespace sm90;
using namespace whole_block;

// launches whose attention phase ran the streamed pair since the last
// reset (`stswin_whole_block_streamed_launches`)
std::atomic<long long> streamed_launches{0};

// Whether a shape runs the first kernel's instance (WIDE false): C % 128
// up to 1024, hidden % 128, TN dividing 128, hd % 16 and a resident pair.
bool narrow(int C, int hidden, int TN, int hd) {
  return C % 128 == 0 && C <= 1024 && hidden % 128 == 0 && TM % TN == 0 &&
         hd % 16 == 0 && !whole_layout(TN, hd).streamed;
}

// run<NT, WIDE> for windows of TN tokens (TN <= 176): the first kernel's
// instances here, the wide ones in swin_block_wide.cu; the launches that
// ran the streamed pair counted
cudaError_t run_for(int C, int hidden, int TN, int hd, const WholeMaps* maps,
                    const WholeParams* p, int grid, cudaStream_t stream,
                    int* per_sm) {
  if (narrow(C, hidden, TN, hd)) {
    if (TN <= 32) return run<2, false>(TN, hd, maps, p, grid, stream, per_sm);
    if (TN <= 64) return run<4, false>(TN, hd, maps, p, grid, stream, per_sm);
    return run<8, false>(TN, hd, maps, p, grid, stream, per_sm);
  }
  const cudaError_t err = run_wide(TN, hd, maps, p, grid, stream, per_sm);
  if (err == cudaSuccess && !per_sm && whole_layout(TN, hd).streamed)
    ++streamed_launches;
  return err;
}

}  // namespace

// The workspace slots `stswin_whole_block` wants for windows of TN = T *
// ws * ws tokens and head_dim C / heads: the blocks of the kernel the card
// holds at once (SMs times resident blocks an SM), written to `*slots`.
extern "C" int stswin_whole_block_slots(int T, int C, int heads, int ws,
                                        int* slots) {
  if (heads <= 0 || C % heads || !takes_window(T * ws * ws, C / heads))
    return cudaErrorInvalidValue;
  int per_sm = 0;  // the instance of hidden 4C (the same occupancy)
  const cudaError_t err = run_for(C, 4 * C, T * ws * ws, C / heads, nullptr,
                                  nullptr, 0, nullptr, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0 || !sm_count()) return cudaErrorInvalidConfiguration;
  *slots = per_sm * sm_count();
  return cudaSuccess;
}

// The shared memory `stswin_whole_block` launches with for windows of TN
// tokens of head_dim hd: `*total` bytes a block, in which `*group`
// attention pairs (resident, or streamed where the resident pair does not
// fit) share the ring's region. No CUDA call.
extern "C" int stswin_whole_block_layout(int TN, int hd, int* group,
                                         long long* total) {
  if (!takes_window(TN, hd)) return cudaErrorInvalidValue;
  const Layout L = whole_layout(TN, hd);
  *group = L.group;
  *total = static_cast<long long>(L.total);
  return cudaSuccess;
}

// The launches whose attention phase ran the streamed pair since the last
// call with `reset` set (a query, not a launch); `reset` sets the count to
// 0 after reading it.
extern "C" int stswin_whole_block_streamed_launches(int reset,
                                                    long long* out) {
  *out = reset ? streamed_launches.exchange(0) : streamed_launches.load();
  return cudaSuccess;
}

// x, out: (B, T, H, W, C) bf16, image layout; wqkv (3C, C), wproj (C, C),
// w1 (hidden, C), w2 (C, hidden) bf16 in the torch Linear layout; bqkv,
// bproj, s2, b2, b1, bw2, s1, b1n fp32; bias (heads, TN, TN) fp32, TN =
// T * ws * ws. Workspace of `slots` slots of R = 128 rows (256 past 128
// tokens): ws_wide (slots, R, max(3C, hidden)) bf16, ws_narrow (slots, R,
// C) bf16, ws_s (slots, R, C) fp32. x, the weights, the fp32 vectors and
// the workspace 16-byte aligned. Takes C % 8 == 0, hidden % 8 == 0, heads
// dividing C, ws dividing H and W, head_dim % 8 == 0 and TN % 16 == 0 up
// to 176 (K1's and K2's envelope), and returns cudaErrorInvalidValue on
// anything else.
extern "C" int stswin_whole_block(
    const void* x, const void* wqkv, const void* bqkv, const void* wproj,
    const void* bproj, const void* bias, const void* s2, const void* b2,
    const void* w1, const void* b1, const void* w2, const void* bw2,
    const void* s1, const void* b1n, void* ws_wide, void* ws_narrow,
    void* ws_s, void* out, int B, int T, int H, int W, int C, int hidden,
    int heads, int ws, int slots, int act, float scale, float eps,
    void* stream) {
  WholeParams p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.bqkv = static_cast<const float*>(bqkv);
  p.bproj = static_cast<const float*>(bproj);
  p.bias = static_cast<const float*>(bias);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.b1 = static_cast<const float*>(b1);
  p.bw2 = static_cast<const float*>(bw2);
  p.s1 = static_cast<const float*>(s1);
  p.b1n = static_cast<const float*>(b1n);
  p.ws_wide = static_cast<bf16*>(ws_wide);
  p.ws_narrow = static_cast<bf16*>(ws_narrow);
  p.ws_s = static_cast<float*>(ws_s);
  p.img = RowMap{1, T, H, W, ws, 0};
  p.M = B * T * H * W;
  p.C = C;
  p.hidden = hidden;
  p.wide = 3 * C > hidden ? 3 * C : hidden;
  p.heads = heads;
  p.TN = T * ws * ws;
  p.hd = heads > 0 ? C / heads : 0;
  p.act = act;
  p.scale = scale;
  p.eps = eps;
  for (const void* q : {x, wqkv, bqkv, wproj, bproj, s2, b2, w1, b1, w2, bw2,
                        s1, b1n, static_cast<const void*>(ws_wide),
                        static_cast<const void*>(ws_narrow),
                        static_cast<const void*>(ws_s),
                        static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(q) % 16) return cudaErrorInvalidValue;
  if (C <= 0 || C % 8 || hidden <= 0 || hidden % 8 || heads <= 0 ||
      C % heads || ws <= 0 || H % ws || W % ws || slots <= 0 || p.M <= 0 ||
      !takes_window(p.TN, p.hd))
    return cudaErrorInvalidValue;
  // whole windows a tile: as many as fit 128 rows, or one over 2 x 128
  const int wpt = p.TN <= TM ? TM / p.TN : 1;
  p.tile_rows = wpt * p.TN;
  p.slot_rows = p.TN <= TM ? TM : 2 * TM;
  p.tiles = (p.M + p.tile_rows - 1) / p.tile_rows;
  p.rows_x = TM % p.TN != 0;
  const Layout L = whole_layout(p.TN, p.hd);
  if (L.group < 1) return cudaErrorInvalidValue;
  p.group = L.group;
  p.pt = L.pt;
  p.pair = L.pair;
  p.region = L.region;
  p.streamed = L.streamed;
  WholeMaps maps;
  const int grid = p.tiles < slots ? p.tiles : slots;
  if (!encode(&maps.narrow, p.ws_narrow, grid * p.slot_rows, C, C, BM) ||
      !encode(&maps.hid, p.ws_wide, grid * p.slot_rows, hidden, p.wide, BM) ||
      !encode(&maps.wqkv, static_cast<const bf16*>(wqkv), 3 * C, C, C, BN) ||
      !encode(&maps.wproj, static_cast<const bf16*>(wproj), C, C, C, BN) ||
      !encode(&maps.w1, static_cast<const bf16*>(w1), hidden, C, C, BN) ||
      !encode(&maps.w2, static_cast<const bf16*>(w2), C, hidden, hidden, BN))
    return cudaErrorInvalidValue;
  if (p.rows_x)
    maps.x = maps.wqkv;  // not read: x comes through the row map
  else if (!encode_boxes(&maps.x, p.x, p.M, C, C, H, W, ws, ws, T))
    return cudaErrorInvalidValue;
  return run_for(C, hidden, p.TN, p.hd, &maps, &p, grid,
                 static_cast<cudaStream_t>(stream), nullptr);
}
