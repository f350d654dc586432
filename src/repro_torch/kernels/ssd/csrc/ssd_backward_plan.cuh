// The host's plan of the SSD scan's backward (ssd_backward.cu): how the bf16
// chunk-local pass splits a group's heads into sub-groups, and the fp32
// scratch each dtype's passes need. Plain C++ (under nvcc the helpers are
// device functions too), so the CPU tests compile it with the host compiler
// (tests/test_torch_ssd_backward.py).
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define REPRO_SSD_HOST_DEVICE __host__ __device__
#else
#define REPRO_SSD_HOST_DEVICE
#endif

namespace repro_torch {
namespace ssd_bwd_plan {

constexpr int kTile = 64;    // chunk rows of a tile
constexpr int kFloat32 = 0;  // dtype codes, as kernel.py's _DTYPE_CODES
constexpr int kBFloat16 = 1;
constexpr int kPassThreads = 256;  // the state pass: one state entry a thread

REPRO_SSD_HOST_DEVICE inline int tiles(int chunk) { return (chunk + kTile - 1) / kTile; }
// The tile pairs (i tile >= j tile) of a chunk, and the index of pair (it, jt).
REPRO_SSD_HOST_DEVICE inline int pairs(int chunk) {
  const int t = tiles(chunk);
  return t * (t + 1) / 2;
}
REPRO_SSD_HOST_DEVICE inline int pair_index(int it, int jt) { return it * (it + 1) / 2 + jt; }
// Heads a sub-group walks when a group's `rep` heads are split `s` ways (the
// last sub-group may walk fewer), and the sub-groups that then hold a head.
REPRO_SSD_HOST_DEVICE inline int subgroup_heads(int rep, int s) { return (rep + s - 1) / s; }
REPRO_SSD_HOST_DEVICE inline int subgroups_used(int rep, int s) {
  const int hs = subgroup_heads(rep, s);
  return (rep + hs - 1) / hs;
}

// The sub-groups a group's heads are split into in the bf16 chunk-local pass.
// A block owns a 64-row j tile of one (chunk, row, group) and walks its
// sub-group's heads, summing their scores W in shared memory; each further
// sub-group costs one more fp32 partial of W (the chunk's lower tile pairs)
// for the group pass to sum. The fewest sub-groups whose longest block (j tile
// 0, which walks every i tile) takes no more (tile pair, head) units than a
// quarter of an even share of the pass's work over `slots` resident blocks
// (SMs x blocks a SM): the blocks launch longest first, and at mamba2-2.7b's
// training call on an H100 the pass ran fastest at 8 sub-groups of 10 heads
// (7 by this rule), slower at 2, 4, 10 and 16 (PERF.md).
inline int subgroups(int B, int S, int H, int G, int chunk, int slots) {
  const int rep = H / G;
  if (rep <= 1 || slots <= 0 || chunk <= 0) return 1;
  const int nt = tiles(chunk), nc = S / chunk;
  const int64_t total = int64_t(B) * nc * G * rep * pairs(chunk);
  const int64_t quarter_share = total / (4 * int64_t(slots));
  for (int s = 1; s < rep; ++s)
    if (int64_t(nt) * subgroup_heads(rep, s) <= quarter_share) return subgroups_used(rep, s);
  return rep;
}

// Where each fp32 piece of the scratch starts, in floats, and the total. Every
// piece starts on a 256-byte boundary.
struct Layout {
  // bf16: S_k for k < nc - 1; D_k for k >= 1 (then G_k in its place); the
  // bf16 planes of G_{k+1} and H_k (B, nc, H, P, N), two bf16 a float; the
  // chunk decays (B, nc, H); cum (B, nc, H, c); per position of each head
  // ddt's direct term, V (exp(cl - cum_j) x_j . G B_j) and Y (exp(cum_i) C_i .
  // H^T dy_i); the row sums of W^h o CB per j tile (B, nc, H, tiles, c); the
  // sub-groups' W partials (B, nc, G, sub-groups, pairs, 64 x 64); <G_{k+1},
  // H_k> per state-pass block (B, nc, H, blocks); dA per (row, chunk) (B, nc, H).
  // float32: the chunk states, then H_k (B, nc, H, P, N); D_k, then G_{k+1};
  // the decays; the per-head partials of dB and dC (B, S, H, N) each; dA's.
  int64_t states, dstates, gplane, hplane, decay, cum, pdt, pv, py, rpart, wpart, ghpart,
      dApart, dB_part, dC_part, total;
};

inline int64_t round64(int64_t n) { return (n + 63) / 64 * 64; }

inline Layout layout(int dtype, int B, int S, int H, int P, int G, int N, int chunk, int s) {
  Layout l = {};
  const int64_t nc = S / chunk, PN = int64_t(P) * N, per = int64_t(B) * nc * H;
  int64_t at = 0;
  const auto take = [&](int64_t floats) {
    const int64_t start = at;
    at += round64(floats);
    return start;
  };
  if (dtype == kFloat32) {
    l.states = take(per * PN);
    l.dstates = take(per * PN);
    l.decay = take(per);
    l.dB_part = take(int64_t(B) * S * H * N);
    l.dC_part = take(int64_t(B) * S * H * N);
    l.dApart = take(per);
  } else {
    const int64_t slots = int64_t(B) * (nc - 1) * H * PN;
    l.states = take(slots);
    l.dstates = take(slots);
    l.gplane = take((per * PN + 1) / 2);
    l.hplane = take((per * PN + 1) / 2);
    l.decay = take(per);
    l.cum = take(per * chunk);
    l.pdt = take(per * chunk);
    l.pv = take(per * chunk);
    l.py = take(per * chunk);
    l.rpart = take(per * tiles(chunk) * chunk);
    l.wpart = take(int64_t(B) * nc * G * subgroups_used(H / G, s) * pairs(chunk) * kTile * kTile);
    l.ghpart = take(per * ((PN + kPassThreads - 1) / kPassThreads));
    l.dApart = take(per);
  }
  l.total = at;
  return l;
}

}  // namespace ssd_bwd_plan
}  // namespace repro_torch
