// The host's plan of the attention backward (flash_attention_backward.cu):
// its scratch and how the bf16 dK/dV pass splits a KV head's query heads.
// Plain C++ (under nvcc the tile helpers are device functions too), so the
// CPU tests compile it with the host compiler (tests/test_torch_flash_backward.py).
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define REPRO_HOST_DEVICE __host__ __device__
#else
#define REPRO_HOST_DEVICE
#endif

namespace repro_torch {
namespace bwd_plan {

constexpr int kTile = 64;  // query rows and keys of a tile

REPRO_HOST_DEVICE inline int tiles(int n) { return (n + kTile - 1) / kTile; }

// Rows of a (batch, head)'s lse and Delta in the scratch: Sq rounded up to a
// tile, so each tile's 64 values are one aligned 256-byte copy.
REPRO_HOST_DEVICE inline int64_t padded_rows(int Sq) { return int64_t(tiles(Sq)) * kTile; }

// The query tiles that key tile t sees: under causal masking, from the tile
// of the first row that sees key 64 t; none past Sq.
REPRO_HOST_DEVICE inline int query_tiles(int t, int Sq, int causal, int q_offset) {
  int first = causal ? t * kTile - q_offset : 0;
  first = first < 0 ? 0 : first;
  return first < Sq ? tiles(Sq) - first / kTile : 0;
}

// The sub-groups a KV head's G query heads are split into in the bf16 dK/dV
// pass. A block owns a key tile of one KV head and walks its sub-group's
// heads, keeping dK and dV in registers; more than one sub-group costs fp32
// partials and a pass that sums them. The fewest sub-groups whose longest
// block (the first key tile under causal masking) walks no more query tiles
// than an even share of the pass's work over `slots` resident blocks (SMs x
// blocks a SM): blocks launch longest first, so that share bounds the pass.
// Keys past a row's kv_len are not known here; every row counts Skv.
inline int subgroups(int B, int Sq, int Skv, int H, int KV, int causal, int q_offset, int slots) {
  const int G = H / KV;
  if (G <= 1 || slots <= 0) return 1;
  int64_t longest = 0, sum = 0;
  for (int t = 0; t < tiles(Skv); ++t) {
    const int n = query_tiles(t, Sq, causal, q_offset);
    longest = n > longest ? n : longest;
    sum += n;
  }
  const int64_t total = int64_t(B) * KV * G * sum;
  const int64_t share = (total + slots - 1) / slots;
  for (int s = 1; s < G; ++s)
    if (int64_t((G + s - 1) / s) * longest <= share) return s;
  return G;
}

// Floats of scratch a call needs: each (batch, query head)'s lse in log2
// units and Delta = rowsum(dO o O), padded_rows(Sq) each; under GQA the fp32
// dK | dV partials, B * Skv * H * (dqk + dv) (the f32 passes write one a query
// head; the bf16 pass one a sub-group, at most as many).
inline int64_t scratch_floats(int B, int Sq, int Skv, int H, int KV, int dqk, int dv) {
  const int64_t rows = 2 * int64_t(B) * H * padded_rows(Sq);
  return rows + (H == KV ? 0 : int64_t(B) * Skv * H * (dqk + dv));
}

}  // namespace bwd_plan
}  // namespace repro_torch
