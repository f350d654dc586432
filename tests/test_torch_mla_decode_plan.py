"""The host and device plan of MLA's absorbed decode kernel
(``src/repro_torch/kernels/flash_attention/csrc/mla_decode_plan.cuh``), on the CPU.

The kernel launches one thread-block cluster of C blocks per (row, group of
64 heads); block r of a row of length L takes keys [r q, min(L, (r + 1) q)),
q = ceil(L / C) rounded up to 16, and sums output columns [r w, (r + 1) w)
of the merge. The header is plain C++: it is compiled here with the host
compiler and called through ctypes, so the rules the card runs are the ones
held. Skips where there is no host C++ compiler.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels.flash_attention import kernel as tkernel

CSRC = Path(tkernel.__file__).parent / "csrc"
SHIM = """
#include "mla_decode_plan.cuh"
using namespace repro_torch::mla_plan;
extern "C" {
int plan_cluster() { return kCluster; }
int plan_group_heads(int B, int S, int H, int clusters) { return group_heads(B, S, H, clusters); }
void plan_grid(int B, int S, int H, int clusters, int* out) {
  const Grid g = grid(B, S, H, clusters);
  out[0] = g.x;
  out[1] = g.y;
  out[2] = g.z;
}
// every block's [begin, end) for rows of length 0 .. S
void plan_shares(int S, int C, int* begin, int* end) {
  for (int L = 0; L <= S; ++L)
    for (int r = 0; r < C; ++r) {
      begin[L * C + r] = share_begin(L, C, r);
      end[L * C + r] = share_end(L, C, r);
    }
}
int plan_share(int L, int C) { return share(L, C); }
int plan_merge_cols(int dl, int C) { return merge_cols(dl, C); }
int plan_merge_ld(int dl) { return merge_ld(dl); }
int plan_slabs(int width, int esize) { return slabs(width, esize); }
void plan_layout(int esize, int dl, int dr, int64_t* out) {
  const Layout l = layout(esize, dl, dr);
  const int64_t v[8] = {l.tile, l.stages, l.q, l.ring, l.ml, l.rows, l.bars, int64_t(l.bytes)};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}
int plan_max_smem() { return kMaxSmem; }
int plan_max_stages() { return kMaxStages; }
}
"""
FIELDS = ("tile", "stages", "q", "ring", "ml", "rows", "bars", "bytes")
LENGTHS = (1, 100, 1024, 8192)   # S: the reduced config's, minicpm3-4b's served, the longest
ROWS, SLAB = 64, 64 * 128        # heads a block, bytes a slab (64 rows of 128 bytes)


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the plan header")
    d = tmp_path_factory.mktemp("mla_plan")
    (d / "shim.cpp").write_text(SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}", "-o",
                    str(d / "libplan.so"), str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libplan.so"))
    lib.plan_layout.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int64)]
    return lib


def _shares(plan, S: int, C: int):
    begin = np.zeros((S + 1) * C, dtype=np.int32)
    end = np.zeros_like(begin)
    plan.plan_shares(S, C, begin.ctypes.data_as(ctypes.c_void_p),
                     end.ctypes.data_as(ctypes.c_void_p))
    return begin.reshape(S + 1, C), end.reshape(S + 1, C)


def _layout(plan, esize: int, dl: int, dr: int) -> dict:
    out = (ctypes.c_int64 * len(FIELDS))()
    plan.plan_layout(esize, dl, dr, out)
    return dict(zip(FIELDS, out))


@pytest.mark.parametrize("S", LENGTHS)
def test_shares_cover_each_row_once(plan, S):
    """For every length L in 0..S the blocks' shares, in rank order, cover
    keys 0..L-1 exactly once; at L = 0 no block has a share; every share
    but the last that holds keys is a multiple of 16 long."""
    C = plan.plan_cluster()
    assert C == 8   # the portable cluster size
    begin, end = _shares(plan, S, C)
    for L in range(S + 1):
        b, e = begin[L], end[L]
        assert (b <= e).all() and (e <= L).all(), L
        assert b[0] == 0 and e[-1] == L, L
        assert (b[1:] == e[:-1]).all(), L   # consecutive, so no key twice and none missed
        sizes = e - b
        if L == 0:
            assert (sizes == 0).all()
            continue
        held = np.flatnonzero(sizes)
        assert (sizes[held[:-1]] % 16 == 0).all(), L
        assert (held == np.arange(len(held))).all(), L   # the empty shares are the last ones


def test_shares_are_equal_whatever_the_length(plan):
    """A share is ceil(L / C) rounded up to 16, the same for every block that
    holds keys, and the kernel's Python mirror (``kernel.mla_share``) agrees."""
    C = plan.plan_cluster()
    for L in range(0, 8193):
        q = plan.plan_share(L, C)
        assert q == -(-(-(-L // C)) // 16) * 16   # ceil(ceil(L / C) / 16) * 16
        assert tkernel.mla_share(L, C) == q
        assert C * q >= L and (L == 0 or q - 16 < -(-L // C))


HELD = 16  # clusters of 8 one-block-a-SM blocks an H100's 132 SMs could hold at most


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("H", [4, 40, 72])
@pytest.mark.parametrize("B", [1, 8, 16])
def test_grid_is_whole_clusters(plan, B, S, H):
    """The grid is (C, groups, B): its blocks divide by the cluster size, C
    and the groups depend on B, S and H (and the clusters the card holds at
    once) only, so one captured graph serves every set of lengths; the groups
    split the heads evenly into groups of at most 64 and, where that leaves
    clusters unused, of at least 8; a group holds heads, and the clusters
    stay within what the card holds wherever the fewest groups do."""
    C = plan.plan_cluster()
    g = (ctypes.c_int * 3)()
    plan.plan_grid(B, S, H, HELD, g)
    heads = plan.plan_group_heads(B, S, H, HELD)
    assert tuple(g) == (C, -(-H // heads), B)
    assert (g[0] * g[1] * g[2]) % C == 0
    assert heads <= 64 and (heads >= 8 or heads == H or g[1] == -(-H // 8))
    assert (g[1] - 1) * heads < H          # no group without heads
    if B * -(-H // 64) <= HELD:
        assert B * g[1] <= HELD


@pytest.mark.parametrize("held,want", [(16, (20, 10, 40)), (14, (40, 14, 40)), (0, (40, 40, 40))])
def test_group_heads_at_the_served_shapes(plan, held, want):
    """minicpm3-4b's 40 heads at B 8, the fabric host's B 4 and B 16: a card
    that holds 16 clusters at once gets two groups of 20 at B 8 (16 clusters)
    and four of 10 at B 4; one that holds 14, one group at B 8 and three of
    14 at B 4; with none known, the fewest groups of at most 64 (72 heads:
    two of 36)."""
    got = tuple(plan.plan_group_heads(B, 1024, 40, held) for B in (8, 4, 16))
    assert got == want
    assert plan.plan_group_heads(3, 520, 72, 0) == 36


def test_merge_columns_cover_the_latent_once(plan):
    """Block r of C sums columns [r w, min(dl, (r + 1) w)): together each of
    dl's columns once, each block's a whole number of 16-byte fp32 reads."""
    C = plan.plan_cluster()
    for dl in range(16, 257, 16):
        w = plan.plan_merge_cols(dl, C)
        assert w % 4 == 0 and w * C >= dl
        cols = [c for r in range(C) for c in range(r * w, min(dl, (r + 1) * w))]
        assert cols == list(range(dl))


@pytest.mark.parametrize("esize", [2, 4], ids=["bfloat16", "float32"])
def test_shared_memory_fits_and_holds_the_merge(plan, esize):
    """At every width the kernel takes (dl 16..256, dr 0..64), the shared
    memory is at most an H100 block's 232,448 bytes (dl 256, dr 64 among
    them); Q and each ring stage are whole 128-byte slabs of the latent then
    the rope; the ring holds at least one stage (bf16: at least two, so the
    next tile lands while one is used) and the fp32 merge buffer (64 rows of
    merge_ld(dl) floats); the regions do not overlap."""
    assert plan.plan_max_smem() == 232448
    C = plan.plan_cluster()
    for dl in range(16, 257, 16):
        for dr in range(0, 65, 8):
            lay = _layout(plan, esize, dl, dr)
            slabs = plan.plan_slabs(dl, esize) + plan.plan_slabs(dr, esize)
            assert slabs == -(-dl * esize // 128) + -(-dr * esize // 128)
            assert lay["tile"] == slabs * SLAB
            assert 1 <= lay["stages"] <= plan.plan_max_stages()
            if esize == 2:
                assert lay["stages"] >= 2
            merge = ROWS * plan.plan_merge_ld(dl) * 4
            assert lay["q"] == 0 and lay["ring"] == lay["tile"]
            assert lay["ml"] - lay["ring"] >= max(lay["stages"] * lay["tile"], merge)
            # each row's (m, l); then its C weights, max and total
            assert lay["rows"] - lay["ml"] == ROWS * 8
            assert lay["bars"] - lay["rows"] == ROWS * (C + 2) * 4
            assert lay["bytes"] == 1024 + lay["bars"] + 8 * (1 + lay["stages"])
            assert lay["bytes"] <= 232448, (dl, dr, lay)
            assert lay["ring"] % 1024 == 0   # each slab on a swizzle atom
    widest = _layout(plan, esize, 256, 64)
    assert widest["bytes"] <= 232448


def test_merge_rows_spread_over_the_banks(plan):
    """The fp32 merge buffer's rows are an odd multiple of 32 bytes apart
    modulo 128 (the 8 rows a warp writes at once spread over the banks) and
    16-byte aligned, at every dl."""
    for dl in range(16, 257, 16):
        ld = plan.plan_merge_ld(dl) * 4
        assert ld % 64 == 32 and ld % 16 == 0
