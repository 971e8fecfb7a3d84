"""The walk and the word of the standalone Philox kernel, on the CPU.

``csrc/philox_mask.cu`` runs only on the card: a persistent grid whose
threads each make ``walk::WORDS`` consecutive words of one row at a time
and step through the packed plane with the adds and carries of
``csrc/philox_walk.cuh``, each word made by ``packed_word_shared``
(``csrc/philox.cuh``), which computes the parts of Philox rounds 0-2 that
a word's 8 calls share once. Both are plain integer code (``REPRO_HD``);
these tests compile them with g++ (skipped where there is no g++) and hold
them to:

- every word of the (B*H*SQ/32, SK) plane written exactly once by the
  kernel's loop on its persistent grids (132 SMs x n CTAs, and 7 CTAs),
  at the smoke's planes, odd SKs, shard windows and a plane past 2^31
  words (walk indices only), each thread's cursor the plain division of
  its flat group index;
- on small planes, ``packed_word_shared`` bitwise ``packed_word``, the
  port's ``philox_dropout_mask_plain`` and the JAX package's
  ``philox_mask_ref``, for rounds 3/5/7/10, p in {0, 0.1, 1}, a 64-bit
  seed and a shard window.

The card's branches of ``mul_wide`` and ``push_keep`` (inline PTX) are
held bitwise to the plain version by ``chip_smoke.py`` on the card.

    PYTHONPATH=src python -m pytest -q tests/test_torch_philox_walk.py
"""
import re
import shutil
import subprocess

import numpy as np
import pytest

from repro.kernels.ref import philox_mask_ref
from repro_torch.kernels import build, philox
from repro_torch.kernels.philox_common import seed_salt_words, \
    threshold_from_p

SMS = 132  # an H100 SXM's SMs
# consecutive words of a row a thread makes an iteration
WORDS = int(re.search(r"constexpr int WORDS = (\d+);",
                      (build.CSRC / "philox_walk.cuh").read_text()).group(1))

WALK_PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "philox_walk.cuh"
using namespace repro_philox;

static uint32_t arg(char** v, int i) { return strtoul(v[i], 0, 10); }

// The kernel's loop for every thread of the grid, one step of each live
// thread a sweep (so the bitmap is touched in order): marks each word a
// group stores (all of a group where `vec`, else those below sk) and
// counts a word marked twice; every `check`-th group's cursor is held to
// the plain division of its flat group index. With `words` it also makes
// each word by packed_word_shared and by packed_word, counting those that
// differ, and prints the plane.
template <int ROUNDS>
static int run(char** v) {
  const walk::Plane p = walk::plane_of(arg(v, 0), arg(v, 1), arg(v, 2),
                                       arg(v, 3), arg(v, 4), arg(v, 5));
  const int sms = atoi(v[6]), per_sm = atoi(v[7]);
  const uint32_t salt = arg(v, 8), k0 = arg(v, 9), k1 = arg(v, 10),
                 thr = arg(v, 11);
  const uint64_t check = strtoull(v[12], 0, 10);
  const int words = atoi(v[13]);
  const bool vec = p.sk % walk::WORDS == 0;
  const walk::Launch at = walk::launch_of(p, sms, per_sm);
  const uint64_t rows = uint64_t(p.batch) * p.heads_local * p.sq32;
  const uint64_t total = rows * p.sk;
  const uint64_t gpr = p.gpr;
  std::vector<uint64_t> seen((total + 63) / 64, 0);
  std::vector<uint32_t> plane(words ? total : 0, 0);
  const uint32_t threads = at.ctas * walk::kThreads;
  std::vector<walk::Cursor> cur(threads);
  for (uint32_t i = 0; i < threads; ++i) cur[i] = walk::cursor_at(i, p);
  uint64_t marks = 0, twice = 0, wrong_cursor = 0, wrong_word = 0,
           beyond = 0, groups = 0, steps = 0;
  for (bool live = true; live; ++steps) {
    live = false;
    for (uint32_t i = 0; i < threads; ++i) {
      walk::Cursor& c = cur[i];
      if (c.b >= p.batch) continue;
      live = true;
      if (check && groups % check == 0) {
        const uint64_t g = i + steps * uint64_t(threads);
        const uint64_t row = g / gpr, head = row / p.sq32;
        const uint64_t grp = g - row * gpr;
        if (c.grp != grp || c.q32 != row % p.sq32 ||
            c.h != head % p.heads_local || c.b != head / p.heads_local ||
            c.word != row * p.sk + grp * walk::WORDS)
          ++wrong_cursor;
      }
      ++groups;
      const uint32_t bh = walk::bh_of(c, p);
      const uint32_t k = c.grp * walk::WORDS;
      for (uint32_t j = 0; j < uint32_t(walk::WORDS); ++j) {
        if (!vec && k + j >= p.sk) continue;
        const uint64_t w = c.word + j;
        if (w >= total) { ++beyond; continue; }
        uint64_t& bits = seen[w / 64];
        const uint64_t bit = uint64_t(1) << (w % 64);
        if (bits & bit) ++twice;
        bits |= bit;
        ++marks;
        if (words) {
          plane[w] = packed_word_shared<ROUNDS>(k + j, c.q32, bh, salt, k0,
                                                k1, thr);
          const uint32_t r = uint32_t(w / p.sk);
          if (plane[w] != packed_word<ROUNDS>(r, k + j, p.sq32,
                                              p.heads_local,
                                              p.heads_global, p.bh_offset,
                                              salt, k0, k1, thr))
            ++wrong_word;
        }
      }
      walk::advance(c, at.step, p);
    }
  }
  std::printf("%u %llu %llu %llu %llu %llu %llu %llu\n", at.ctas,
              (unsigned long long)total, (unsigned long long)marks,
              (unsigned long long)twice, (unsigned long long)beyond,
              (unsigned long long)wrong_cursor,
              (unsigned long long)wrong_word, (unsigned long long)steps - 1);
  for (uint32_t w : plane) std::printf("%u\n", w);
  return 0;
}

int main(int argc, char** argv) {
  switch (atoi(argv[1])) {
    case 3: return run<3>(argv + 2);
    case 5: return run<5>(argv + 2);
    case 7: return run<7>(argv + 2);
    case 10: return run<10>(argv + 2);
  }
  return 1;
}
"""


@pytest.fixture(scope="module")
def walker(tmp_path_factory):
    """The host program over csrc/philox_walk.cuh and csrc/philox.cuh,
    built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the walk is compiled from the CUDA headers")
    out = tmp_path_factory.mktemp("philox_walk")
    src = out / "walk.cc"
    src.write_text(WALK_PROGRAM)
    exe = out / "walk"
    subprocess.run([gxx, "-std=c++17", "-O2", f"-I{build.CSRC}", "-o",
                    str(exe), str(src)], check=True)

    def run(shape, sms, per_sm, heads_global=0, bh_offset=0, rounds=7,
            key=(0, 0, 0, 0), check=1, words=False):
        """shape (B, H, SQ, SK) -> (ctas, total words, marks, marked twice,
        beyond the plane, wrong cursors, wrong words, sweeps) and the plane
        (uint32 words, with ``words``)."""
        b, h, sq, sk = shape
        salt, k0, k1, thr = key
        res = subprocess.run(
            [str(exe), str(rounds), str(b), str(h), str(sq // 32), str(sk),
             str(heads_global or h), str(bh_offset), str(sms), str(per_sm),
             str(salt), str(k0), str(k1), str(thr), str(check),
             str(int(words))], check=True, capture_output=True, text=True)
        lines = res.stdout.split("\n")[:-1]
        head = tuple(int(x) for x in lines[0].split())
        plane = np.array(lines[1:], dtype=np.uint64).astype(np.uint32)
        return head, plane
    return run


# (B, H, SQ, SK): the smoke's Philox planes (serving, the QKV training
# plane, TRAIN_SHAPE, moonshot's), its odd SKs (1, 97, 4097; not a
# multiple of the words a thread) and a plane of several waves of the
# persistent grid
PLANES = {
    "serve": (1, 32, 512, 512),
    "qkv": (2, 32, 2048, 2048),
    "train": (1, 32, 4096, 4096),
    "moonshot": (2, 16, 2048, 2048),
    "rows_96": (2, 3, 1024, 96),
    "sk_1": (2, 3, 64, 1),
    "sk_97": (1, 4, 96, 97),
    "sk_6": (1, 2, 64, 6),
    "waves_sk_4097": (3, 5, 2080, 4097),
}
# (label, SMs, CTAs a SM): the persistent grids the kernel may launch on
# an H100 (as many CTAs a SM as its registers allow) and a small one
GRIDS = [("132x1", SMS, 1), ("132x4", SMS, 4), ("132x8", SMS, 8),
         ("7", 7, 1)]


def _expect_once(head, total):
    ctas, n, marks, twice, beyond, wrong_cursor, wrong_word, sweeps = head
    assert n == total
    assert (marks, twice, beyond, wrong_cursor, wrong_word) == (total, 0, 0,
                                                                0, 0)
    return ctas, sweeps


@pytest.mark.parametrize("grid", GRIDS, ids=[g[0] for g in GRIDS])
@pytest.mark.parametrize("name", list(PLANES))
def test_philox_walk_writes_every_word_once(walker, name, grid):
    """Every word of the plane is stored exactly once by the kernel's loop
    on the persistent grid, and each thread's cursor (column group, packed
    row, head, batch row, flat word index) is the plain division of its
    flat group index at every step."""
    b, h, sq, sk = PLANES[name]
    _, sms, per_sm = grid
    total = b * h * (sq // 32) * sk
    ctas, sweeps = _expect_once(walker(PLANES[name], sms, per_sm)[0], total)
    groups = b * h * (sq // 32) * -(-sk // WORDS)
    assert ctas == min(-(-groups // 256), sms * per_sm)
    assert sweeps == -(-groups // (ctas * 256))


@pytest.mark.parametrize("window", [(8, 12), (5, 7), (64, 255)],
                         ids=["8_12", "5_7", "64_255"])
def test_philox_walk_shard_windows(walker, window):
    """Shard-local planes: the same coverage, with the global head rows of
    ``global_bh`` (checked through the words below on small planes)."""
    heads_global, off = window
    shape = (1, 4, 256, 384) if heads_global == 8 else (2, 3, 64, 97)
    total = shape[0] * shape[1] * (shape[2] // 32) * shape[3]
    for sms, per_sm in ((SMS, 4), (7, 1)):
        head, _ = walker(shape, sms, per_sm, heads_global, off)
        _expect_once(head, total)


def test_philox_walk_past_2_31_words(walker):
    """A plane of 4 x 64 x (16384 / 32) x 16385 words, more than 2^31:
    the flat word index (64-bit) stores every word once on the H100's
    persistent grid; the cursors are held to the plain division at every
    4099th group."""
    shape = (4, 64, 16384, 16385)
    total = 4 * 64 * 512 * 16385
    assert total > 2 ** 31
    head, _ = walker(shape, SMS, 4, check=4099)
    _expect_once(head, total)


def _key(p, seed, salt, off=0):
    k0, k1, salt_w, off_w = seed_salt_words(seed, salt, off)
    return (salt_w, k0, k1, threshold_from_p(p)), off_w


@pytest.mark.parametrize("rounds", [3, 5, 7, 10])
@pytest.mark.parametrize("p", [0.0, 0.1, 1.0])
def test_philox_shared_word_equals_plain_and_jax(walker, rounds, p):
    """packed_word_shared on the host, through the kernel's walk, is
    bitwise packed_word, the port's plain plane and JAX's
    ``philox_mask_ref`` (a 64-bit seed; SK odd, so the stores' tail runs)."""
    shape = (2, 3, 64, 97)
    seed, salt = 2 ** 40 + 99 + rounds, rounds * 1000 + 3
    key, _ = _key(p, seed, salt)
    head, got = walker(shape, 7, 1, rounds=rounds, key=key, words=True)
    _expect_once(head, got.size)
    want = philox.philox_dropout_mask_plain(*shape, p, seed, salt, rounds,
                                            device="cpu")
    assert np.array_equal(got, want.numpy().view(np.uint32).reshape(-1))
    ref = np.asarray(philox_mask_ref(*shape, p, seed, salt, rounds))
    assert np.array_equal(got, ref.reshape(-1))


@pytest.mark.parametrize("window", [(8, 12), (5, 7)], ids=["8_12", "5_7"])
def test_philox_shared_word_shard_window(walker, window):
    """A shard-local plane's words are the plain version's for the same
    window, and the tile of a whole (unsharded) plane where the window
    covers whole rows of heads."""
    heads_global, off = window
    shape = (2, 4, 64, 100) if heads_global == 8 else (2, 3, 64, 97)
    seed, salt, p = 2 ** 33 + 5, 9, 0.1
    key, off_w = _key(p, seed, salt, off)
    head, got = walker(shape, SMS, 2, heads_global, off_w, key=key,
                       words=True)
    _expect_once(head, got.size)
    want = philox.philox_dropout_mask_plain(
        *shape, p, seed, salt, heads_global=heads_global, bh_offset=off,
        device="cpu")
    assert np.array_equal(got, want.numpy().view(np.uint32).reshape(-1))
    if heads_global == 8:
        # heads 4..7 of batch row 1 of a (3, 8) plane
        whole = philox_mask_ref(3, 8, 64, 100, p, seed, salt)
        tile = np.asarray(whole)[1:3, 4:8]
        assert np.array_equal(got.reshape(tile.shape), tile)


GRID_SIZES_PROGRAM = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "philox_walk.cuh"
using namespace repro_philox;

// The kernel's loop on every persistent grid of 1 .. max_ctas CTAs (as
// launch_of sizes it from sms = ctas, per_sm = 1): prints each grid size
// on which a word of the plane is stored twice, never, or past its end,
// then the number of grid sizes walked.
int main(int argc, char** argv) {
  const walk::Plane p = walk::plane_of(
      strtoul(argv[1], 0, 10), strtoul(argv[2], 0, 10),
      strtoul(argv[3], 0, 10), strtoul(argv[4], 0, 10),
      strtoul(argv[2], 0, 10), 0);
  const int max_ctas = atoi(argv[5]);
  const bool vec = p.sk % walk::WORDS == 0;
  const uint64_t total = uint64_t(p.batch) * p.heads_local * p.sq32 * p.sk;
  std::vector<unsigned char> seen(total);
  for (int ctas = 1; ctas <= max_ctas; ++ctas) {
    const walk::Launch at = walk::launch_of(p, ctas, 1);
    std::fill(seen.begin(), seen.end(), 0);
    uint64_t marks = 0, twice = 0, beyond = 0;
    for (uint32_t i = 0; i < at.ctas * uint32_t(walk::kThreads); ++i)
      for (walk::Cursor c = walk::cursor_at(i, p); c.b < p.batch;
           walk::advance(c, at.step, p))
        for (uint32_t j = 0; j < uint32_t(walk::WORDS); ++j) {
          if (!vec && c.grp * walk::WORDS + j >= p.sk) continue;
          const uint64_t w = c.word + j;
          if (w >= total) { ++beyond; continue; }
          twice += seen[w];
          seen[w] = 1;
          ++marks;
        }
    if (marks != total || twice || beyond)
      std::printf("grid %d (%u CTAs): %llu of %llu words, %llu twice, "
                  "%llu beyond\n", ctas, at.ctas, (unsigned long long)marks,
                  (unsigned long long)total, (unsigned long long)twice,
                  (unsigned long long)beyond);
  }
  std::printf("%d\n", max_ctas);
  return 0;
}
"""


@pytest.mark.parametrize("shape", [(1, 32, 512, 512), (1, 32, 1024, 1024),
                                   (1, 8, 1024, 4097)],
                         ids=["serve", "1x32x1024", "sk_4097"])
def test_philox_walk_every_grid_size(tmp_path, shape):
    """The kernel sizes its persistent grid on its first launch in a
    process from the occupancy query (``occupancy`` in philox_mask.cu),
    whatever that returns: every grid of 1 to 4 x 132 CTAs (the H100's
    SMs at the 4 CTAs a SM the instance holds) stores every word of the
    plane exactly once -- the smoke's serving plane, where a first launch
    once differed from the plain version on the card, a plane that needs
    more CTAs than fit, and one whose SK is not a multiple of the words a
    thread makes (the scalar stores)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the walk is compiled from the CUDA headers")
    src, exe = tmp_path / "grids.cc", tmp_path / "grids"
    src.write_text(GRID_SIZES_PROGRAM)
    subprocess.run([gxx, "-std=c++17", "-O2", f"-I{build.CSRC}", "-o",
                    str(exe), str(src)], check=True)
    b, h, sq, sk = shape
    res = subprocess.run([str(exe), str(b), str(h), str(sq // 32), str(sk),
                          str(4 * SMS)], check=True, capture_output=True,
                         text=True)
    assert res.stdout.split("\n")[:-1] == [str(4 * SMS)], res.stdout[:2000]
