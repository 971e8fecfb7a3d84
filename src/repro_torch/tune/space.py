"""The legal search space of one tuning cell: the knobs the port's kernels
take at run time.

A ``Point`` is one joint choice of:

  * the logical GEMM blocks (bm, bn, bk) of a fused host
    (``kernels/gemm_rng.py``'s ``block_m``/``block_n``/``block_k``): the
    grid the emission layout is judged and partitioned on; at e4m3 ``bk``
    is also the scale tile, so it changes the product. The f32 and bf16
    kernels tile their products on their own (128 x 128, 128 x 256), so
    there the blocks steer the emission alone;
  * the emission column block (``mask_block_cols``);
  * the flash blocks: one value. The flash kernels tile 64 x 64 whatever
    ``block_q``/``block_k`` say (``kernels/flash_attention.py``), so the
    coordinate is kept, with nothing to move to;
  * ``philox_bits``: 8 changes the mask bits themselves and is kept so
    that gate 1 of the search is exercised on every cell.

The space enumerates representable values only (8-aligned divisors, the
caps of ``core/producer``); whether a point is admissible is decided by
the search's gates (``tune/search.py``), never here.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

# caps mirror core/producer's model-path defaults
BLOCK_M_CAP = 256
BLOCK_N_CAP = 256
BLOCK_K_CAP = 512
MASK_COL_CHOICES = (64, 128, 256, 512, 1024, 2048, 4096)
# the flash kernels' one tiling (kernels/flash_attention.KERNEL_TILE)
FLASH_CHOICES = ((64, 64),)
PHILOX_BITS_CHOICES = (32, 8)


@dataclasses.dataclass(frozen=True)
class Point:
    blocks: Tuple[int, int, int]          # (bm, bn, bk)
    mask_cols: int                        # emission column block
    flash: Tuple[int, int]                # (block_q, block_k)
    philox_bits: int


def divisor_choices(dim: int, cap: int) -> List[int]:
    """8-aligned divisors of ``dim`` up to ``cap``, ascending."""
    return [d for d in range(8, min(cap, dim) + 1, 8) if dim % d == 0]


def default_point(m: int, n: int, k: int, sq: int, sk: int) -> Point:
    """The shipped defaults: what an untuned run launches."""
    from repro_torch.core.producer import _largest_divisor
    return Point(
        blocks=(_largest_divisor(m, BLOCK_M_CAP),
                _largest_divisor(n, BLOCK_N_CAP),
                _largest_divisor(k, BLOCK_K_CAP)),
        mask_cols=2048, flash=FLASH_CHOICES[0], philox_bits=32)


def _coord_choices(point: Point, coord: str, m: int, n: int, k: int,
                   sq: int, sk: int) -> List[object]:
    if coord == "bm":
        return divisor_choices(m, BLOCK_M_CAP)
    if coord == "bn":
        return divisor_choices(n, BLOCK_N_CAP)
    if coord == "bk":
        return divisor_choices(k, BLOCK_K_CAP)
    if coord == "mask_cols":
        return [c for c in MASK_COL_CHOICES if sk % min(c, sk) == 0]
    if coord == "flash":
        return [(bq, bkk) for bq, bkk in FLASH_CHOICES
                if sq % bq == 0 and sk % bkk == 0]
    if coord == "philox_bits":
        return list(PHILOX_BITS_CHOICES)
    raise ValueError(coord)


COORDS = ("bm", "bn", "bk", "mask_cols", "flash", "philox_bits")


def with_coord(point: Point, coord: str, value) -> Point:
    if coord == "bm":
        return dataclasses.replace(point,
                                   blocks=(value,) + point.blocks[1:])
    if coord == "bn":
        b = point.blocks
        return dataclasses.replace(point, blocks=(b[0], value, b[2]))
    if coord == "bk":
        return dataclasses.replace(point,
                                   blocks=point.blocks[:2] + (value,))
    if coord == "mask_cols":
        return dataclasses.replace(point, mask_cols=value)
    if coord == "flash":
        return dataclasses.replace(point, flash=value)
    if coord == "philox_bits":
        return dataclasses.replace(point, philox_bits=value)
    raise ValueError(coord)


def neighbors(point: Point, coord: str, m: int, n: int, k: int,
              sq: int, sk: int) -> Iterator[Point]:
    """Coordinate moves: every legal value of ``coord`` other than the
    current one (the per-coordinate lists are short, so a line search a
    coordinate is cheaper than stepping)."""
    cur = {"bm": point.blocks[0], "bn": point.blocks[1],
           "bk": point.blocks[2], "mask_cols": point.mask_cols,
           "flash": point.flash, "philox_bits": point.philox_bits}[coord]
    for v in _coord_choices(point, coord, m, n, k, sq, sk):
        if v != cur:
            yield with_coord(point, coord, v)
