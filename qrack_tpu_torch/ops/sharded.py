"""Split-mask helper of the JAX package's ops/sharded.py (the rest of
that module, the pager's exchange and remap programs, waits for the
pager slice)."""

from __future__ import annotations


def split_masks(mask: int, val: int, local_bits: int):
    """(local mask, local value, high mask, high value) of a control
    mask split at ``local_bits``: the low part is tested against an
    index inside a tile, chunk or page, the high part against its id."""
    lmask = mask & ((1 << local_bits) - 1)
    lval = val & ((1 << local_bits) - 1)
    return lmask, lval, mask >> local_bits, val >> local_bits
