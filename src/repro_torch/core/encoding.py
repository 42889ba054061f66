"""Cell encoding for the lock-free linear-probing hash table (PyTorch).

The bit-level layout of the paper (Section 4.2): each cell stores a tagged
key ``<v, tag>`` with ``tag in {tentative, final, revalidate}``, or one of
the four key-less states ``EMPTY / TOMBSTONE / DELETED / COLLIDED``, packed
as ``cell = (key << 2) | tag``.

Keys have ``KEY_BITS = 28`` bits, so every cell word — the key-less states
included — is below ``2**30`` and fits a non-negative int32.  The torch
table is therefore an int32 tensor holding exactly the bit patterns of the
JAX package's uint32 table (torch has no shifts on uint32 CPU tensors).
The helpers take a tensor or a Python int (the simulator decodes its
registers on the host) and return the same kind.  The CAS version's owner
field lives in a parallel int32 array of the simulator (``core/simulator``).

The paper's space accounting (Theorem 1, Table 1) closes the module; it is
analytic and independent of the carrier dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

# ---------------------------------------------------------------------------
# Tags (2 bits).
TAG_TENTATIVE = 0
TAG_FINAL = 1
TAG_REVALIDATE = 2
TAG_SPECIAL = 3  # key == RESERVED: one of the 4 key-less states.
                 # key != RESERVED: CAS-version ``marked`` state.

KEY_BITS = 28
RESERVED_KEY = (1 << KEY_BITS) - 1  # sentinel key value
MAX_KEY = RESERVED_KEY - 1          # usable key domain [0, MAX_KEY]

EMPTY = (RESERVED_KEY << 2) | 0
TOMBSTONE = (RESERVED_KEY << 2) | 1
DELETED = (RESERVED_KEY << 2) | 2
COLLIDED = (RESERVED_KEY << 2) | 3

NO_OWNER = -1


def _word(x):
    return x if isinstance(x, int) else torch.as_tensor(x)


def enc(key, tag):
    """Encode ``<key, tag>`` into a cell word (an int, or an int32
    tensor)."""
    if isinstance(key, int):
        return (key << 2) | tag
    k = torch.as_tensor(key).to(torch.int32)
    return (k << 2) | tag


def enc_tentative(key):
    return enc(key, TAG_TENTATIVE)


def enc_final(key):
    return enc(key, TAG_FINAL)


def enc_revalidate(key):
    return enc(key, TAG_REVALIDATE)


def enc_marked(key):
    """CAS-version marked word; the owner index lives in the parallel
    array."""
    return enc(key, TAG_SPECIAL)


def dec_key(cell):
    """The key field of a cell word (== RESERVED_KEY for key-less states)."""
    return _word(cell) >> 2


def dec_tag(cell):
    return _word(cell) & 3


def val(cell):
    """The paper's ``val(x)``: the key stored in ``x`` or RESERVED_KEY (⊥)."""
    return dec_key(cell)


def has_key(cell, key):
    """Does this cell *contain the key* ``key`` (tentative/final/revalidate/
    marked — Section 5.1's definition)?"""
    return dec_key(cell) == key


def is_available(cell):
    """EMPTY or TOMBSTONE — claimable by an insert (Algorithm 3, line 43)."""
    return (cell == EMPTY) | (cell == TOMBSTONE)


def is_marked(cell):
    c = _word(cell)
    return (dec_tag(c) == TAG_SPECIAL) & (dec_key(c) != RESERVED_KEY)


def restart(cell):
    """The paper's ``restart(x)``: owner should re-validate — true iff
    ``x == <v, revalidate>`` or (CAS) ``x == <<v,*>, marked>``."""
    c = _word(cell)
    is_key = dec_key(c) != RESERVED_KEY
    tag = dec_tag(c)
    return is_key & ((tag == TAG_REVALIDATE) | (tag == TAG_SPECIAL))


# ---------------------------------------------------------------------------
# Space accounting — Theorem 1 / Table 1.

class CellSize(NamedTuple):
    key_bits: int        # ceil(log2(U + 1)) — key + one reserved sentinel
    tag_bits: int        # always 2
    owner_bits: int      # 0 for LL/SC; min(ceil(log m), ceil(log n)) for CAS
    total: int


def _clog2(x: int) -> int:
    return max(1, math.ceil(math.log2(x)))


def cell_size_llsc(U: int) -> CellSize:
    """LL/SC version: ceil(log(U+1)) + 2 bits (Theorem 1)."""
    kb = _clog2(U + 1)
    return CellSize(kb, 2, 0, kb + 2)


def cell_size_cas(U: int, n: int, m: int) -> CellSize:
    """CAS version: + min(ceil(log m), ceil(log n)) owner bits (Theorem 1)."""
    kb = _clog2(U + 1)
    ob = min(_clog2(m), _clog2(n))
    return CellSize(kb, 2, ob, kb + 2 + ob)


def table_bits_llsc(U: int, m: int) -> int:
    """Total table footprint, LL/SC version: m * (ceil(log(U+1)) + 2)."""
    return m * cell_size_llsc(U).total


def table_bits_cas(U: int, n: int, m: int) -> int:
    return m * cell_size_cas(U, n, m).total


# Prior-work cell sizes (Table 1), for the space comparison.
def cell_size_gao(U: int) -> int:
    """[7,14]: tombstones, no reuse: ceil(log U + 2) bits."""
    return _clog2(U) + 2


def cell_size_robinhood(U: int) -> int:
    """[3]: 2 * ceil(log U + 1) + 2 bits (two keys per cell)."""
    return 2 * (_clog2(U) + 1) + 2


def cell_size_shun_blelloch(U: int) -> int:
    """[20]: ceil(log U + 1) bits (phase-concurrent only)."""
    return _clog2(U) + 1


def cell_size_purcell_harris_lower_bound(U: int, timestamp_bits: int = 64) -> int:
    """[18]: probe bounds + unbounded timestamps; any finite run needs at
    least key + probe-bound + 2 timestamps of ``timestamp_bits``."""
    return _clog2(U) + 2 * timestamp_bits + 8
