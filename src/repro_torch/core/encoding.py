"""Cell encoding for the lock-free linear-probing hash table (PyTorch).

The bit-level layout of the paper (Section 4.2): each cell stores a tagged
key ``<v, tag>`` with ``tag in {tentative, final, revalidate}``, or one of
the four key-less states ``EMPTY / TOMBSTONE / DELETED / COLLIDED``, packed
as ``cell = (key << 2) | tag``.

Keys have ``KEY_BITS = 28`` bits, so every cell word — the key-less states
included — is below ``2**30`` and fits a non-negative int32.  The torch
table is therefore an int32 tensor holding exactly the bit patterns of the
JAX package's uint32 table (torch has no shifts on uint32 CPU tensors).
The paper's space accounting (``cell_size_*``) stays in the JAX package
until the simulator is ported (ROADMAP item 23).
"""
from __future__ import annotations

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


def enc(key, tag):
    """Encode ``<key, tag>`` into a cell word (int32 tensor)."""
    k = torch.as_tensor(key).to(torch.int32)
    return (k << 2) | tag


def enc_final(key):
    return enc(key, TAG_FINAL)


def dec_key(cell):
    """The key field of a cell word (== RESERVED_KEY for key-less states)."""
    return torch.as_tensor(cell) >> 2


def dec_tag(cell):
    return torch.as_tensor(cell) & 3


def is_available(cell):
    """EMPTY or TOMBSTONE — claimable by an insert (Algorithm 3, line 43)."""
    return (cell == EMPTY) | (cell == TOMBSTONE)
