"""The split (flash-decoding) layout of the port's decode kernels K1 and K2.

The CUDA kernel (``repro_torch/csrc/paged_decode.cu``) splits each
(sequence, kv head)'s live logical pages across ``S`` CTAs and merges the
``S`` partials in a second kernel.  Here, on the CPU:

(a) a Python mirror of the kernel's split-range formula covers every live
    page exactly once over s = 0..S-1, and K1's ``pos`` and K2's
    ``lens = pos + 1`` give the same ranges;
(b) ``merge_split_partials`` applied to ``fused_decode_plain`` run on each
    split's masked block table equals the unsplit plain version within
    ``PARTIALS_TOL`` (the tolerance ``chip_smoke.py`` holds the kernel's f32
    partials to), and the JAX ``fused_decode_ref`` / fused kernel in
    interpret mode on ``test_torch_kernels.py``'s shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_decode import (fused_decode_ref as j_fused_ref,
                                        fused_paged_attention as j_fused)
from repro_torch.kernels.fused_decode import (block_table_slots_ref,
                                              fused_decode_kernel,
                                              fused_decode_plain,
                                              merge_split_partials)
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.kernels.paged_attention.paged_attention import (
    MAX_HEAD_DIM, split_count)
from test_torch_kernels import SHAPES, decode_inputs, f32, to_t

torch.set_num_threads(1)

PARTIALS_TOL = 2e-3          # chip_smoke.py: f32 (o, m, l), atol = rtol
EMPTY_M = float(np.float32(-1e30))   # the empty contract's m, in f32


def split_ranges(ctl, n_offset, PS, MP, S):
    """The kernel's formula: ``n = clamp(ctl + n_offset, 0, MP*PS)`` tokens
    (K1: ctl = pos, n_offset = 1; K2: ctl = lens, n_offset = 0),
    ``P = ceil(n/PS)`` live logical pages, ``pps = ceil(P/S)``; split s
    takes pages [s*pps, min(P, (s+1)*pps)), empty when the start is past P.
    """
    n = max(0, min(int(ctl) + n_offset, MP * PS))
    P = -(-n // PS)
    pps = -(-P // S)
    return [(s * pps, min(P, s * pps + pps)) for s in range(S)]


def live_pages(bt_row, pos, PS):
    """K1's liveness: p*PS <= pos and a present entry."""
    return {p for p, pid in enumerate(bt_row) if p * PS <= pos and pid >= 0}


def _cases():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(300):
        PS = int(rng.choice([1, 4, 16, 256]))
        MP = int(rng.integers(1, 40))
        S = int(rng.integers(1, 12))
        out.append((PS, MP, S, int(rng.integers(-1, MP * PS + 3))))
    # pos = 0; pos on the last token of a split; empty tail splits (S > P)
    out += [(16, 64, 5, 0), (16, 64, 5, 4 * 16 * 4 - 1), (16, 64, 7, 31),
            (4, 8, 3, 3 * 4 - 1), (256, 16, 9, 300), (16, 1, 4, 15)]
    return out


@pytest.mark.parametrize("holes", [False, True])
def test_split_ranges_cover_every_live_page_once(holes):
    """Over random pos/PS/MP/S (and edge cases), the splits are disjoint,
    in order, and cover exactly the pages below ceil((pos+1)/PS); the live
    pages of a row with -1 holes are each in exactly one split (a split
    may hold only holes); K2's lens = pos + 1 gives the same ranges."""
    rng = np.random.default_rng(1)
    for PS, MP, S, pos in _cases():
        k1 = split_ranges(pos, 1, PS, MP, S)
        assert k1 == split_ranges(pos + 1, 0, PS, MP, S)
        bt = rng.integers(0, 1000, MP)
        if holes:
            bt[rng.random(MP) < 0.4] = -1
        covered = [p for a, b in k1 for p in range(a, b)]
        assert covered == sorted(set(covered))
        n = max(0, min(pos + 1, MP * PS))
        assert covered == list(range(-(-n // PS)))
        live = live_pages(bt, pos, PS)
        hits = [sum(a <= p < b for a, b in k1) for p in sorted(live)]
        assert all(h == 1 for h in hits)
        # a split past the last live page is empty
        for a, b in k1:
            assert a <= b or a >= -(-n // PS)
    # the hand-picked edges: pos = 0 -> one page in split 0, rest empty
    assert split_ranges(0, 1, 16, 64, 5) == [(0, 1)] + [(1, 1), (2, 1),
                                                       (3, 1), (4, 1)]
    # pos on the last token of split 3 (4 pages each): it ends there
    assert split_ranges(16 * 16 - 1, 1, 16, 64, 5)[3] == (12, 16)
    # a range holding only holes is still one split's range
    bt = np.full(8, -1)
    bt[0] = 3
    r = split_ranges(8 * 4 - 1, 1, 4, 8, 4)
    assert r[1] == (2, 4) and not live_pages(bt, 31, 4) & {2, 3}


def test_split_count_from_static_shapes():
    """S fills about two CTAs per SM and covers at most 512 token slots of
    the table row a split, within [1, min(MP, 16)]: at the serve shape
    (B=8, KH=8, MP=64, PS=16) on 132 SMs it is 5 (320 CTAs); at the long
    context shape (B=64, MP=256, PS=16: 4096 slots) it is 8."""
    assert split_count(8, 8, 64, 16, 132) == 5
    assert split_count(64, 8, 256, 16, 132) == 8
    assert split_count(1, 1, 3, 16, 132) == 3          # one per page
    assert split_count(1, 1, 4096, 16, 132) == 16      # at most 16
    assert split_count(512, 8, 4, 16, 132) == 1
    for B, KH, MP, PS in [(2, 4, 4, 8), (3, 1, 8, 4), (8, 8, 64, 16)]:
        S = split_count(B, KH, MP, PS, 132)
        assert 1 <= S <= MP


def _split_partials(q, k, v, bt, pos, S):
    """fused_decode_plain(partials=True) on each split's masked table."""
    B, MP = bt.shape
    PS = k.shape[1]
    os_, ms, ls = [], [], []
    for s in range(S):
        mask = torch.zeros_like(bt, dtype=torch.bool)
        for b in range(B):
            a, e = split_ranges(int(pos[b]), 1, PS, MP, S)[s]
            mask[b, a:max(a, e)] = True
        o, m, l = fused_decode_plain(q, k, v, torch.where(mask, bt, -1), pos,
                                     partials=True)
        os_.append(o)
        ms.append(m)
        ls.append(l)
    return torch.stack(os_), torch.stack(ms), torch.stack(ls)


@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_merge_split_partials_matches_unsplit_and_jax(shape, S):
    """Merged split partials == the unsplit plain version (PARTIALS_TOL),
    == the JAX fused kernel's partials and fused_decode_ref (interpret),
    with a sequence whose first page is absent (bt[b,0] = -1) and one with
    no live token at all (m = -1e30, l = 0, o = 0)."""
    q, k, v, bt, pos = decode_inputs(*shape, seed=sum(shape) + S,
                                     holes=True)
    bt[0, 0] = -1
    if bt.shape[0] > 1:
        pos[-1] = 0
        bt[-1, 0] = -1                   # no live token
    tq, tk, tv, tbt, tpos = to_t(q), to_t(k), to_t(v), to_t(bt), to_t(pos)
    o, m, l = merge_split_partials(*_split_partials(tq, tk, tv, tbt, tpos,
                                                    S))
    want = fused_decode_plain(tq, tk, tv, tbt, tpos, partials=True)
    for a, b in zip((o, m, l), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=PARTIALS_TOL,
                                   atol=PARTIALS_TOL)
    jo, jm, jl = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(bt), jnp.asarray(pos), partials=True,
                         interpret=True)
    for a, b in ((o, jo), (m, jm), (l, jl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=PARTIALS_TOL, atol=PARTIALS_TOL)
    if bt.shape[0] > 1:
        assert float(m[-1].max()) == EMPTY_M
        assert not l[-1].any() and not o[-1].any()
    B, QH, D = q.shape
    norm = torch.where(l > 0, 1.0 / l.clamp_min(1e-30), torch.zeros_like(l))
    got = (o * norm[..., None]).reshape(B, QH, D)
    jref = j_fused_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(bt), jnp.asarray(pos), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref),
                               rtol=PARTIALS_TOL, atol=PARTIALS_TOL)


def test_merge_split_partials_order_and_empty_splits():
    """The merge takes m = max m_s and weights w_s = exp(m_s - m) in the
    order s = 0..S-1; empty splits (m = -1e30, l = 0, o = 0) add nothing,
    and all-empty gives the empty contract back."""
    rng = np.random.default_rng(4)
    o_s = torch.from_numpy(rng.standard_normal((3, 2, 1, 2, 4))
                           .astype(np.float32))
    m_s = torch.from_numpy(rng.standard_normal((3, 2, 1, 2))
                           .astype(np.float32))
    l_s = torch.from_numpy(rng.uniform(0.5, 2, (3, 2, 1, 2))
                           .astype(np.float32))
    o_s[1], m_s[1], l_s[1] = 0.0, -1e30, 0.0
    o, m, l = merge_split_partials(o_s, m_s, l_s)
    two = merge_split_partials(o_s[[0, 2]], m_s[[0, 2]], l_s[[0, 2]])
    for a, b in zip((o, m, l), two):
        assert torch.equal(a, b)
    mm = torch.maximum(m_s[0], m_s[2])
    w0, w2 = torch.exp(m_s[0] - mm), torch.exp(m_s[2] - mm)
    torch.testing.assert_close(l, w0 * l_s[0] + w2 * l_s[2])
    empty = merge_split_partials(torch.zeros_like(o_s),
                                 torch.full_like(m_s, -1e30),
                                 torch.zeros_like(l_s))
    assert float(empty[1].max()) == EMPTY_M
    assert not empty[0].any() and not empty[2].any()


def test_head_dim_bound_is_refused():
    """The kernel keeps ceil(D/32) dims per lane in registers: D above
    MAX_HEAD_DIM is refused by both wrappers, on any device."""
    D = MAX_HEAD_DIM + 32
    q = torch.zeros((2, 4, D))
    kv = torch.zeros((8, 4, 2, D))
    rows = torch.zeros((2, 4), dtype=torch.int32)
    ctl = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        fused_decode_kernel(q, kv, kv, rows, ctl)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention_kernel(q, kv, kv, rows, ctl)
    # D = 16 and D = 8 (the --smoke configs) are taken
    for d in (8, 16):
        q, k, v, bt, pos = decode_inputs(2, 4, 2, d, 16, 4, 4, seed=d)
        out = fused_decode_kernel(to_t(q), to_t(k), to_t(v), to_t(bt),
                                  to_t(pos))
        slots = block_table_slots_ref(to_t(bt), to_t(pos), page_size=4)
        ref = paged_attention_kernel(to_t(q), to_t(k), to_t(v), slots,
                                     to_t(pos) + 1)
        np.testing.assert_allclose(f32(out), f32(ref), rtol=1e-5,
                                   atol=1e-5)
