"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held to
the JAX kernels as the JAX package's own tests run them (Pallas in
interpret mode) or to their jnp oracles, on the cases of
tests/test_kernel_{fused,paged_attention,probe}.py.  Tolerances: f32
``1e-5``, bf16 and int8 ``1e-2`` (the plain versions take one softmax over
all tokens, the kernels an online one per page).  The CUDA kernels
themselves run only on the card (``gpu`` marker; ``chip_smoke.py`` holds
them to these plain versions there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as JBT
from repro.kernels import stats as JKS
from repro.kernels.fused_decode import (fused_decode_ref as j_fused_ref,
                                        fused_paged_attention as j_fused)
from repro.kernels.paged_attention import paged_attention_ref as j_pa_ref
from repro.kernels.probe import probe_lookup as j_probe
from repro_torch.core import batched as TBT
from repro_torch.kernels import stats as TKS
from repro_torch.kernels.fused_decode import (block_table_slots_ref,
                                              fused_decode_kernel,
                                              fused_paged_attention,
                                              merge_fused_partials)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_kernel,
                                                 shard_heads)
from repro_torch.kernels.probe import (probe_lookup, probe_lookup_kernel,
                                       resolved_fraction)
from repro_torch.serving.page_table import PageTable

# small tensors: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

TOL = {jnp.float32: 1e-5, jnp.bfloat16: 1e-2}
TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def to_t(x, dtype=None):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def decode_inputs(B, QH, KH, D, NP, PS, MP, seed, holes=False):
    """tests/test_kernel_fused.py's inputs: distinct pages per sequence,
    optionally stale entries past the horizon and -1 holes."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, QH, D)).astype(np.float32)
    k = rng.standard_normal((NP, PS, KH, D)).astype(np.float32)
    v = rng.standard_normal((NP, PS, KH, D)).astype(np.float32)
    pos = rng.integers(0, MP * PS, size=B).astype(np.int32)
    perm = rng.permutation(NP)
    bt = np.full((B, MP), -1, np.int32)
    nxt = 0
    for b in range(B):
        for p in range(MP):
            if p <= pos[b] // PS or (holes and rng.random() < 0.5):
                bt[b, p] = perm[nxt % NP]
                nxt += 1
    return q, k, v, bt, pos


SHAPES = [
    (2, 4, 4, 32, 16, 8, 4),     # dense MHA
    (2, 8, 2, 32, 16, 8, 4),     # GQA G=4
    (3, 4, 1, 16, 32, 4, 8),     # MQA, small pages
    (1, 4, 2, 64, 8, 16, 2),     # single lane, wide head
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_plain_matches_reference(shape, dtype):
    """K1's plain version == the JAX fused kernel's bitwise baseline
    (slots view + Pallas paged attention, interpret mode)."""
    q, k, v, bt, pos = decode_inputs(*shape, seed=sum(shape))
    want = j_fused_ref(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                       jnp.asarray(v, dtype), jnp.asarray(bt),
                       jnp.asarray(pos), interpret=True)
    got = fused_decode_kernel(to_t(q, TDT[dtype]), to_t(k, TDT[dtype]),
                              to_t(v, TDT[dtype]), to_t(bt), to_t(pos))
    assert got.dtype == TDT[dtype]
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def test_fused_stale_rows_int8_and_partials():
    """Stale entries and holes are masked by position; int8 pools with
    bf16 scales; the (o, m, l) partials equal the JAX kernel's and merge
    to the normalized output."""
    q, k, v, bt, pos = decode_inputs(4, 4, 4, 32, 64, 8, 6, seed=3,
                                     holes=True)
    want = j_fused_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(bt), jnp.asarray(pos), interpret=True)
    got = fused_decode_kernel(to_t(q), to_t(k), to_t(v), to_t(bt),
                              to_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    jo, jm, jl = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(bt), jnp.asarray(pos), partials=True,
                         interpret=True)
    o, m, l = fused_decode_kernel(to_t(q), to_t(k), to_t(v), to_t(bt),
                                  to_t(pos), partials=True)
    for a, b in ((o, jo), (m, jm), (l, jl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    merged = merge_fused_partials(o, m, l).reshape(got.shape)
    np.testing.assert_allclose(merged.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)

    rng = np.random.default_rng(7)
    k8 = rng.integers(-127, 128, k.shape).astype(np.int8)
    v8 = rng.integers(-127, 128, v.shape).astype(np.int8)
    sc = [rng.uniform(0.01, 0.2, k.shape[:3]).astype(np.float32)
          for _ in range(2)]
    jsc = tuple(jnp.asarray(s, jnp.bfloat16) for s in sc)
    want = j_fused_ref(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8),
                       jnp.asarray(v8), jnp.asarray(bt), jnp.asarray(pos),
                       scales=jsc, interpret=True)
    got = fused_decode_kernel(to_t(q, torch.bfloat16), to_t(k8), to_t(v8),
                              to_t(bt), to_t(pos),
                              scales=tuple(to_t(s) for s in jsc))
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-2, atol=1e-2)


def _pa_case(rng, B, QH, KH, D, NP, PS, MP):
    q = rng.standard_normal((B, QH, D)).astype(np.float32)
    k = rng.standard_normal((NP, PS, KH, D)).astype(np.float32)
    v = rng.standard_normal((NP, PS, KH, D)).astype(np.float32)
    lens = rng.integers(1, MP * PS + 1, size=B).astype(np.int32)
    ids = np.full((B, MP), -1, np.int32)
    perm = rng.permutation(NP)
    c = 0
    for b in range(B):
        used = -(-int(lens[b]) // PS)
        ids[b, :used] = perm[c:c + used]
        c += used
    return q, k, v, ids, lens


@pytest.mark.parametrize("shape", [(2, 4, 4, 32, 16, 8, 4),
                                   (2, 8, 2, 32, 16, 8, 4),
                                   (1, 4, 1, 16, 32, 16, 8),
                                   (3, 6, 2, 64, 24, 8, 4)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_attention_plain_matches_reference(shape, dtype):
    """K2's plain version == the JAX oracle (MHA/GQA/MQA, G=3 D=64), and at
    single-token and page-boundary lengths."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    q, k, v, ids, lens = _pa_case(rng, *shape)
    PS, MP = shape[5], shape[6]
    tol = TOL[dtype]
    for L in (None, 1, PS, PS + 1, MP * PS):
        ln = lens if L is None else np.full_like(lens, L)
        want = j_pa_ref(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                        jnp.asarray(v, dtype), jnp.asarray(ids),
                        jnp.asarray(ln))
        got = paged_attention_kernel(to_t(q, TDT[dtype]),
                                     to_t(k, TDT[dtype]),
                                     to_t(v, TDT[dtype]), to_t(ids),
                                     to_t(ln))
        np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def test_shard_heads_and_slots_view():
    """shard_heads keeps each query's kv head in its shard; the kernel
    layer's slots view equals the page table's."""
    rng = np.random.default_rng(0)
    q, k, v, ids, lens = _pa_case(rng, 2, 8, 4, 16, 16, 8, 4)
    tq, tk, tv = to_t(q), to_t(k), to_t(v)
    full = paged_attention(tq, tk, tv, to_t(ids), to_t(lens))
    parts = [paged_attention(*(x.contiguous() for x in shard_heads(
        tq, tk, tv, s, 2)), to_t(ids), to_t(lens)) for s in range(2)]
    np.testing.assert_allclose(torch.cat(parts, dim=1).numpy(),
                               full.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        shard_heads(tq, tk, tv, 0, 3)
    bt = to_t(rng.integers(-1, 64, (8, 16)).astype(np.int32))
    pos = to_t(rng.integers(0, 16 * 8, 8).astype(np.int32))
    assert torch.equal(block_table_slots_ref(bt, pos, page_size=8),
                       PageTable.block_table_slots(bt, pos, page_size=8))


def test_fused_byte_accounting_matches_reference():
    """_note_fused_bytes: the raw table read plus only the LIVE pages —
    the same counts as the JAX wrapper's on the same inputs."""
    q, k, v, bt, pos = decode_inputs(2, 4, 4, 32, 16, 8, 4, seed=2,
                                     holes=True)
    with JKS.kernel_stats_scope() as js:
        j_fused(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                jnp.asarray(v, jnp.bfloat16), jnp.asarray(bt),
                jnp.asarray(pos), interpret=True)
        want = dict(js)
    with TKS.kernel_stats_scope() as ts:
        fused_paged_attention(to_t(q, torch.bfloat16),
                              to_t(k, torch.bfloat16),
                              to_t(v, torch.bfloat16), to_t(bt), to_t(pos))
        got = dict(ts)
    assert got == want
    live = np.arange(4)[None, :] * 8 <= pos[:, None]
    assert got["attn_bytes"] == int((live & (bt >= 0)).sum()) * 4 * 8 * 32 * 4


def _table(m, n_keys, seed, rng_seed, delete_every=0):
    """A JAX table and the port's view of the same cells."""
    rng = np.random.default_rng(rng_seed)
    ht = JBT.create(m, seed=seed)
    keys = rng.choice(10 * m, size=n_keys, replace=False).astype(np.uint32)
    ht, ret = JBT.insert_batch(ht, jnp.asarray(keys))
    assert not np.any(np.asarray(ret) == 2)
    if delete_every:
        ht, _ = JBT.delete_batch(ht, jnp.asarray(keys[::delete_every]))
    i32 = torch.int32
    port = TBT.HashTable(
        table=torch.from_numpy(np.asarray(ht.table).astype(np.int32)),
        num_keys=torch.tensor(int(ht.num_keys), dtype=i32),
        num_tombs=torch.tensor(int(ht.num_tombs), dtype=i32),
        seed=torch.tensor(seed, dtype=i32), meta=torch.zeros(0, dtype=i32))
    return ht, port, keys


@pytest.mark.parametrize("m,TB,load", [(512, 256, 0.3), (512, 256, 0.9),
                                       (4096, 2048, 0.7), (4096, 2048, 0.9)])
def test_probe_plain_matches_reference_kernel(m, TB, load):
    """K3's plain version == the JAX probe kernel (interpret) on (found,
    slot), half present and half absent keys, across loads."""
    ht, port, keys = _table(m, int(m * load), 7, m + int(load * 10))
    rng = np.random.default_rng(1)
    qk = np.concatenate([rng.choice(keys, size=256),
                         rng.integers(10 * m, 20 * m, size=256)]).astype(
        np.uint32)
    fj, sj = j_probe(ht, jnp.asarray(qk), TB=TB, interpret=True)
    ft, st = probe_lookup(port, torch.from_numpy(qk.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    assert resolved_fraction(port, qk) == 1.0


def test_probe_tombstones_wrap_and_runs_past_the_window():
    """Tombstones in runs, runs across the end of the table, and one run
    far longer than the TPU kernel's 2*TB window (where the JAX kernel
    falls back to its oracle): the port resolves every key itself."""
    m, TB = 512, 256
    ht, port, keys = _table(m, 400, 3, 42, delete_every=3)
    rng = np.random.default_rng(2)
    qk = np.concatenate([keys, rng.integers(10 * m, 20 * m, size=256)]
                        ).astype(np.uint32)
    fj, sj = j_probe(ht, jnp.asarray(qk), TB=TB, interpret=True)
    ft, st = probe_lookup_kernel(port, torch.from_numpy(qk.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())

    band_t = TBT.create(m, seed=5, device="cpu")
    cand = rng.choice(1 << 27, size=1 << 17, replace=False)
    hv = TBT._hash(band_t, torch.from_numpy(cand)).numpy()
    band = cand[hv < 64]
    assert band.size >= 428
    clustered, absent = band[:300], band[300:428]   # a ~300-cell run
    band_t, ret = TBT.insert_batch(band_t, torch.from_numpy(clustered))
    assert not (ret == 2).any()
    jt = JBT.create(m, seed=5)
    jt, _ = JBT.insert_batch(jt, jnp.asarray(clustered.astype(np.uint32)))
    np.testing.assert_array_equal(np.asarray(jt.table), band_t.table.numpy())
    qk = np.concatenate([clustered, absent])
    fj, sj = j_probe(jt, jnp.asarray(qk.astype(np.uint32)), TB=TB,
                     interpret=True)
    ft, st = probe_lookup(band_t, torch.from_numpy(qk))
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    assert ft[:300].all() and not ft[300:].any()


def test_wrappers_raise_without_a_kernel_and_on_bad_input():
    """A non-CPU tensor goes to the kernel or raises — there is no quiet
    fall back to the plain version; bad dtypes and shapes are refused."""
    meta = dict(device="meta")
    q = torch.empty((2, 4, 32), dtype=torch.bfloat16, **meta)
    kv = torch.empty((8, 4, 2, 32), dtype=torch.bfloat16, **meta)
    bt = torch.empty((2, 4), dtype=torch.int32, **meta)
    pos = torch.empty((2,), dtype=torch.int32, **meta)
    with pytest.raises(RuntimeError):
        fused_decode_kernel(q, kv, kv, bt, pos)
    with pytest.raises(RuntimeError):
        paged_attention_kernel(q, kv, kv, bt, pos)
    i32 = dict(dtype=torch.int32, **meta)
    ht = TBT.HashTable(torch.empty(16, **i32), torch.empty((), **i32),
                       torch.empty((), **i32), torch.zeros((), **i32),
                       torch.empty(0, **i32))
    with pytest.raises(RuntimeError):
        probe_lookup_kernel(ht, torch.empty(4, dtype=torch.int64, **meta))
    cq = torch.zeros((2, 4, 32), dtype=torch.float16)
    ck = torch.zeros((8, 4, 2, 32))
    cbt = torch.zeros((2, 4), dtype=torch.int32)
    cpos = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_decode_kernel(cq, ck, ck, cbt, cpos)
    with pytest.raises(ValueError):
        fused_decode_kernel(cq.float(), ck, ck, cbt.long(), cpos)
    with pytest.raises(ValueError):
        fused_decode_kernel(cq.float(), ck.to(torch.int8), ck.to(torch.int8),
                            cbt, cpos)


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    """On a CUDA device: K1 and K2 within tolerance of their plain
    versions, K1 == the K2 composition bit for bit (also on the edges of
    the split layout), K3 == find_batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    from repro_torch.kernels.fused_decode import (fused_decode_plain,
                                                  fused_decode_ref)
    q, k, v, bt, pos = decode_inputs(8, 48, 8, 128, 600, 16, 64, seed=1,
                                     holes=True)
    args = [to_t(x).cuda() for x in (q, k, v, bt, pos)]
    args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    out = fused_decode_kernel(*args)
    np.testing.assert_allclose(f32(out.cpu()),
                               f32(fused_decode_plain(*args).cpu()),
                               rtol=1e-2, atol=1e-2)
    assert torch.equal(out, fused_decode_ref(*args))
    # split edges: one token; no live token; a split of holes only (at
    # the serve shape's split count, 5 on 132 SMs: two pages a split)
    q, k, v, bt, pos = decode_inputs(8, 48, 8, 128, 600, 16, 64, seed=2,
                                     holes=True)
    pos[:3] = 0, 15, 10 * 16 - 1
    bt[1, 0] = -1
    bt[2, 2:4] = -1
    args = [to_t(x).cuda() for x in (q, k, v, bt, pos)]
    args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    for a, b in zip(fused_decode_kernel(*args, partials=True),
                    fused_decode_plain(*args, partials=True)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-3, atol=2e-3)
    assert torch.equal(fused_decode_kernel(*args), fused_decode_ref(*args))
    _, port, keys = _table(4096, 3600, 7, 0, delete_every=5)
    port = TBT.HashTable(*(t.cuda() for t in port))
    qk = torch.from_numpy(keys.astype(np.int64)).cuda()
    fk, sk = probe_lookup_kernel(port, qk)
    fp, sp = TBT.find_batch(port, qk)
    assert torch.equal(fk, fp) and torch.equal(sk, sp)
