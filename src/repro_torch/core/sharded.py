"""Mesh-sharded distributed hash table (PyTorch port of
``core/sharded.py``).

The table is hash-partitioned across one mesh axis: the owner shard of a
key is a hash of the key (seed ``SHARD_SEED``), independent of the
within-shard probe hash.  Each rank holds one shard and a batch of
requests; ``routed_apply`` sends every request to its owner with the MoE
dispatch pattern — capacity-bounded bucketing and a tiled all-to-all of
keys, ops and the active mask — applies them there with the batched
engine (``core/batched``: deletes, then inserts, then lookups, with
scatter-min arbitration and tombstone reuse) and routes the results back
by a second all-to-all.  Every key has a single owner, so per-key
operations serialize at the owner: the paper's per-cell atomicity, with
ranks as the processes and the all-to-all as the interconnect.

SPMD: every rank of the axis calls ``apply_fn`` with its own requests;
the collectives are ``dist/collectives``'s (gloo on the host, the peer
buffers or NCCL on the card).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import batched as BT
from repro_torch.core import encoding as E
from repro_torch.core import hashing as H
from repro_torch.core.spec import OP_DELETE, OP_INSERT, OP_LOOKUP
from repro_torch.dist import collectives as C

SHARD_SEED = 0x5EED


class ShardedTable(NamedTuple):
    """Shards stacked on a leading dim: ``[S, ...]`` for the whole table,
    ``[1, ...]`` for the one shard a rank holds."""
    table: torch.Tensor      # int32[S, m_local] (uint32 bits)
    num_keys: torch.Tensor   # int32[S]
    num_tombs: torch.Tensor  # int32[S]
    seed: torch.Tensor       # int32[S]


def create_sharded(num_shards: int, m_local: int, seed: int = 0, *,
                   device=None) -> ShardedTable:
    i32 = dict(dtype=torch.int32, device=device)
    return ShardedTable(
        table=torch.full((num_shards, m_local), E.EMPTY, **i32),
        num_keys=torch.zeros((num_shards,), **i32),
        num_tombs=torch.zeros((num_shards,), **i32),
        seed=torch.full((num_shards,), seed, **i32))


def shard_of(keys, num_shards: int) -> torch.Tensor:
    """Owner shard of each key (independent of the probe hash)."""
    return H.hash_keys(H.as_u32(keys), num_shards, SHARD_SEED)


def _local_view(st: ShardedTable) -> BT.HashTable:
    return BT.HashTable(table=st.table[0], num_keys=st.num_keys[0],
                        num_tombs=st.num_tombs[0], seed=st.seed[0],
                        meta=torch.zeros((0,), dtype=torch.int32,
                                         device=st.table.device))


def _pack_local(ht: BT.HashTable) -> ShardedTable:
    return ShardedTable(table=ht.table[None], num_keys=ht.num_keys[None],
                        num_tombs=ht.num_tombs[None], seed=ht.seed[None])


def routed_apply(st_local: ShardedTable, ops, keys, *, axis_name: str,
                 capacity: int):
    """Apply this rank's requests (ops int32[B], keys [B] read as uint32)
    to the distributed table.  Returns (st_local', ret int32[B],
    overflowed bool[B]): a request beyond ``capacity`` from this rank to
    one shard is not applied and returns -1 (the caller retries it)."""
    dev = st_local.table.device
    ops = torch.as_tensor(ops, dtype=torch.int32, device=dev)
    keys = H.as_u32(torch.as_tensor(keys, device=dev))
    S = C.axis_size(axis_name)
    n = S * capacity

    dest = shard_of(keys, S).to(torch.int64)               # [B]
    onehot = torch.nn.functional.one_hot(dest, S)          # [B, S]
    pos_in_bucket = torch.cumsum(onehot, dim=0) - 1
    pos = torch.gather(pos_in_bucket, 1, dest[:, None])[:, 0]
    ok = pos < capacity
    flat = torch.where(ok, dest * capacity + pos, n)       # n = trash

    def bucket(fill, vals):
        buf = torch.full((n + 1,), fill, dtype=vals.dtype, device=dev)
        buf[flat] = vals
        return buf[:n]

    send_keys = bucket(E.MAX_KEY, keys)
    send_ops = bucket(OP_LOOKUP, ops)
    send_act = bucket(0, ok.to(torch.int32))

    # chunk s of the flat [S * capacity] buffer goes to shard s
    rk = C.all_to_all(send_keys, axis_name)
    rop = C.all_to_all(send_ops, axis_name)
    ract = C.all_to_all(send_act, axis_name) > 0

    ht = _local_view(st_local)
    ht, del_ret = BT.delete_batch(ht, rk, active=ract & (rop == OP_DELETE))
    ht, ins_ret = BT.insert_batch(ht, rk, active=ract & (rop == OP_INSERT))
    look_ret = BT.lookup_batch(ht, rk).to(torch.int32)
    rret = torch.where(rop == OP_DELETE, del_ret,
                       torch.where(rop == OP_INSERT, ins_ret, look_ret))
    rret = torch.where(ract, rret, -1).to(torch.int32)

    back = C.all_to_all(rret, axis_name)
    ret = torch.where(ok, back[torch.where(ok, flat, 0)], -1)
    return _pack_local(ht), ret.to(torch.int32), ~ok


def make_sharded_table(mesh, axis: str, m_global: int, capacity: int,
                       seed: int = 0):
    """This rank's shard of a DHT sharded over ``mesh``'s ``axis`` (the
    bound mesh), on the mesh's device, and ``apply_fn(state, ops, keys) ->
    (state', ret, overflow)`` over this rank's requests."""
    S = mesh.shape[axis]
    if m_global % S:
        raise ValueError(f"m_global={m_global} is not divisible by {S} "
                         f"shards")
    st = create_sharded(1, m_global // S, seed, device=mesh.device)

    def apply_fn(state, ops, keys):
        return routed_apply(state, ops, keys, axis_name=axis,
                            capacity=capacity)

    return st, apply_fn
