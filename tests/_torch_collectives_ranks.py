"""Rank bodies of ``tests/test_torch_collectives.py``, run by
``repro_torch.launch.mesh.run_spmd`` in spawned gloo ranks on the CPU.
They import only the port and return numpy results."""
import time

import torch

from repro_torch.dist import collectives as C
from repro_torch.dist import peer as PEER
from repro_torch.launch.mesh import make_mesh

SHAPE, AXES = (2, 2), ("data", "model")


def _inputs(rank: int, elems: int, seed: int) -> dict:
    """This rank's operands: ``elems`` values a tensor, seeded by rank."""
    g = torch.Generator().manual_seed(1000 * seed + rank)
    f = torch.randn((4, elems // 4), generator=g)
    return {"f32": f, "bf16": (f * 3).to(torch.bfloat16),
            "i64": torch.randint(-2**40, 2**40, (4, elems // 4),
                                 generator=g),
            "bool": torch.rand((4, elems // 4), generator=g) < 0.5}


def every_op(rank: int, elems: int, seed: int) -> dict:
    """Each data-moving op and each op built on them, on the bound mesh."""
    x = _inputs(rank, elems, seed)
    both = ("data", "model")
    out = {
        "psum_f32": C.psum(x["f32"], both),
        "psum_bf16": C.psum(x["bf16"], both),
        "psum_model": C.psum(x["f32"], "model"),
        "pmax": C.pmax(x["bf16"], "data"),
        "gather_tiled": C.all_gather(x["f32"], "model", dim=1),
        "gather_stacked": C.all_gather(x["bool"], both, dim=0, tiled=False),
        "gather_i64": C.all_gather(x["i64"], "data", dim=0),
        "all_to_all": C.all_to_all(x["i64"], both),
        "reduce_scatter": C.reduce_scatter(x["f32"], both, dim=0),
        "ppermute_swap": C.ppermute(x["bf16"], "data", [(0, 1), (1, 0)]),
        "ppermute_chain": C.ppermute(x["f32"], "model", [(0, 1)]),
    }
    for root in (0, 3):
        got = C.gather_to_root(x["bf16"], root)
        out[f"to_root_{root}"] = (torch.stack(got) if got is not None
                                  else torch.zeros(0))
    return out


def back_to_back(rank: int, n: int) -> list:
    """``n`` collectives in a row of alternating sizes (one past a slot,
    one far below) and groups: every rank, then twice the pairs along
    ``data``.  The odd ranks sleep between each barrier and their reads,
    so a writer runs ahead in its pair while a reader of its last slot
    over every rank has not read it yet: without the read counts it
    would overwrite that slot."""
    big = _inputs(rank, 5 * PEER.SLOT_BYTES // 16, 7)["f32"]
    small = _inputs(rank, 64, 8)["bf16"]
    real = PEER.PeerTransport._barrier

    def slow(*args, **kw):
        out = real(*args, **kw)
        time.sleep(0.002)
        return out
    if rank % 2:
        PEER.PeerTransport._barrier = slow
    try:
        outs = []
        for i in range(n):
            if i % 3 == 0:
                outs.append(C.psum(big * (i + 1), ("data", "model")))
            elif i % 3 == 1:
                outs.append(C.all_gather(small + i, "data", dim=0))
            else:
                outs.append(C.psum(small * i, "data"))
        return outs
    finally:
        PEER.PeerTransport._barrier = real


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy()
    return tree.numpy()


def transports_rank(rank: int, slot_bytes: int, cases, n_back: int) -> dict:
    """The same ops under the gloo transport and the peer buffers over
    shared host memory (slots of ``slot_bytes``); each op's results and
    ``COLLECTIVE_STATS["by_op"]`` per transport."""
    PEER.SLOT_BYTES = slot_bytes
    res = {"rank": rank}
    for transport in ("gloo", "peer"):
        mesh = make_mesh(SHAPE, AXES, "cpu", transport=transport)
        C.reset_stats()
        got = {f"{elems}_{seed}": every_op(rank, elems, seed)
               for elems, seed in cases}
        got["back_to_back"] = back_to_back(rank, n_back)
        res[transport] = dict(
            results=_numpy(got), staged=C.COLLECTIVE_STATS["staged"],
            by_op={k: dict(v) for k, v in C.COLLECTIVE_STATS["by_op"].items()},
            transport=mesh.transport)
    return res
