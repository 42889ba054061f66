"""The mesh's transports (``dist/collectives``, ``dist/peer``,
``launch/mesh``): the placement and transport rules, and the peer
buffers' protocol held bit for bit to gloo on 4 CPU ranks.

On the CPU the peer transport runs over shared host memory: the same
slots, rounds, barriers and chunking that move the payloads through CUDA
IPC buffers on the card (``chip_smoke.py``'s ``collectives`` check holds
them there).  No reduction of any transport uses a backend's: each is a
gather summed in member order, so the bits must be equal."""
import numpy as np
import pytest

import _torch_collectives_ranks as R
from repro_torch.dist import collectives as C
from repro_torch.launch.mesh import card_of, placement, run_spmd


@pytest.mark.parametrize("device,n_cards,cards,where,transport", [
    ("cpu", 0, [0, 0, 0, 0], "shared", "gloo"),
    ("cuda", 1, [0, 0, 0, 0], "shared", "peer"),
    ("cuda", 2, [0, 0, 0, 0], "shared", "peer"),
    ("cuda", 4, [0, 1, 2, 3], "per card", "nccl"),
    ("cuda", 8, [0, 1, 2, 3], "per card", "nccl"),
])
def test_placement_and_transport_rules(device, n_cards, cards, where,
                                       transport):
    """Rank r on card r when the host has a card a rank, else all on card
    0; the transport follows from the cards."""
    placed = [card_of(r, 4, n_cards) for r in range(4)]
    assert placed == cards
    assert placement(4, n_cards) == where
    assert C.transport_for(device, placed) == transport


def test_transport_rule_refuses_a_mixed_placement():
    with pytest.raises(ValueError):
        C.transport_for("cuda", [0, 0, 1, 1])


# slots of 4 KiB: the 12-KiB operands cross in several rounds, the
# all-to-all in rounds of a quarter slot per member
SLOT = 4096
CASES = [(64, 1), (3072, 2), (0, 3)]
BACK_TO_BACK = 50


@pytest.fixture(scope="module")
def transports():
    return run_spmd(R.transports_rank, 4, (SLOT, CASES, BACK_TO_BACK))


def _assert_equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("case", [f"{e}_{s}" for e, s in CASES])
def test_peer_equals_gloo_every_op(transports, case):
    """Every op, payloads below and above a slot and empty: the peer
    buffers give gloo's bits on every rank."""
    for o in transports:
        assert o["gloo"]["transport"] == "gloo"
        assert o["peer"]["transport"] == "peer"
        _assert_equal(o["peer"]["results"][case],
                      o["gloo"]["results"][case], case)


def test_peer_equals_gloo_back_to_back(transports):
    """50 collectives in a row of alternating sizes and groups: no slot is
    overwritten while a peer still reads it."""
    for o in transports:
        got = o["peer"]["results"]["back_to_back"]
        assert len(got) == BACK_TO_BACK
        _assert_equal(got, o["gloo"]["results"]["back_to_back"], "b2b")


def test_peer_counts_the_same_bytes(transports):
    """``COLLECTIVE_STATS``: the same calls and bytes by op in both
    transports, none staged on host tensors."""
    for o in transports:
        assert o["peer"]["by_op"] == o["gloo"]["by_op"]
        assert o["peer"]["staged"] == o["gloo"]["staged"] == 0


def test_every_op_is_right(transports):
    """The gloo results themselves against numpy (so equality to them
    means right): psum is the member sum, all_gather the members' pieces,
    ppermute the partner's tensor, gather_to_root every rank's."""
    inputs = [R._inputs(r, 3072, 2) for r in range(4)]
    f = [x["f32"].numpy() for x in inputs]
    for o in transports:
        rank = o["rank"]
        got = o["gloo"]["results"]["3072_2"]
        total = ((f[0] + f[1]) + f[2]) + f[3]
        np.testing.assert_array_equal(got["psum_f32"], total)
        data, model = divmod(rank, 2)
        np.testing.assert_array_equal(
            got["gather_tiled"],
            np.concatenate([f[2 * data], f[2 * data + 1]], axis=1))
        chain = got["ppermute_chain"]
        np.testing.assert_array_equal(
            chain, f[rank - 1] if model == 1 else np.zeros_like(chain))
        if rank == 3:
            assert got["to_root_3"].shape[0] == 4
