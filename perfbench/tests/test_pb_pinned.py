"""Both configurations give, through their model modules, exactly what the
harness gave before a configuration could name its model: the small
cut, every draw, the port's parameter tree, the reference's hidden
states (float32 and the fp8 control), its logits and the judge's gaps,
bit for bit, and the published configurations' counts.  The digests and
counts were computed by the harness in which the decoder's functions
were called directly (sha256 over each tensor's name, shape, dtype and
bytes, in order; one host thread)."""
import hashlib
import json

import numpy as np
import pytest
import torch

from perfbench import modules, port, yardstick as Y
from perfbench.reference import served as RS
from perfbench.reference import weights as RW
from perfbench.tests import small

SEED = 2**31 + 5

PINNED = {
    "qwen2.5-32b.stage16": {
        "config": "ab984b7902e92f2523b91f02",
        "draws": "21b691b41f9e42a5f8d6a649",
        "tree": "84d110427adacc27ae1500ac",
        "hidden": "a59a26e9c58de10fb789e7ff",
        "logits": "436536a1eb7a5ec912d8292e",
        "gaps": "96df4916795937c7e24c4edf",
        # matmul_params_per_token, window_flops(1000, 123457),
        # k1_bytes(1000, 123457, 132), weights' bytes
        "counts": [8579973120, 17200400629760.0, 8596029952.0,
                   18717648896],
    },
    "granite-moe-1b-a400m.unscaled": {
        "config": "33c95bd82d23f6a8e55739ca",
        "draws": "fb16da4b08091d02ec27c765",
        "tree": "aa5f620ba0174b51c87ceec3",
        "hidden": "e862c13f4b664764df465cff",
        "logits": "942935015af4b92525907981",
        "gaps": "ae301ab3ff06462790643e23",
        "counts": [428608512, 869353340928.0, 6231454464.0, 2670829568],
    },
}


def digest(named) -> str:
    h = hashlib.sha256()
    for name, t in named:
        if isinstance(t, torch.Tensor):
            h.update(f"{name}:{list(t.shape)}:{t.dtype}:".encode())
            t = t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
        h.update(np.ascontiguousarray(t).tobytes())
    return h.hexdigest()[:24]


def leaves(tree, pre=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, pre + k + "/")
        else:
            yield pre + k, v


@pytest.mark.parametrize("name", sorted(PINNED))
def test_model_modules_reproduce_the_decoder_bit_for_bit(name):
    torch.set_num_threads(1)
    want = PINNED[name]
    cfg = small.config(name)
    got = {"config": digest([("cfg", np.frombuffer(
        json.dumps(cfg, sort_keys=True).encode(), np.uint8))])}
    w = RW.draw(cfg, SEED, "cpu")
    got["draws"] = digest(list(w.items()))
    got["tree"] = digest(list(leaves(port.params(cfg, w))))
    rng = np.random.default_rng(1)
    seqs = [rng.integers(0, cfg["vocab_size"], n) for n in (37, 5)]
    ref = modules.reference(cfg)
    with torch.no_grad():
        h = ref.hidden(cfg, w, seqs)
        got["hidden"] = digest([("f32", h),
                                ("fp8", ref.hidden(cfg, w, seqs, "fp8"))])
        got["logits"] = digest([("logits", h @ ref.head(cfg, w).float())])
    reqs = [(s[:-6].astype(np.int32), s[-6:].astype(np.int32)) for s in seqs]
    g = RS.served_gaps(cfg, SEED, "cpu", reqs, control=True)
    got["gaps"] = digest([("g", np.concatenate(g["gaps"])),
                          ("c", np.concatenate(g["control_gaps"]))])
    pub = json.loads((modules.HERE / "configs" / f"{name}.json")
                     .read_text())
    got["counts"] = [Y.matmul_params_per_token(pub),
                     Y.window_flops(pub, 1000, 123457),
                     Y.k1_bytes(pub, 1000, 123457, 132), RW.nbytes(pub)]
    assert got == want
