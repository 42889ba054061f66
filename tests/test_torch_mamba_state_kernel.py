"""The mamba state-update kernel (``csrc/mamba_state.cu``, wrapper
``kernels/mamba_state``) against its plain version.

On the CPU: ``mamba_decode_step_`` takes the plain path and counts no
kernel bytes; the wrapper refuses CPU tensors, and a shape or dtype the
kernel does not take, before it loads the library.

On the card (``gpu``; skipped without one): at granite-4.0-h-small's layer
shape, a mamba2 smoke shape with two groups, a zamba2-like N and a wide N
with a ragged P, with kept and frozen lanes and signed zeros in ``h``: ``h``
equal bit for bit to the plain path's (frozen lanes untouched), ``y`` within
1e-6 of the sum of magnitudes before the activation dtype's round; one
``mamba_decode_step_`` with the kernel against the plain path (``h`` and the
conv tails bit for bit), waiting for the card nowhere; a K = 8 megastep of
the hybrid stack equal to 8 single steps.  This file imports no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import device as DV
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import mamba_state as MS
from repro_torch.kernels import stats as KS
from repro_torch.models import hybrid, ssm
from repro_torch.serving import engine as EG

torch.set_num_threads(1)

PS = 4


def _inputs(B, G, Hg, P, N, dtype, seed, device="cpu"):
    """The kernel's arguments, drawn with numpy: ``h`` with a share of
    +0.0 and -0.0 entries, lanes 1 and 3 (of 4 or more) frozen."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, G, Hg, P, N)).astype(np.float32)
    zeros = rng.random(h.shape) < 0.1
    h[zeros] = np.where(rng.random(int(zeros.sum())) < 0.5, 0.0, -0.0)
    dtp = np.log1p(np.exp(rng.standard_normal((B, G, Hg)))).astype(
        np.float32)
    A = -np.linspace(1.0, 16.0, G * Hg, dtype=np.float32).reshape(G, Hg)
    dA = np.exp(dtp * A[None]).astype(np.float32)
    keep = np.ones(B, bool)
    keep[1::2] = False

    def t(a, dt=torch.float32):
        return torch.as_tensor(a).to(device=device, dtype=dt)
    return (t(h), t(dA), t(dtp),
            t(rng.standard_normal((B, G * Hg * P)), dtype),
            t(rng.standard_normal((B, 2 * G * N)), dtype),
            t(rng.uniform(0.5, 1.5, G * Hg)), t(keep, torch.bool))


def _bits(t):
    return t.contiguous().view(torch.int32)


# --- the CPU ----------------------------------------------------------------

def test_cpu_step_takes_the_plain_path():
    """On the CPU ``mamba_decode_step_`` never reaches the kernel: no
    launch, no kernel bytes, and the same bits as the plain version."""
    cfg = get_smoke_config("granite-4.0-h-small")
    g = torch.Generator().manual_seed(1)
    p = ssm.mamba_init(cfg, cfg.activation_dtype(), g, "cpu")
    st = ssm.init_mamba_state(cfg, 3, cfg.activation_dtype(), "cpu")
    st.h.normal_(generator=g)
    x = torch.randn((3, 1, cfg.d_model), generator=g).to(
        cfg.activation_dtype())
    keep = torch.tensor([True, False, True])
    launches = MS.mamba_state_kernel.launches
    with KS.kernel_stats_scope() as stats:
        ssm.mamba_decode_step_(p, x, cfg, st, keep)
        assert stats["ssm_state_bytes"] == 0
    assert MS.mamba_state_kernel.launches == launches


# each refusal with the words of its reason: every case but the last is
# refused for its shape or dtype before the device is looked at
REFUSALS = {"N not a multiple of 4": "multiple of 4",
            "N above 256": "multiple of 4",
            "h in float64": "h: torch.float32",
            "activations in float16": "activation dtype",
            "non-contiguous h": "h is not contiguous",
            "keep as int": "keep: torch.bool",
            "tensors on the CPU": "not on a CUDA card"}


def _refused(name):
    args = list(_inputs(2, 1, 2, 4, 16, torch.bfloat16, seed=2))
    h = args[0]
    if name == "N not a multiple of 4":
        args[0] = h[..., :14].contiguous()
    elif name == "N above 256":
        args[0] = h.new_zeros(h.shape[:4] + (260,))
    elif name == "h in float64":
        args[0] = h.double()
    elif name == "activations in float16":
        args[3], args[4] = args[3].half(), args[4].half()
    elif name == "non-contiguous h":
        args[0] = h.transpose(3, 4).contiguous().transpose(3, 4)
    elif name == "keep as int":
        args[6] = args[6].int()
    return args


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_wrapper_refuses_before_loading_the_library(name, monkeypatch):
    def no_library():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(_build, "library", no_library)
    args = _refused(name)
    h0 = args[0].clone()
    with pytest.raises(ValueError,
                       match=f"mamba_state_kernel: .*{REFUSALS[name]}"):
        MS.mamba_state_kernel(*args)
    assert torch.equal(_bits(args[0]), _bits(h0))


# --- the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()


SHAPES = {   # B, G, Hg, P, N
    "granite-4.0-h-small layer": (6, 1, 128, 64, 128),
    "mamba2 smoke, two groups": (5, 2, 4, 16, 16),
    "zamba2-like N": (4, 1, 64, 64, 64),
    "wide N, ragged P": (4, 2, 3, 20, 256),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain_on_the_card(shape, capsys):
    """``h`` bit for bit (frozen lanes untouched); ``y`` in float32
    activations within 1e-6 of ``sum |C h'| + |x D|`` (only the order of
    the sum differs), and through bf16 within one bf16 step more."""
    _card()
    B, G, Hg, P, N = SHAPES[shape]
    for dtype in (torch.float32, torch.bfloat16):
        a = _inputs(B, G, Hg, P, N, dtype, seed=11, device="cuda")
        h0 = a[0].clone()
        b = [t.clone() for t in a]
        launches = MS.mamba_state_kernel.launches
        with KS.kernel_stats_scope() as stats:
            yk = MS.mamba_state_kernel(*a)
            assert stats["ssm_state_bytes"] == 2 * a[0].numel() * 4
        assert MS.mamba_state_kernel.launches == launches + 1
        yp = MS.mamba_state_plain(*b)
        torch.cuda.synchronize()
        assert torch.equal(_bits(a[0]), _bits(b[0])), shape
        frozen = ~a[6]
        assert torch.equal(_bits(a[0][frozen]), _bits(h0[frozen]))
        assert not torch.equal(_bits(a[0][~frozen]), _bits(h0[~frozen]))
        # the scale of each sum: sum |C h'| (a frozen lane's y is
        # dA (C.h) + (C.B) xdt: the scale of its terms), plus the skip
        h, dA, dtp, xs, bc, D, keep = a
        Bm = bc[:, :G * N].float().abs().reshape(B, G, 1, 1, N)
        Cm = bc[:, G * N:].float().abs().reshape(B, G, 1, 1, N)
        xs = xs.float().reshape(B, G, Hg, P)
        ch = (Cm * h.abs()).sum(-1)
        rebuilt = dA[..., None] * ch + (Cm * Bm).sum(-1) \
            * (xs * dtp[..., None]).abs()
        scale = (torch.where(keep[:, None, None, None], ch, rebuilt)
                 + (xs * D.reshape(G, Hg, 1)).abs()).reshape(B, -1)
        err = (yk - yp).abs()
        bound = 1e-6 * scale
        if dtype == torch.bfloat16:
            bound = bound + yp.abs() * 2.0 ** -7
        assert (err <= bound).all(), (shape, dtype, (err / scale).max())
        with capsys.disabled():
            print(f"\n[{shape} {dtype}] {torch.cuda.get_device_name()}: "
                  f"max |y - plain| / scale {(err / scale).max():.3g}")


@pytest.mark.gpu
def test_decode_step_with_the_kernel_equals_plain_on_the_card(monkeypatch):
    """One ``mamba_decode_step_`` of a granite-4.0-h-small layer at its
    widths (bf16, 6 lanes, two frozen): the kernel's path and the plain
    path leave ``h`` and both conv tails the same bits, their outputs
    within a bf16 step; the kernel's call waits for the card nowhere (no
    counted sync, and none outside the helpers under ``strict_syncs``)."""
    _card()
    cfg = get_config("granite-4.0-h-small")
    dt = cfg.activation_dtype()
    g = torch.Generator(device="cuda").manual_seed(5)
    p = ssm.mamba_init(cfg, dt, g, "cuda")
    B = 6
    st = ssm.init_mamba_state(cfg, B, dt, "cuda")
    st.h.normal_(generator=g)
    st.conv_x.normal_(generator=g)
    st.conv_bc.normal_(generator=g)
    x = torch.randn((B, 1, cfg.d_model), generator=g, device="cuda").to(dt)
    keep = torch.tensor([True, False, True, True, False, True],
                        device="cuda")
    st2 = ssm.MambaState(*(t.clone() for t in st))
    kernel = MS.mamba_state_kernel
    launches = kernel.launches
    torch.cuda.synchronize()
    s0 = DV.SYNC_STATS["host_syncs"]
    with DV.strict_syncs():
        out = ssm.mamba_decode_step_(p, x, cfg, st, keep)
    assert DV.SYNC_STATS["host_syncs"] == s0
    assert kernel.launches == launches + 1
    # the plain twin: the same step with the plain version in the
    # kernel's place
    monkeypatch.setattr(MS, "mamba_state_kernel", MS.mamba_state_plain)
    out2 = ssm.mamba_decode_step_(p, x, cfg, st2, keep)
    assert kernel.launches == launches + 1
    for t1, t2 in zip(st, st2):
        assert torch.equal(t1.view(torch.int16 if t1.element_size() == 2
                                   else torch.int32),
                           t2.view(torch.int16 if t2.element_size() == 2
                                   else torch.int32))
    torch.testing.assert_close(out.float(), out2.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
def test_megastep_equals_single_steps_on_the_card():
    """K = 8 megastep == 8 single steps of the hybrid stack on the card,
    both through the kernel (one launch a mamba layer and token step):
    the same tokens and the same final state, bit for bit."""
    _card()
    cfg = dataclasses.replace(get_smoke_config("granite-4.0-h-small"),
                              fused_kernel=True)
    prm = hybrid.init(cfg, torch.Generator(device="cuda").manual_seed(3),
                      "cuda")
    B, K = 3, 8
    tok0 = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32)).cuda()
    s1, _ = EG.make_decode_state(cfg, B, S_max=32, page_size=PS,
                                 device="cuda")
    s2 = EG.clone_state(s1)
    step = EG.make_serve_step(cfg, S_max=32, page_size=PS)
    launches = MS.mamba_state_kernel.launches
    tok, outs = tok0, []
    for _ in range(K):
        logits, s1 = step(prm, s1, tok, s1["pos"])
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        tok = torch.where(s1["aborted"][:, None], tok, nxt)
        outs.append(tok[:, 0])
    n_mamba = cfg.layer_types.count("mamba")
    assert MS.mamba_state_kernel.launches == launches + K * n_mamba
    mtoks, s2 = EG.make_serve_megastep(cfg, S_max=32, K=K, page_size=PS)(
        prm, s2, tok0)
    assert MS.mamba_state_kernel.launches == launches + 2 * K * n_mamba
    assert torch.equal(mtoks, torch.stack(outs, dim=1))
    for k in s1:
        a, b = s1[k], s2[k]
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert torch.equal(x, y), k
