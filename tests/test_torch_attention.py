"""The port's attention (recsys_tpu_torch.kernels.attention and the
``sdpa`` / ``FlashAttention`` wrappers of kernels/dispatch.py) against the
JAX package on the CPU: the plain flash forward and backward against the
Pallas kernels in interpret mode at ``Precision.HIGHEST`` with 16 x 16
tiles (several k tiles, a ragged last one at S = 40), the gradient through
``FlashAttention`` against ``jax.grad`` through the JAX ``sdpa``, and the
materialised reference.  The CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: both sides compute in f32 and differ only in the order of
their sums (the online softmax of 16-key tiles against one softmax over
all keys), a few 1e-7 at these sizes (ROADMAP Queue 3): 1e-5, relative
and absolute.  Inputs come from numpy with a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_check
from recsys_tpu.kernels import attention as jax_attn
from recsys_tpu.kernels import dispatch as jax_dispatch
from recsys_tpu.kernels.pallas import attention_tpu
from recsys_tpu_torch.kernels import attention as attn
from recsys_tpu_torch.kernels import dispatch

HIGHEST = jax.lax.Precision.HIGHEST
TOL = dict(rtol=1e-5, atol=1e-5)
B, H, D, TILE = 2, 2, 16, 16


def _inputs(s, mask_kind, seed=0):
    """q, k, v, do (B, H, S, D) f32 and a (B, S) int32 mask or None:
    'random' keeps 3/4 of the keys, 'front-padded' is SASRec's layout with
    one history of S - 13 items and one empty history, so with causal
    masking (and for the empty one always) some query rows have no key to
    attend."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, s, D)).astype(np.float32) for _ in range(4))
    if mask_kind == "none":
        mask = None
    elif mask_kind == "random":
        mask = (rng.random((B, s)) > 0.25).astype(np.int32)
    else:
        lens = np.array([s - 13, 0])
        mask = (np.arange(s)[None, :] >= s - lens[:, None]).astype(np.int32)
    return q, k, v, do, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _jax_fwd(q, k, v, mask, causal):
    return attention_tpu.flash_attention_fwd(
        _j(q), _j(k), _j(v), _j(mask), causal=causal, blk_q=TILE, blk_k=TILE,
        interpret=True, precision=HIGHEST)


CASES = [(s, causal, m) for s in (40, 48) for causal in (False, True)
         for m in ("none", "random", "front-padded")]
IDS = [f"S{s}-{'causal' if c else 'full'}-{m}" for s, c, m in CASES]


@pytest.mark.parametrize("s, causal, mask_kind", CASES, ids=IDS)
def test_flash_fwd_matches_pallas_interpret(s, causal, mask_kind):
    q, k, v, _, mask = _inputs(s, mask_kind)
    out, lse = _jax_fwd(q, k, v, mask, causal)
    got_out, got_lse = attn.flash_attention_fwd(_t(q), _t(k), _t(v), _t(mask), causal)
    assert got_out.dtype == torch.float32 and got_lse.shape == (B, H, s)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), **TOL)
    if mask_kind == "front-padded":
        # rows with no key: 0 and lse = NEG_INF, on both sides
        assert (got_lse[1] == attn.NEG_INF).all() and (got_out[1] == 0).all()


@pytest.mark.parametrize("s, causal, mask_kind", CASES, ids=IDS)
def test_flash_bwd_matches_pallas_interpret(s, causal, mask_kind):
    """The JAX backward kernels read the missing rows of a ragged last tile
    as NaN in interpret mode (its dq, dk and dv come out NaN at S = 40 with
    16-row tiles), so the JAX side runs on inputs padded to a whole tile:
    padded keys are masked out and padded query rows have dO = 0, so they
    add nothing to any gradient."""
    q, k, v, do, mask = _inputs(s, mask_kind)
    out, lse = attn.flash_attention_fwd(_t(q), _t(k), _t(v), _t(mask), causal)
    got = attn.flash_attention_bwd(_t(q), _t(k), _t(v), _t(mask), out, lse, _t(do), causal)
    pad = -s % TILE
    zeros = np.zeros((B, H, pad, D), np.float32)
    qp, kp, vp, dop = (np.concatenate([a, zeros], axis=2) for a in (q, k, v, do))
    maskp = np.ones((B, s), np.int32) if mask is None else mask
    maskp = np.concatenate([maskp, np.zeros((B, pad), np.int32)], axis=1)
    outp, lsep = _jax_fwd(qp, kp, vp, maskp, causal)
    want = attention_tpu.flash_attention_bwd(
        _j(qp), _j(kp), _j(vp), _j(maskp), outp, lsep, _j(dop), causal=causal,
        blk_q=TILE, blk_k=TILE, interpret=True, precision=HIGHEST)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :, :s], **TOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "random", "front-padded"])
def test_sdpa_gradient_matches_jax_grad(causal, mask_kind):
    """``dispatch.sdpa`` (``FlashAttention``: the plain forward and the
    closed-form backward) against ``jax.grad`` through the JAX ``sdpa`` on
    its flash path."""
    q, k, v, do, mask = _inputs(48, mask_kind, seed=1)

    def loss(q_, k_, v_):
        out = jax_dispatch.sdpa(q_, k_, v_, _j(mask), causal=causal, interpret=True,
                                precision=HIGHEST)
        return jnp.sum(out * _j(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = dispatch.sdpa(tq, tk, tv, _t(mask), causal=causal)
    (out * _t(do)).sum().backward()
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_closed_form_backward_equals_autograd_of_the_forward(causal):
    """The written-out backward against autograd through the plain forward,
    on rows that all have a key to attend."""
    q, k, v, do, mask = _inputs(24, "random", seed=2)
    mask[:, 0] = 1
    tq, tk, tv = (_t(a).double().requires_grad_() for a in (q, k, v))
    out, _ = attn.flash_attention_fwd(tq, tk, tv, _t(mask), causal)
    (out * _t(do).double()).sum().backward()
    with torch.no_grad():
        o, lse = attn.flash_attention_fwd(tq, tk, tv, _t(mask), causal)
        got = attn.flash_attention_bwd(tq, tk, tv, _t(mask), o, lse, _t(do).double(), causal)
    for g, w in zip(got, (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_flash_is_within_the_card_limits_of_float64(causal):
    """The plain versions (f32) against the same formulas in float64 at a
    ragged length with front-padded histories, within 1e-5 absolute plus
    1e-5 relative (a one-item history makes dv a sum of 300 rows, of
    magnitude up to about 50): the kernels' limits on the card
    (flash_check.py) leave at least five times that."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((4, 2, 300, 32)).astype(np.float32))
                   for _ in range(4))
    lens = np.array([300, 17, 1, 0])
    mask = torch.from_numpy((np.arange(300)[None, :] >= 300 - lens[:, None]).astype(np.int32))
    out, lse = attn.flash_attention_fwd(q, k, v, mask, causal)
    got = (out, lse, *attn.flash_attention_bwd(q, k, v, mask, out, lse, do, causal))

    q, k, v, do = (t.double() for t in (q, k, v, do))
    keep = attn.keep_mask(mask, 300, 300, causal, q.device)
    s = torch.where(keep, q @ k.transpose(-1, -2) * attn.softmax_scale(32), attn.NEG_INF)
    live = keep.any(-1, keepdim=True)
    lse64 = torch.where(live, torch.logsumexp(s, -1, keepdim=True), attn.NEG_INF)
    p = torch.where(keep & live, torch.exp(s - lse64), 0.0)
    out64 = p @ v
    ds = p * (do @ v.transpose(-1, -2) - (do * out64).sum(-1, keepdim=True))
    want = (out64, lse64[..., 0], ds @ k * attn.softmax_scale(32),
            ds.transpose(-1, -2) @ q * attn.softmax_scale(32), p.transpose(-1, -2) @ do)
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert torch.isclose(g.double(), w, rtol=1e-5, atol=1e-5).all(), name


def test_materialised_sdpa_matches_jax():
    q, k, v, _, mask = _inputs(40, "random", seed=3)
    full = mask[:, None, None, :].astype(bool)
    want = jax_attn.sdpa(_j(q), _j(k), _j(v), _j(full), precision=HIGHEST)
    got = attn.sdpa(_t(q), _t(k), _t(v), _t(full))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_attention_and_launch_nothing():
    dispatch.reset_launches()
    q, k, v, do, mask = (_t(a) for a in _inputs(40, "random", seed=4))
    out, lse = dispatch.flash_attention_fwd(q, k, v, mask, True)
    want = attn.flash_attention_fwd(q, k, v, mask, True)
    torch.testing.assert_close(out, want[0])
    torch.testing.assert_close(lse, want[1])
    got = dispatch.flash_attention_bwd(q, k, v, mask, out, lse, do, True)
    for g, w in zip(got, attn.flash_attention_bwd(q, k, v, mask, out, lse, do, True)):
        torch.testing.assert_close(g, w)
    assert set(dispatch.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("bad, err", [
    (lambda: dispatch.flash_attention_fwd(torch.randn(2, 3, 4), torch.randn(2, 3, 4),
                                          torch.randn(2, 3, 4)), ValueError),
    (lambda: dispatch.flash_attention_fwd(torch.randn(2, 1, 5, 8), torch.randn(2, 1, 6, 8),
                                          torch.randn(2, 1, 6, 8),
                                          torch.ones(2, 5)), ValueError),
    (lambda: dispatch.flash_attention_fwd(*(torch.ones(1, 1, 4, 8, dtype=torch.int32),) * 3),
     TypeError),
    (lambda: dispatch.flash_attention_bwd(*(torch.randn(1, 1, 4, 8),) * 3, None,
                                          torch.randn(1, 1, 4, 8), torch.randn(1, 1, 5),
                                          torch.randn(1, 1, 4, 8)), ValueError),
])
def test_attention_wrappers_refuse_bad_inputs(bad, err):
    with pytest.raises(err):
        bad()


def test_round_tf32_rounds_as_cvt_rna():
    """flash_check.round_tf32 (integer bit operations) against the same
    rounding in float64: to the nearest multiple of 2^(e - 10), ties away from
    zero, over eleven binades, both signs and the halfway cases."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(20000) * 10.0 ** rng.integers(-6, 6, 20000)).astype(np.float32)
    x = np.concatenate([x, np.float32([1 + 2**-11, -(1 + 2**-11), 1 + 2**-11 - 2**-23,
                                       2 - 2**-12, 3.0, 0.0, -2.0])])
    got = flash_check.round_tf32(torch.from_numpy(x)).numpy()
    ax = np.abs(x.astype(np.float64))
    ulp = 2.0 ** (np.floor(np.log2(np.where(ax > 0, ax, 1.0))) - 10)
    want = (np.sign(x) * np.floor(ax / ulp + 0.5) * ulp).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert not (got.view(np.int32) & 0x1FFF).any()
    assert got[-7] == np.float32(1 + 2**-10) and got[-6] == -np.float32(1 + 2**-10)


@pytest.mark.parametrize("mask_kind", flash_check.MASKS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b, h, s, d", [(64, 2, 39, 8), (2, 2, 130, 32)])
def test_every_card_limit_rejects_single_pass_tf32(b, h, s, d, causal, mask_kind):
    """flash_check.check with the plain versions standing in for the kernels
    (CPU tensors): they pass, and every limit rejects each wrong result,
    single-pass TF32 products among them, at AutoInt's S = 39 and over
    several 32-key tiles."""
    rng = np.random.default_rng(11)
    q, k, v, do, mask = flash_check.inputs(rng, b, h, s, d, mask_kind, "cpu")
    res = flash_check.check(q, k, v, do, mask, causal, dispatch.flash_attention_fwd,
                            dispatch.flash_attention_bwd)
    assert res["wrong"]["products in single-pass TF32"]["rejected"], res["wrong"]
    assert res["ok"], res


@pytest.mark.parametrize("causal", [False, True])
def test_float64_reference_matches_the_plain_versions(causal):
    """flash_check.float64_reference, the card's accuracy yardstick, against
    the plain f32 versions, with a history of one item and an empty one."""
    rng = np.random.default_rng(12)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((3, 2, 70, 16)).astype(np.float32))
                   for _ in range(4))
    mask = torch.from_numpy((np.arange(70)[None, :] >= 70 - np.array([70, 1, 0])[:, None])
                            .astype(np.int32))
    want = flash_check.float64_reference(q, k, v, do, mask, causal)
    out, lse = attn.flash_attention_fwd(q, k, v, mask, causal)
    got = dict(zip(("out", "lse", "dq", "dk", "dv"),
                   (out, lse, *attn.flash_attention_bwd(q, k, v, mask, out, lse, do, causal))))
    for name, w in want.items():
        assert w.dtype == torch.float64
        torch.testing.assert_close(got[name].double(), w, rtol=1e-5, atol=1e-5)
