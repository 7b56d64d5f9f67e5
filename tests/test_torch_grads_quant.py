"""PyTorch port vs JAX reference: gradients through a quantized kept sync.

The port's `quantized_psum` is an autograd Function whose backward is the
identity (the exact sync's `g_psum`), and its `qdq` passes the gradient
straight through, as the reference's `y = flat + stop_gradient(y -
flat)` does.  `make_grad_fn` on reduced llama2-7b in fp32 (the
reference's parameters with every bias / norm leaf perturbed off its
constant), a plan that keeps every sync under `CommPolicy.uniform(L,
level)`:

  * tp=1: the port's gradients equal the reference's;
  * tp=2: the reference's `quantized_psum` reduces with a plain psum,
    whose transpose re-sums the cotangent over the shards (ROADMAP C5),
    so it is held against the reference with that psum replaced by
    `g_psum` inside the test (no file of the reference changes);
  * the fault this fixes: differentiating the plain round trip (the
    port before the fix) leaves the quant8 gradient of `emb` more than
    50% of its largest value off the reference's.

Tolerances at tp=1 are `tests/test_torch_grads.py`'s: 1e-4 relative plus
1e-5 of each leaf's largest value, losses 1e-5 relative; tp=2's are
stated (and measured) above its test."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import CommPolicy as RComm  # noqa: E402
from repro.config.base import SPDPlanConfig as RPlan  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import simtp as RS  # noqa: E402
from repro.data import synthetic as RD  # noqa: E402
from repro.parallel import collectives as RC  # noqa: E402
from repro.parallel import compression as RCOMP  # noqa: E402

from repro_torch.config.base import (CommPolicy, SPDPlanConfig,  # noqa: E402
                                     replace)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.parallel import compression as C  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


GRAD_RTOL = 1e-4
GRAD_ATOL_FRAC = 1e-5       # of the largest |gradient| of the leaf
LOSS_RTOL = 1e-5
# the fault: without the straight-through path the gradient of `emb` is
# off by most of its scale (98-130% measured before the fix)
BUG_FRAC = 0.5

_SETUP = {}


def _setup():
    if not _SETUP:
        rcfg = rreplace(rget("llama2-7b", reduced=True), dtype="float32")
        cfg = replace(get_config("llama2-7b", reduced=True), dtype="float32")
        canon = perturbed_canonical(rcfg)
        b = RD.calibration_batches(cfg.vocab_size, 2, 24, batch=2)[0]
        _SETUP.update(rcfg=rcfg, cfg=cfg, canon=canon, batch=b,
                      rbatch={k: jnp.asarray(v) for k, v in b.items()})
    return _SETUP


def _plans(n, level):
    return (RPlan.none(n).with_comm(RComm.uniform(n, level)),
            SPDPlanConfig.none(n).with_comm(CommPolicy.uniform(n, level)))


def _reference(rplan, tp):
    s = _setup()
    rsplit = RS.prepare_params(jax.tree.map(jnp.asarray, s["canon"]),
                               s["rcfg"], rplan, tp)
    return RS.make_grad_fn(s["rcfg"], rplan, tp, q_chunk=64)(rsplit,
                                                             s["rbatch"])


def _port(plan, tp):
    s = _setup()
    psplit = simtp.prepare_params(from_reference(s["canon"], s["cfg"]),
                                  s["cfg"], plan, tp)
    return simtp.make_grad_fn(s["cfg"], plan, tp, q_chunk=64)(psplit,
                                                              s["batch"])


def _g_psum_quantized(x, axis, *, bits=8, chunk=RCOMP.DEFAULT_CHUNK,
                      kernel="auto"):
    """The reference's quantized_psum with its reduction through g_psum
    (identity backward) instead of a plain psum: C5 patched."""
    shape, dtype = x.shape, x.dtype
    flat = x.astype(jnp.float32).reshape(-1)
    xq = RCOMP.qdq(flat, bits=bits, chunk=chunk, kernel=kernel)
    s = RC.g_psum(xq, axis)
    out = RCOMP.qdq(s, bits=bits, chunk=chunk, kernel=kernel)
    return out.reshape(shape).astype(dtype)


def _close_leaf(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_FRAC * scale, err_msg=what)


def _close(loss, g, rloss, rg):
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_RTOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(rg)[0]]
    got, want = tree_leaves(g), jax.tree.leaves(rg)
    assert len(got) == len(want)
    for a, b, path in zip(got, want, paths):
        _close_leaf(a, b, path)


@pytest.mark.parametrize("level", ["quant8", "quant4"])
def test_quantized_plan_grads_match_reference_tp1(level):
    """tp=1: both hops' straight-through gradients and the identity
    backward of the one-shard reduction, against the reference's."""
    n = _setup()["cfg"].n_layers
    rplan, plan = _plans(n, level)
    rloss, rg = _reference(rplan, 1)
    loss, g = _port(plan, 1)
    _close(loss, g, rloss, rg)


# tp=2: each shard's partial sum is an fp32 matmul that XLA and torch
# accumulate in other orders, and a partial within an ulp of a rounding
# boundary quantizes to the next code; the step it moves (1/127 of the
# chunk's absmax at quant8, 1/7 at quant4) propagates through the later
# layers.  At quant8 the gradients still agree elementwise to TP2_ATOL of
# each leaf's largest value (measured <= 2.3e-3) and in relative L2 norm
# to TP2_L2 (measured <= 3e-4).  At quant4 the forward itself parts (the
# loss by ~1%), so only each leaf's gradient norm is held, to
# TP2_NORM_RTOL (measured <= 3.5%), against the C5 reference's 9-23x.
TP2_ATOL = {"quant8": 1e-2}
TP2_L2 = {"quant8": 1e-3}
TP2_NORM_RTOL = 0.1
C5_MIN_FACTOR = 5.0


@pytest.mark.parametrize("level", ["quant8", "quant4"])
def test_quantized_plan_grads_match_patched_reference_tp2(level,
                                                          monkeypatch):
    """tp=2 against the reference with C5 patched (its kept sync reduced
    through g_psum, as the port's is); the unpatched reference's
    gradients are C5_MIN_FACTOR times off in norm, which this test tells
    apart from the port's."""
    n = _setup()["cfg"].n_layers
    rplan, plan = _plans(n, level)
    _, c5 = _reference(rplan, 2)
    monkeypatch.setattr(RCOMP, "quantized_psum", _g_psum_quantized)
    rloss, rg = _reference(rplan, 2)
    loss, g = _port(plan, 2)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(rg)[0]]
    for a, b, c, path in zip(tree_leaves(g), jax.tree.leaves(rg),
                             jax.tree.leaves(c5), paths):
        a, b, c = a.detach().numpy(), np.asarray(b), np.asarray(c)
        nb = np.linalg.norm(b)
        assert abs(np.linalg.norm(a) / nb - 1.0) <= TP2_NORM_RTOL, path
        if path == "['emb']" or path.startswith("['segs']"):
            # the leaves before the last kept sync, whose cotangent C5
            # re-sums (the head and the final norm come after it)
            assert np.linalg.norm(c) / nb >= C5_MIN_FACTOR, path
        if level in TP2_ATOL:
            scale = float(np.abs(b).max())
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=TP2_ATOL[level] * scale,
                                       err_msg=path)
            assert np.linalg.norm(a - b) / nb <= TP2_L2[level], path


def test_quant8_emb_grad_without_straight_through_is_wrong(monkeypatch):
    """The fault P3 fixed: with the Functions bypassed (autograd through
    the plain round trip, where round has a zero gradient) the quant8
    gradient of `emb` is more than BUG_FRAC of its largest value off the
    reference's; with them it is within the tolerance above."""
    n = _setup()["cfg"].n_layers
    rplan, plan = _plans(n, "quant8")
    _, rg = _reference(rplan, 1)
    want = np.asarray(rg["emb"])
    scale = float(np.abs(want).max())
    _, g = _port(plan, 1)
    _close_leaf(g["emb"], want, "emb")
    monkeypatch.setattr(C, "_records", lambda x: False)
    _, bad = _port(plan, 1)
    err = float(np.abs(bad["emb"].detach().numpy() - want).max())
    assert err > BUG_FRAC * scale, (err, scale)


def test_kept_sync_backward_is_identity_and_logs_forward_only():
    """The Function's own contract at tp 2: forward the plain two-hop
    value (bit for bit), backward the cotangent unchanged; the ledger
    logs the forward's two hops only."""
    from repro_torch.parallel.collectives import collective_ledger
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 200, generator=gen, requires_grad=True)
    ct = torch.randn(2, 3, 200, generator=gen)
    with collective_ledger() as led:
        y = C.quantized_psum(x, "model", bits=8)
        n_fwd = len(led)
        y.backward(ct)
    assert n_fwd == 2 and len(led) == 2
    with torch.no_grad():
        torch.testing.assert_close(y, C.quantized_psum(x, "model", bits=8),
                                   rtol=0, atol=0)
    torch.testing.assert_close(x.grad, ct, rtol=0, atol=0)
    x.grad = None
    C.qdq(x, bits=4).backward(ct)
    torch.testing.assert_close(x.grad, ct, rtol=0, atol=0)
