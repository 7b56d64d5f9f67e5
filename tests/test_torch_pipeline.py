"""The port's GPipe schedule (parallel/pipeline.py) over a simulated
"pipe" axis, against the sequential stages and against the reference's
shard_map pipeline on the same inputs (tests/test_server_elastic.py::
test_pipeline_matches_sequential and ::test_pipeline_grads_flow)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.parallel import pipeline as RP
from repro.parallel import tp as RTP
from repro_torch.parallel import pipeline as PP
from repro_torch.parallel.collectives import collective_ledger
from torch_parity import one_torch_thread  # noqa: F401

# fp32 tanh stages; the reference's own tolerances
OUT_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _inputs(n_stages, n_micro, mb, d, seed):
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((n_stages, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    return ws, x


def _port_stage(w, h):
    return torch.tanh(h @ w)        # every stage at once: (n_stages, mb, d)


def _ref_stage(w, h):
    return jnp.tanh(h @ w)


def _ref_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("pipe",))


@pytest.mark.parametrize("n_stages,n_micro", [(4, 8), (2, 3)])
def test_pipeline_matches_sequential_and_reference(n_stages, n_micro):
    ws, x = _inputs(n_stages, n_micro, 2, 16, 0)
    with collective_ledger() as led:
        outs = PP.pipeline_forward(_port_stage, torch.from_numpy(ws),
                                   torch.from_numpy(x), n_stages=n_stages)
    assert outs.shape == (n_stages, n_micro, 2, 16)
    ref = x
    for si in range(n_stages):
        ref = np.tanh(ref @ ws[si])
    np.testing.assert_allclose(outs[-1].numpy(), ref, atol=OUT_ATOL)
    # one stage shift per tick, each one stage's activation
    assert [(e.op, e.axis) for e in led] == \
        [("collective-permute", "pipe")] * (n_micro + n_stages - 1)
    assert {e.nbytes for e in led} == {2 * 16 * 4}

    def run(ws_local, x_all):
        return RP.pipeline_forward(_ref_stage, ws_local[0], x_all,
                                   n_stages=n_stages, axis="pipe")

    f = jax.jit(RTP.shard_map(run, _ref_mesh(n_stages),
                              in_specs=(P("pipe"), P()),
                              out_specs=P("pipe")))
    rout = np.asarray(f(jnp.asarray(ws), jnp.asarray(x))).reshape(
        outs.shape)
    # every stage's stream, the last stage's valid outputs and the
    # fill/drain values of the others alike
    np.testing.assert_allclose(outs.numpy(), rout, atol=OUT_ATOL)


def test_pipeline_grads_match_reference():
    n_stages, n_micro = 2, 4
    ws, x = _inputs(n_stages, n_micro, 2, 8, 1)
    w = torch.from_numpy(ws).requires_grad_()
    out = PP.pipeline_forward(_port_stage, w, torch.from_numpy(x),
                              n_stages=n_stages)
    per_stage = (out ** 2).sum(dim=(1, 2, 3))
    loss = PP.masked_last_stage(per_stage, n_stages=n_stages).sum()
    (g,) = torch.autograd.grad(loss, [w])

    def loss_local(ws_local, x_all):
        return jax.grad(lambda w_: RP.masked_last_stage(
            jnp.sum(RP.pipeline_forward(_ref_stage, w_[0], x_all,
                                        n_stages=n_stages,
                                        axis="pipe") ** 2),
            n_stages=n_stages, axis="pipe"))(ws_local)

    rg = jax.jit(RTP.shard_map(loss_local, _ref_mesh(n_stages),
                               in_specs=(P("pipe"), P()),
                               out_specs=P("pipe")))(jnp.asarray(ws),
                                                     jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=GRAD_ATOL)

    def seq_loss(wt):
        h = torch.from_numpy(x)
        for si in range(n_stages):
            h = torch.tanh(h @ wt[si])
        return (h ** 2).sum()

    (gs,) = torch.autograd.grad(seq_loss(w), [w])
    np.testing.assert_allclose(g.numpy(), gs.numpy(), atol=GRAD_ATOL)


def test_last_stage_value_broadcasts():
    v = torch.arange(6.0).reshape(3, 2)
    with collective_ledger() as led:
        out = PP.last_stage_value(v, n_stages=3)
    torch.testing.assert_close(out, v[2:].expand(3, 2))
    assert [(e.op, e.axis, e.nbytes) for e in led] == \
        [("all-reduce", "pipe", 8)]
