"""PyTorch port vs JAX reference: the comm ledger of one prefill and one
decode step, entry for entry (op, axis, per-shard bytes, overlappable,
block, phase), under exact, quant8 and quant4 kept syncs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import (CommPolicy as RComm,  # noqa: E402
                               SPDPlanConfig as RPlan, replace as rreplace)
from repro.configs import get_config as rget  # noqa: E402
from repro.core import model as RM, simtp as RS  # noqa: E402
from repro.parallel.collectives import (MODEL_AXIS,  # noqa: E402
                                        collective_ledger as rledger)
from repro.runtime import forward as RF  # noqa: E402

from repro_torch.config.base import (CommPolicy, SPDPlanConfig,  # noqa: E402
                                     replace)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.parallel.collectives import collective_ledger  # noqa: E402
from repro_torch.runtime import forward as F  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


def _cfgs():
    return (rreplace(rget("smollm-360m", reduced=True), dtype="float32"),
            replace(get_config("smollm-360m-reduced"), dtype="float32"))


def _plans(comm):
    n = 4
    drop = (True, False, False, False)
    if comm == "exact":
        return RPlan(drop), SPDPlanConfig(drop)
    return (RPlan(drop, RComm((comm,) * n, logits_mode="quant8")),
            SPDPlanConfig(drop, CommPolicy((comm,) * n,
                                           logits_mode="quant8")))


@pytest.mark.parametrize("comm", ["exact", "quant8", "quant4"])
def test_comm_ledger_matches_reference(comm):
    """One prefill and one decode step log the same (op, axis, bytes,
    overlappable, block, phase) entries in both packages: the port logs
    a segment's first layer at the segment's scale, as the reference's
    scan traces its body once."""
    rcfg, cfg = _cfgs()
    rplan, plan = _plans(comm)
    tp, cache_len = 2, 48
    canon = RM.init_model(jax.random.PRNGKey(0), rcfg)
    rparams = RS.prepare_params(canon, rcfg, rplan, tp)
    params = simtp.prepare_params(
        from_reference(jax.tree.map(np.asarray, canon), cfg), cfg, plan, tp)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :7] = [5, 9, 2, 400, 17, 3, 8]
    ln = np.asarray([7], np.int32)

    rpre, _ = RF.prefill_step(rcfg, rplan, tp=tp, q_chunk=64,
                              cache_len=cache_len)
    rdec, _ = RF.decode_step(rcfg, rplan, tp=tp)
    with rledger() as rled:
        _, rcaches = jax.vmap(rpre, in_axes=(0, None, None, None),
                              axis_name=MODEL_AXIS)(
            rparams, jnp.asarray(toks), jnp.asarray(ln), None)
        jax.vmap(rdec, in_axes=(0, None, None, 0), axis_name=MODEL_AXIS)(
            rparams, jnp.asarray([[4]], jnp.int32),
            jnp.asarray([7], jnp.int32), rcaches)

    pre, _ = F.prefill_step(cfg, plan, tp=tp, q_chunk=64,
                            cache_len=cache_len)
    dec, _ = F.decode_step(cfg, plan, tp=tp)
    with collective_ledger() as led:
        _, caches = pre(params, torch.from_numpy(toks).long(),
                        torch.from_numpy(ln).long())
        dec(params, torch.tensor([[4]]), torch.tensor([7]), caches)

    def key(e):
        return (e.op, e.axis, e.nbytes, e.overlappable, e.block, e.phase)

    assert [key(e) for e in led] == [key(e) for e in rled]
    assert len(led) > 0
