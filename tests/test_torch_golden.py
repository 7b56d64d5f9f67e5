"""PyTorch port: the golden greedy trace (results/golden/).

The reference's golden file was made with `jax_threefry_partitionable`
off: under today's JAX, where the flag defaults to on,
`init_model(seed=0)` draws other parameters and the reference's own
golden tests fail (ROADMAP C1).  Here the reference draws its
parameters with the flag off, the flag is restored, the port takes
those parameters (core/convert.from_reference) and its greedy tokens on
the golden prompts must equal the file's.  The golden file is not
changed."""
import json
import os

import jax
import numpy as np
import pytest

from repro.config.base import replace as rreplace
from repro.configs import get_config as rget
from repro.core import model as RM
from repro_torch.api import LLM, SamplingParams
from repro_torch.config.base import replace
from repro_torch.configs import get_config
from repro_torch.core.convert import from_reference
from torch_parity import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "results", "golden",
                      "smollm-360m-reduced_greedy.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _golden_params(g):
    """The reference's init_model(PRNGKey(seed)) with the flag off, as
    numpy leaves; the flag comes back to what it was."""
    rcfg = rreplace(rget(g["arch"]), dtype=g["dtype"])
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        canon = RM.init_model(jax.random.PRNGKey(g["seed"]), rcfg)
        return jax.tree.map(np.asarray, canon)
    finally:
        jax.config.update("jax_threefry_partitionable", prev)


def test_flag_is_restored(golden):
    prev = jax.config.jax_threefry_partitionable
    _golden_params(golden)
    assert jax.config.jax_threefry_partitionable == prev


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_port_greedy_tokens_equal_the_golden_trace(golden, backend):
    """Both attention paths (the plain attention, and B1's plain version
    on the CPU) give the golden tokens."""
    cfg = replace(get_config(golden["arch"]), dtype=golden["dtype"],
                  attn_backend=backend)
    llm = LLM.load(cfg, tp=golden["tp"], spd=golden["spd"],
                   cache_len=golden["cache_len"], device="cpu",
                   params=from_reference(_golden_params(golden), cfg))
    prompts = [np.asarray(p, np.int32) for p in golden["prompts"]]
    outs = llm.generate(prompts, SamplingParams(max_new=golden["max_new"]))
    assert [o.token_ids for o in outs] == golden["tokens"]
