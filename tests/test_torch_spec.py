"""PyTorch port vs JAX reference: self-speculative decoding end to end on
the CPU (reduced SmolLM, tp=2, fp32, the reference's canonical
parameters carried over with `from_reference`).

For a chain round (k = 3), an adaptive budget with tree width 2, dense
and paged, and both under paged-pool preemption: the port's greedy
speculative tokens equal its plain greedy tokens and the reference's
speculative tokens, and `spec_acceptance`, `spec_tokens_per_step`,
`spec_alt_commits`, the round count and the preemptions equal the
reference's (the drafts are argmaxes of fp32 logits that agree within
1e-4, so every acceptance decision is the same).  Tokens and counters
are compared exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import LLM as RLLM  # noqa: E402
from repro.api.scheduler import Request as RRequest  # noqa: E402
from repro.spec import SpecConfig as RSpec  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.api.scheduler import Request  # noqa: E402
from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


MAXNEW = 10
KW = dict(tp=2, dtype="float32", cache_len=64, max_batch=3, q_chunk=64)

CASES = {
    "chain-dense": (dict(k=3), {}),
    "adaptive-tree-paged": (dict(k=3, adaptive=True, k_min=1, k_max=5,
                                 tree_width=2),
                            dict(page_size=4, num_pages=14)),
    "chain-preempt": (dict(k=3), dict(page_size=4, num_pages=10)),
    "adaptive-tree-preempt": (dict(k=3, adaptive=True, k_min=1, k_max=5,
                                   tree_width=2),
                              dict(page_size=4, num_pages=10)),
}


@pytest.fixture(scope="module")
def models():
    """The reference LLM (dense, seed 0), the port LLM on its canonical
    parameters, five prompts of 3-11 tokens, and the port's plain greedy
    tokens (checked against the reference's plain tokens)."""
    ref = RLLM.load("smollm-360m-reduced", engine="sim", **KW)
    cfg = replace(get_config("smollm-360m-reduced"), dtype="float32")
    port = LLM.load(cfg, device="cpu", params=from_reference(
        jax.tree.map(np.asarray, ref.canonical), cfg), **KW)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).astype(np.int32)
               for m in rng.integers(3, 12, 5)]
    plain = [o.token_ids for o in port.generate(prompts,
                                                SamplingParams(max_new=MAXNEW))]
    return ref, port, prompts, plain


def _run(sched, prompts, cls):
    for i, p in enumerate(prompts):
        sched.submit(cls(uid=i, prompt=np.asarray(p), max_new=MAXNEW))
    done = sched.run()
    return [done[i].out for i in range(len(prompts))]


def _counters(s):
    return dict(acceptance=s.spec_acceptance,
                tokens_per_step=s.spec_tokens_per_step,
                alt_commits=s.spec_alt_commits, rounds=s.spec_rounds,
                drafted=s.spec_drafted, preemptions=s.n_preemptions)


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_spec_tokens_and_counters_equal_reference(case, models):
    ref, port, prompts, plain = models
    spec, cache = CASES[case]
    ref.enable_spec(RSpec(draft="all-drop", **spec))
    port.enable_spec(SpecConfig(draft="all-drop", **spec))
    rs, ps = ref.serve(**cache), port.serve(**cache)
    want = _run(rs, prompts, RRequest)
    got = _run(ps, prompts, Request)
    assert got == plain
    assert got == want
    assert _counters(ps) == _counters(rs)
    assert ps.spec_rounds > 0 and ps.spec_tokens_per_step >= 1.0
    if cache:
        ps.pool.check()
        assert ps.pool.num_free == ps.pool.num_pages
        if cache["num_pages"] == 10:
            assert ps.n_preemptions > 0, "the pool was meant to preempt"
    # rows that drafted: every request's own counts add up to the round's
    assert sum(r.n_drafted for r in ps.completed.values()) == ps.spec_drafted
    assert (sum(r.n_draft_accepted for r in ps.completed.values())
            == ps.spec_accepted)


def test_plain_tokens_equal_reference(models):
    ref, _, prompts, plain = models
    ref.disable_spec()
    want = _run(ref.serve(max_batch=3), prompts, RRequest)
    assert plain == want
