"""PyTorch port vs JAX reference on the five dense configurations of
tests/test_torch_configs.py, paged KV caches under pressure: a pool the
requests outgrow (a preemption and its re-admission) and a warm
admission through the prefix cache, whose suffix prefills through the
paged step at C > 1 (OPT reads its position table at the suffix's
positions).  Greedy tokens equal the reference's at tp=2.  Reduced
configs, fp32, the reference's parameters with every bias, norm and
position leaf perturbed off its constant."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

NAMES = ("llama2-7b", "opt-6.7b", "qwen2-72b", "qwen3-1.7b",
         "stablelm-1.6b")
PAGE_SIZE = 8


def _load_both(name, spd, num_pages):
    rcfg = rreplace(rget(name, reduced=True), dtype="float32")
    cfg = replace(get_config(name, reduced=True), dtype="float32")
    canon = perturbed_canonical(rcfg)
    kw = dict(tp=2, spd=spd, cache_len=64, page_size=PAGE_SIZE,
              num_pages=num_pages)
    ref = RLLM.load(rcfg, params=jax.tree.map(jnp.asarray, canon), **kw)
    port = LLM.load(cfg, device="cpu", params=from_reference(canon, cfg),
                    **kw)
    return ref, port


def _run_both(name, spd, num_pages, prompts, max_new):
    ref, port = _load_both(name, spd, num_pages)
    want = ref.generate(prompts, RSP(max_new=max_new))
    got = port.generate(prompts, SamplingParams(max_new=max_new))
    return want, got, port


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("name", ["llama2-7b", "opt-6.7b"])
def test_paged_preemption_tokens_match_reference(name):
    """Four requests on a pool they outgrow: a preemption, and the
    re-admission prefills its suffix through the page table."""
    prompts = _prompts(512, (20, 22, 17, 25), seed=4)
    want, got, port = _run_both(name, 0.5, 9, prompts, 12)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert [o.n_preempted for o in got] == [o.n_preempted for o in want]
    assert port.serve().n_preemptions >= 1
    assert port.serve().pool.num_free == 9


@pytest.mark.parametrize("name", NAMES)
def test_warm_prefix_admission_tokens_match_reference(name):
    """A prompt sharing two whole pages with an earlier one admits warm:
    its suffix prefills through the paged step at C > 1 (OPT reads its
    position table at the suffix's positions)."""
    rng = np.random.default_rng(6)
    shared = rng.integers(0, 512, 19).astype(np.int32)
    pb = np.concatenate([shared, rng.integers(0, 512, 6).astype(np.int32)])
    ref, port = _load_both(name, 0.5, 16)
    for p in (shared, pb):
        want = [o.token_ids for o in ref.generate([p], RSP(max_new=5))]
        got = [o.token_ids for o in port.generate([p],
                                                  SamplingParams(max_new=5))]
        assert got == want
    assert port.serve().kv.prefix_hits == ref.serve().kv.prefix_hits == 1
