"""PyTorch port vs JAX reference on the five dense configurations of
tests/test_torch_configs.py, with paged KV caches: greedy tokens of
`generate` at tp=2, spd on and off, equal the reference's (OPT's learned
positions read at each paged decode position).  Preemption and warm
prefix admissions: tests/test_torch_configs_prefix.py.  Reduced configs,
fp32, the reference's parameters with every bias, norm and position
leaf perturbed off its constant."""
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


@pytest.mark.parametrize("spd", [0.0, 0.5])
@pytest.mark.parametrize("name", NAMES)
def test_paged_greedy_tokens_match_reference(name, spd):
    prompts = _prompts(512, (5, 17, 30))
    want, got, _ = _run_both(name, spd, 16, prompts, 8)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
