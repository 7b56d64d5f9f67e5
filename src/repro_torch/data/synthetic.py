"""Deterministic synthetic data pipeline (port of
repro/data/synthetic.py, numpy only: the port's own copy, giving the
reference's batches bit for bit from the same seeds).

The repository ships no WikiText2 or zero-shot suites.  We substitute:

* ``SyntheticLM`` — a sparse order-1 Markov source with a planted
  induction pattern (spans are repeated within a sequence), so that a
  small transformer trained on it has real structure to learn: early
  layers learn local bigram statistics, later layers learn the copy /
  induction behaviour.  This makes per-block SPD sensitivity non-uniform,
  which is what the paper's Fig-6-style profile needs.
* ``cloze_suite`` — the zero-shot-accuracy analog: prompts ``... a b ...
  a ?`` scored by whether argmax predicts ``b`` (induction cloze).

Everything is seeded and restartable: the iterator exposes a cursor that
the checkpoint system saves, so resume is bit-exact.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticLM:
    vocab_size: int
    seed: int = 0
    branching: int = 8       # out-degree of the Markov graph
    repeat_p: float = 0.35   # probability a position starts a copied span
    span: int = 8            # copied span length

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        self.next_tokens = rng.integers(0, v, size=(v, self.branching))
        self.next_probs = rng.dirichlet(np.ones(self.branching) * 0.6, size=v)

    def sample(self, rng: np.random.Generator, batch: int, seq: int):
        """Returns tokens (B, S+1) int32 — callers slice inputs/labels."""
        out = np.empty((batch, seq + 1), np.int32)
        for b in range(batch):
            t = rng.integers(0, self.vocab_size)
            buf = np.empty(seq + 1, np.int32)
            i = 0
            while i <= seq:
                if i > 2 * self.span and rng.random() < self.repeat_p:
                    # plant an induction copy: repeat an earlier span
                    start = rng.integers(0, i - self.span)
                    ln = min(self.span, seq + 1 - i)
                    buf[i:i + ln] = buf[start:start + ln]
                    i += ln
                    t = buf[i - 1]
                else:
                    j = rng.choice(self.branching, p=self.next_probs[t])
                    t = self.next_tokens[t, j]
                    buf[i] = t
                    i += 1
            out[b] = buf
        return out


def make_batch_iterator(vocab_size: int, batch: int, seq: int, *,
                        seed: int = 0, start_step: int = 0):
    """Deterministic, resumable batch iterator.

    Yields dicts {"tokens","labels","mask"} of shapes (B,S).  Batch `k` is
    a pure function of (seed, k): resuming from a checkpointed cursor
    reproduces the exact stream.
    """
    src = SyntheticLM(vocab_size, seed=seed)
    step = start_step
    while True:
        rng = np.random.default_rng((seed << 20) ^ step)
        toks = src.sample(rng, batch, seq)
        yield {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((batch, seq), np.float32),
            "_step": step,
        }
        step += 1


def calibration_batches(vocab_size: int, n_samples: int, seq: int, *,
                        source_seed: int = 0, seed: int = 1234,
                        batch: int = 8):
    """The paper's calibration set: n_samples sequences of length seq,
    grouped into mini-batches (each sample is a distillation mini-batch in
    the paper; we batch a few for CPU efficiency).

    `source_seed` selects the LANGUAGE (Markov source) and must match the
    training stream's seed; `seed` only decorrelates the sampled
    sequences (held-out data from the same distribution)."""
    src = SyntheticLM(vocab_size, seed=source_seed)
    rng = np.random.default_rng(seed)
    toks = src.sample(rng, n_samples, seq)
    out = []
    for i in range(0, n_samples, batch):
        t = toks[i:i + batch]
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:],
                    "mask": np.ones((t.shape[0], seq), np.float32)})
    return out


def cloze_suite(vocab_size: int, n: int, seq: int, *, source_seed: int = 0,
                seed: int = 777):
    """Induction-cloze zero-shot tasks: ... a b ... a -> predict b.

    Returns {"tokens" (N,S), "answer" (N,), "query_pos" (N,)}: score
    argmax(logits[query_pos]) == answer.
    """
    src = SyntheticLM(vocab_size, seed=source_seed)
    rng = np.random.default_rng(seed)
    toks = src.sample(rng, n, seq)
    answers = np.empty(n, np.int32)
    qpos = np.empty(n, np.int32)
    for i in range(n):
        a = rng.integers(0, vocab_size)
        b = rng.integers(0, vocab_size)
        j = rng.integers(seq // 4, seq // 2)
        toks[i, j] = a
        toks[i, j + 1] = b
        toks[i, seq - 1] = a      # query: model must recall b
        answers[i] = b
        qpos[i] = seq - 1
    return {"tokens": toks[:, :seq], "answer": answers, "query_pos": qpos}
