"""Synthetic LM token pipeline: deterministic zipfian token stream with a
simple induced structure (skip-bigram dependency) so a few hundred training
steps show a falling loss.  A copy of the reference package's
``data/lm_data.py`` (numpy only); the train step takes the arrays as
tensors."""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Infinite batch iterator of {tokens, targets} with fixed shapes."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        # zipfian unigram distribution
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.probs = (1.0 / ranks) / (1.0 / ranks).sum()

    def next_batch(self):
        B, S = self.batch, self.seq_len
        toks = self.rng.choice(self.vocab, size=(B, S + 1), p=self.probs)
        # induce learnable structure: with p=0.5, token t+1 = f(token t)
        copy = self.rng.random((B, S)) < 0.5
        mapped = (toks[:, :-1] * 31 + 7) % self.vocab
        toks[:, 1:][copy] = mapped[copy]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def __iter__(self):
        while True:
            yield self.next_batch()
