"""The one generator of training batches, read from a traffic file.

A traffic file (``chipbench/traffic/<name>.json``) gives the kind of
stream and its parameters.  Kind ``counting_lm`` is the rule of the
program's ``data/pipeline.py`` ``synthetic_lm_producer``, copied: each
sequence counts upward from a random start (token i+1 = token i + 1 mod
the vocabulary), a share ``noise`` of its positions replaced by random
tokens, so a model can learn from it.  Every (seed, step, row) has its
own stream, so the rows of a step and the steps of a run all differ, and
the same seed gives the same batches.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

KINDS = ("counting_lm",)


def batch(traffic: Dict, seed: int, step: int, rows: int, vocab: int
          ) -> Dict[str, np.ndarray]:
    """{"tokens", "targets"}: (rows, seq_len) int32 for step ``step``."""
    if traffic["kind"] not in KINDS:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    n = traffic["seq_len"] + 1
    out = np.empty((rows, n), dtype=np.int32)
    for r in range(rows):
        rng = np.random.default_rng([seed % (1 << 64), step, r])
        start = rng.integers(0, vocab)
        toks = (start + np.arange(n)) % vocab
        noise = rng.random(n) < traffic["noise"]
        out[r] = np.where(noise, rng.integers(0, vocab, n), toks)
    return {"tokens": np.ascontiguousarray(out[:, :-1]),
            "targets": np.ascontiguousarray(out[:, 1:])}
