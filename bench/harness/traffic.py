"""The one generator of serving traffic, read from a traffic file.

A traffic file of kind "serve" gives the engine (``slots``, ``max_len``),
the arrivals (``arrival``: {"process": "backlog", "count": n}, every
request submitted as the window opens), the prompt and output lengths
(``prompt``, ``output``: {"dist": "lognormal", "median", "sigma", "min",
"max"} or {"dist": "uniform", "min", "max"}) and the check's sample
(``check_tokens``: served tokens to compare at least).

Every seed gets the same set of (prompt, output) lengths: the i-th of n
is each distribution's quantile at (i + 1/2) / n, paired by a fixed
shuffle; the seed draws the prompts' token ids and the order of
submission.  So two seeds ask the same work of the engine, in another
order and with other tokens."""
from __future__ import annotations

import math
import statistics

import numpy as np

from .common import sub_seed


def quantiles(spec: dict, n: int) -> list[int]:
    """The n lengths of ``spec`` at the quantiles (i + 1/2) / n, clipped."""
    dist = statistics.NormalDist()
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            x = spec["median"] * math.exp(spec["sigma"] * dist.inv_cdf(u))
        elif spec["dist"] == "uniform":
            x = spec["min"] + u * (spec["max"] - spec["min"])
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(int(min(max(round(x), spec["min"]), spec["max"])))
    return out


def requests(tr: dict, seed: int, vocab: int) -> list[dict]:
    """The traffic's requests in order of submission: {"prompt": int64
    token ids, "max_new": new tokens}, ``count`` of them, all submitted as
    the window opens."""
    arr = tr["arrival"]
    if arr["process"] != "backlog":
        raise ValueError(f"unknown arrival process {arr}")
    n = arr["count"]
    prompts = quantiles(tr["prompt"], n)
    outputs = quantiles(tr["output"], n)
    pairing = np.random.default_rng(0).permutation(n)
    pairs = [(prompts[i], outputs[j]) for i, j in enumerate(pairing)]
    rng = np.random.default_rng(sub_seed(seed, "traffic"))
    return [{"prompt": rng.integers(0, vocab, size=pairs[k][0],
                                    dtype=np.int64),
             "max_new": pairs[k][1]}
            for k in rng.permutation(n)]


def check_sample(tr: dict, seed: int, done: dict) -> list[int]:
    """Ids of finished requests ({id: tokens}) to compare: the one
    with the most served tokens, then others drawn from the seed until
    ``check_tokens`` served tokens are in the sample."""
    if not done:
        raise RuntimeError("no request finished in the window")
    ids = sorted(done)
    longest = max(ids, key=lambda i: (len(done[i]), -i))
    rng = np.random.default_rng(sub_seed(seed, "check"))
    rest = [i for i in rng.permutation(ids).tolist() if i != longest]
    out, total = [longest], len(done[longest])
    for i in rest:
        if total >= tr["check_tokens"]:
            break
        out.append(i)
        total += len(done[i])
    return out
