"""Whether what the timed path produced is correct: the plain reference,
run once the window has closed, against the outputs of the calls sampled
from the window.

For each output and each checked utterance the gap is the relative L2
distance ||out - ref|| / ||ref|| over the utterance (a non-finite output
is an infinite gap).  Per call, ``<output>_worst`` is the largest gap over
its utterances and ``<output>_median`` their median.  The same distance
is taken block by block, over BLOCK consecutive values, and
``<output>_pooled_q<n>`` is the n-th percentile of the block gaps of all
the call's utterances together: a fault in more than 100 - n percent of
the call's blocks moves it, and one utterance whose adaptive state drifted
apart in float32 moves it little.  A number printed for the run is its
largest over the checked calls.  ``checks/<cell>.json`` names the numbers
compared and the limit of each; a call fails where one of its numbers is
over its limit, and the run is correct where none fails.
The reference runs in float64 on the device, once for each distinct pool
batch among the sampled calls.
"""

from __future__ import annotations

import sys

import torch

from portbench.reference.plain import Precision

BLOCK = 256
POOLED = (50, 90)  # the percentiles of all a call's block gaps


def gaps(out: dict, ref: dict) -> dict:
    """{output: (per-utterance relative L2 gap [B], per-block gaps [B,
    blocks])}, float64, inf where out is not finite, for outputs [B, ...]
    against the reference's."""
    res = {}
    for k, r in ref.items():
        o = out[k].detach().to(torch.float64).flatten(1)
        r = r.detach().to(torch.float64).flatten(1)
        bad = ~torch.isfinite(o).all(dim=1)
        n = r.shape[1] // BLOCK * BLOCK
        ob, rb = o[:, :n].reshape(len(o), -1, BLOCK), r[:, :n].reshape(len(r), -1, BLOCK)
        blocks = (ob - rb).norm(dim=-1) / rb.norm(dim=-1).clamp(min=1e-300)
        utt = (o - r).norm(dim=1) / r.norm(dim=1)
        inf = float("inf")
        res[k] = (torch.where(bad, inf, utt), torch.where(bad[:, None], inf, blocks))
    return res


def numbers(g: dict) -> dict:
    """A call's numbers from its per-utterance and per-block gaps."""
    res = {}
    for k, (utt, blocks) in g.items():
        finite = bool(torch.isfinite(utt).all())
        res[f"{k}_worst"] = float(utt.max())
        res[f"{k}_median"] = float(utt.median()) if finite else float("inf")
        for q in POOLED:
            res[f"{k}_pooled_q{q}"] = float(torch.quantile(blocks.flatten(), q / 100)) if finite else float("inf")
    return res


def references(cell, pool: list, batches: list, prec: Precision = Precision()) -> dict:
    """{pool batch: the reference's outputs} for the distinct ``batches``,
    in one reference run over their concatenation."""
    inputs = {k: torch.cat([pool[b][k] for b in batches]) for k in pool[batches[0]]}
    out = cell.reference().run(inputs, cell.config, prec)
    B = cell.traffic["batch"]
    return {b: {k: v[j * B : (j + 1) * B] for k, v in out.items()} for j, b in enumerate(batches)}


def call_numbers(cell, pool: list, samples: list) -> list:
    """Every number of each sampled call [(call index, outputs)]."""
    P = len(pool)
    refs = references(cell, pool, sorted({i % P for i, _ in samples}))
    return [numbers(gaps(out, refs[i % P])) for i, out in samples]


def control_numbers(cell, pool: list, samples: list, prec: Precision) -> list:
    """The same numbers for the control: the reference computed in ``prec``
    put in the program's place, on the sampled calls' batches."""
    P = len(pool)
    batches = sorted({i % P for i, _ in samples})
    refs, ctl = references(cell, pool, batches), references(cell, pool, batches, prec)
    return [numbers(gaps(ctl[i % P], refs[i % P])) for i, _ in samples]


def judge(cell, pool: list, samples: list) -> dict:
    """samples: [(call index, outputs)].  Prints each number compared beside
    its limit as the last lines on standard error; returns {"correct",
    "failed", "numbers": {name: {"value", "limit"}}}."""
    limits = cell.checks["limits"]
    per_call = call_numbers(cell, pool, samples)
    failed = sum(any(not got[name] <= lim for name, lim in limits.items()) for got in per_call)
    shown = {name: {"value": max(got[name] for got in per_call), "limit": lim} for name, lim in limits.items()}
    for name, v in shown.items():
        print(f"check {name} {v['value']:.6e} limit {v['limit']:.6e} over {len(samples)} calls", file=sys.stderr,
              flush=True)
    return {"correct": failed == 0 and len(samples) > 0, "failed": failed, "numbers": shown}
