"""Whether what the window served is correct: the plain reference over a
sample of the requests the window finished.

The sample is drawn from the seed after the window closes: the finished
request with the longest sequence (prompt and served tokens), the one
that took the most prompt tokens from a slot's cache (where any did),
then others in an order drawn from the seed until ``check.served_tokens``
served tokens or ``check.max_requests`` requests (the mix's keys).  The
reference (the architecture's ``reference``: float32, TF32 off, on the
same blocks drawn again from the seed; llama's is ``reference/model.py``)
runs once over each sampled prompt followed by its served tokens; at each
served token it reads by how much that token's logit lies below the
reference's best there.  The largest such gap over the sample,
``logit_gap_max``, is compared with the cell's limit
(``limits/<cell>.json``).

The control (:func:`gaps` with ``bits``) puts the reference in the
program's place at the precision below the configuration's: 4-bit
activations instead of the W4A8 int8 (``bits=4``); at each position of
the same prompts and tokens it reads the gap of the token that the
control puts first.
"""

from __future__ import annotations

import numpy as np
import torch


def sample(run, seed: int) -> list:
    """The requests the comparison covers (see the module's text)."""
    chk = run.cell.mix["check"]
    done = [r for r in run.requests.values()
            if r.client >= 0 and r.req.done and len(r.tokens) == r.max_new
            and run.in_window(r.times[-1])]
    if not done:
        return []
    pick = [max(done, key=lambda r: (len(r.prompt) + len(r.tokens), r.rid))]
    reused = [r for r in done if r.reuse]
    if reused:
        best = max(reused, key=lambda r: (r.reuse, r.rid))
        if best not in pick:
            pick.append(best)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 4])
    rest = [r for r in sorted(done, key=lambda r: r.rid) if r not in pick]
    for i in rng.permutation(len(rest)):
        if (sum(len(r.tokens) for r in pick) >= chk["served_tokens"]
                or len(pick) >= chk["max_requests"]):
            break
        pick.append(rest[int(i)])
    return pick


def _sequences(reqs: list):
    seqs = [r.prompt + list(r.tokens[:-1]) for r in reqs]
    rows = [list(range(len(r.prompt) - 1, len(r.prompt) - 1
                       + len(r.tokens))) for r in reqs]
    return seqs, rows


def gaps(logits, reqs: list, bits=None) -> list:
    """Per request, the gaps of its served tokens below the float32
    reference's best (and with ``bits``, of the control's first tokens);
    ``logits``: the cell's ``harness.reference``."""
    seqs, rows = _sequences(reqs)
    base = logits(seqs, rows)
    ctrl = logits(seqs, rows, bits=bits) if bits else None
    out = []
    for i, r in enumerate(reqs):
        lg = base[i]
        best = lg.max(dim=-1).values
        served = torch.as_tensor(list(r.tokens), device=lg.device)
        g = best - lg.gather(1, served[:, None])[:, 0]
        top2 = lg.topk(2, dim=-1).values
        item = {"rid": r.rid, "served": len(r.tokens),
                "prompt": len(r.prompt), "reuse": r.reuse,
                "gap_max": float(g.max()),
                "distinct": len(set(r.tokens)),
                "agree": float((g == 0).float().mean()),
                "margin_median": float((top2[:, 0] - top2[:, 1]).median())}
        if ctrl is not None:
            pick = ctrl[i].argmax(dim=-1)
            gc = best - lg.gather(1, pick[:, None])[:, 0]
            item["control_gap_max"] = float(gc.max())
        out.append(item)
    return out


__all__ = ["sample", "gaps"]
