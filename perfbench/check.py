"""How ``correct`` is decided: what the timed path served, held against
the plain float32 reference.

Every request of the window must come back with ``new_tokens`` ids inside
the vocabulary; one that does not is failed.  Of the requests the window
completed, ``check_per_length`` of each prompt length, drawn from the
seed, are run through the reference once the program's state is freed: the
number compared is the widest gap by which a served token's logit lies
below the reference's best logit at the same position.  The control, the
reference computed in a lower precision in the program's place, is read
by the same number at the same positions (``served_gaps(control=...)``)."""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .generator import seed_words
from .reference.common import MM, exact_float32, f32_mm, last_gaps


class Sample(NamedTuple):
    tokens: np.ndarray      # (length,) prompt
    served: int             # the first served token


def failed(records, vocab: int, new_tokens: int) -> int:
    """Requests of ``records`` whose result is missing or malformed."""
    bad = 0
    for rec in records:
        for req in rec.requests:
            res = req.result
            ok = (res is not None and np.shape(res) == (new_tokens,)
                  and bool(np.all((0 <= res) & (res < vocab))))
            bad += not ok
    return bad


def draw(records, per_length: int, seed: int) -> List[Sample]:
    """``per_length`` requests of each prompt length, drawn from the seed
    among the completed ones that carry a result: the first ``per_length``
    of a permutation, so a smaller draw is the start of a larger one."""
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed_words(seed), 3])))
    by_len = {}
    for rec in records:
        for req in rec.requests:
            if req.result is not None and len(req.result):
                by_len.setdefault(len(req.tokens), []).append(req)
    out = []
    for length in sorted(by_len):
        reqs = by_len[length]
        pick = rng.permutation(len(reqs))[:per_length]
        out += [Sample(np.asarray(reqs[i].tokens), int(reqs[i].result[0]))
                for i in pick]
    return out


def _groups(samples: Sequence[Sample]):
    by_len = {}
    for s in samples:
        by_len.setdefault(len(s.tokens), []).append(s)
    return [by_len[k] for k in sorted(by_len)]


@torch.no_grad()
def served_gaps(ref, model: dict, weights: dict, samples: Sequence[Sample],
                device, control: Optional[MM] = None) -> np.ndarray:
    """Each sample's gap in the reference's float32 logits at the position
    the program served: of the token the program served, or, with
    ``control``, of the token that the reference computed with ``control``
    products in the program's place puts first there."""
    out = []
    with exact_float32():
        for group in _groups(samples):
            toks = torch.as_tensor(np.stack([s.tokens for s in group]),
                                   device=device)
            head = ref.head(weights, model)
            h = ref.hidden(weights, model, toks, f32_mm)[:, -1]
            if control is None:
                served = torch.as_tensor([s.served for s in group],
                                         device=device)
            else:
                low = ref.hidden(weights, model, toks, control)[:, -1]
                served = control(low, head).argmax(-1)
            out.append(last_gaps(h, head, served))
    return torch.cat(out).cpu().numpy() if out else np.zeros(0)
