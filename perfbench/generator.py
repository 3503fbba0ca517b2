"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a seed give the batches a run offers, in order.

A mix of kind ``closed_batches`` repeats a cycle that holds
``batches_per_cycle[i]`` batches of ``batch`` prompts of ``lengths[i]``
tokens.  The seed shuffles the order inside each cycle and draws the token
ids; it never changes the cycle's contents, so every seed offers the same
work in the same proportions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

KINDS = ("closed_batches",)


@dataclass(frozen=True)
class Batch:
    index: int              # position in the run's order, from 0
    cycle: int
    length: int             # prompt tokens of each request
    tokens: np.ndarray      # (batch, length) int32

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.size)


def check_mix(mix: dict) -> None:
    """Raises ``ValueError`` on a mix this generator cannot run."""
    if mix.get("kind") not in KINDS:
        raise ValueError(f"traffic kind {mix.get('kind')!r}: known {KINDS}")
    lengths, counts = mix["lengths"], mix["batches_per_cycle"]
    if len(lengths) != len(counts) or not lengths:
        raise ValueError("lengths and batches_per_cycle differ in length")
    if any(int(n) < 1 for n in lengths + counts):
        raise ValueError("lengths and batches_per_cycle must be positive")
    for key in ("batch", "new_tokens", "in_flight", "check_per_length"):
        if int(mix[key]) < 1:
            raise ValueError(f"{key} must be positive")


def seed_words(seed: int) -> int:
    """Any whole number as the unsigned 64-bit word both torch's and
    numpy's generators take."""
    return int(seed) % (1 << 64)


def cycle_lengths(mix: dict) -> List[int]:
    """One cycle's prompt lengths, unshuffled."""
    return [int(n) for n, c in zip(mix["lengths"], mix["batches_per_cycle"])
            for _ in range(int(c))]


def cycle_order(mix: dict, seed: int, cycle: int) -> List[int]:
    """The lengths of cycle ``cycle`` in the order this seed gives."""
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed_words(seed), 0, cycle])))
    lengths = cycle_lengths(mix)
    return [lengths[i] for i in rng.permutation(len(lengths))]


def tokens(mix: dict, vocab: int, seed: int, index: int, length: int,
           stream: int = 1) -> np.ndarray:
    """The prompts of batch ``index`` of ``stream`` (1 measured, 2 and 3
    warm-up): (batch, length) ids in [0, vocab), drawn from the seed, the
    stream and the batch's index alone."""
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed_words(seed), stream, index])))
    return rng.integers(0, vocab, (int(mix["batch"]), length),
                        dtype=np.int32)


def batches(mix: dict, vocab: int, seed: int, first_cycle: int = 0,
            stream: int = 1) -> Iterator[Batch]:
    """Every batch of ``stream`` from cycle ``first_cycle`` on, cycle after
    cycle, without end: the measured run's (1), or the warm-up's cycles
    (3), whose ids are apart from the measured batches'."""
    check_mix(mix)
    cycle = first_cycle
    index = cycle * len(cycle_lengths(mix))
    while True:
        for length in cycle_order(mix, seed, cycle):
            yield Batch(index, cycle, length,
                        tokens(mix, vocab, seed, index, length, stream))
            index += 1
        cycle += 1


def warmup_batches(mix: dict, vocab: int, seed: int) -> List[Batch]:
    """``in_flight`` batches of each length, shortest first: every shape
    the cell's traffic uses, on every client.  Their ids come from a stream
    of their own, apart from the measured batches'."""
    out = []
    for length in sorted(set(int(n) for n in mix["lengths"])):
        for _ in range(int(mix["in_flight"])):
            out.append(Batch(len(out), -1, length,
                             tokens(mix, vocab, seed, len(out), length, 2)))
    return out
