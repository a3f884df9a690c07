"""Seeded arrival traces for the fleet simulator (the port's copy of the
JAX package's fleetsim/traces.py; the same seed gives the same trace in
either package, and either reads the other's JSONL).

Two generators cover the autoscaling-relevant load shapes:

- ``diurnal_trace``: a smooth sinusoidal day — rate swings between
  ``base_rps`` and ``peak_rps`` over ``period_s``. The slow ramp is what
  a predictive planner should anticipate (scale BEFORE the crest).
- ``mmpp_trace``: a Markov-modulated Poisson process — a two-state chain
  (calm/burst) switches the instantaneous rate, producing the abrupt
  traffic waves that punish reactive scaling hardest.

Both draw per-second Poisson counts with uniform within-second offsets,
entirely from one seeded ``random.Random``: the same seed yields the
byte-identical request list, which is the replay-identity contract
tests/test_torch_fleetsim.py pins. Prompts come from a ``PromptPopulation``
with Zipf-hot shared prefixes so the KV router's prefix matching has
realistic overlap structure to exploit.

Traces serialize to JSONL (``save_jsonl``/``load_jsonl``) so a bench run
can be recorded once and replayed across branches.
"""
from __future__ import annotations

import json
import math
import random
from dataclasses import asdict, dataclass
from typing import Callable, Optional


@dataclass
class TraceRequest:
    """One arrival: when (virtual seconds from trace start) and what."""

    arrival_s: float
    request_id: str
    token_ids: list[int]
    max_tokens: int

    def to_json(self) -> str:
        return json.dumps(asdict(self), separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "TraceRequest":
        return cls(**json.loads(s))


class PromptPopulation:
    """Shared-prefix prompt generator: ``n_prefixes`` hot prefixes picked
    with a Zipf-ish bias (rank r with weight 1/r**zipf_a), each completed
    by a fresh random suffix. Mirrors production chat traffic, where the
    system prompt is shared and the conversation tail is unique."""

    def __init__(
        self,
        n_prefixes: int = 16,
        prefix_len: int = 96,
        suffix_len: int = 32,
        vocab: int = 10_000,
        zipf_a: float = 1.1,
        seed: int = 0,
    ):
        rng = random.Random(seed)
        self.prefixes = [
            [rng.randrange(1, vocab) for _ in range(prefix_len)]
            for _ in range(n_prefixes)
        ]
        self.suffix_len = suffix_len
        self.vocab = vocab
        weights = [1.0 / (r + 1) ** zipf_a for r in range(n_prefixes)]
        total = sum(weights)
        self._cdf = []
        acc = 0.0
        for w in weights:
            acc += w / total
            self._cdf.append(acc)

    def sample(self, rng: random.Random) -> list[int]:
        u = rng.random()
        idx = next((i for i, c in enumerate(self._cdf) if u <= c),
                   len(self._cdf) - 1)
        suffix = [rng.randrange(1, self.vocab)
                  for _ in range(self.suffix_len)]
        return list(self.prefixes[idx]) + suffix


def _poisson(rng: random.Random, lam: float) -> int:
    """Knuth's algorithm — fine for the per-second rates simulated here."""
    if lam <= 0:
        return 0
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


def _arrivals(
    rng: random.Random,
    duration_s: float,
    rate_at: Callable[[int], float],
    population: PromptPopulation,
    max_tokens: int,
    prefix: str,
) -> list[TraceRequest]:
    out: list[TraceRequest] = []
    for sec in range(int(math.ceil(duration_s))):
        n = _poisson(rng, rate_at(sec))
        offsets = sorted(rng.random() for _ in range(n))
        for off in offsets:
            t = sec + off
            if t >= duration_s:
                continue
            out.append(TraceRequest(
                arrival_s=round(t, 6),
                request_id=f"{prefix}-{len(out)}",
                token_ids=population.sample(rng),
                max_tokens=max_tokens,
            ))
    return out


def diurnal_trace(
    duration_s: float,
    base_rps: float,
    peak_rps: float,
    period_s: float,
    seed: int = 0,
    population: Optional[PromptPopulation] = None,
    max_tokens: int = 16,
) -> list[TraceRequest]:
    """Sinusoidal rate: starts at ``base_rps`` (trough), crests at
    ``peak_rps`` half a period in."""
    rng = random.Random(seed)
    pop = population or PromptPopulation(seed=seed)

    def rate_at(sec: int) -> float:
        phase = 0.5 * (1.0 - math.cos(2.0 * math.pi * sec / period_s))
        return base_rps + (peak_rps - base_rps) * phase

    return _arrivals(rng, duration_s, rate_at, pop, max_tokens, "diurnal")


def mmpp_trace(
    duration_s: float,
    calm_rps: float,
    burst_rps: float,
    p_calm_to_burst: float = 0.05,
    p_burst_to_calm: float = 0.2,
    seed: int = 0,
    population: Optional[PromptPopulation] = None,
    max_tokens: int = 16,
) -> list[TraceRequest]:
    """Two-state Markov-modulated Poisson process, transitions evaluated
    once per second. Mean burst length = 1/p_burst_to_calm seconds."""
    rng = random.Random(seed)
    pop = population or PromptPopulation(seed=seed)
    # pre-walk the chain so arrivals consume rng draws in a fixed order
    rates: list[float] = []
    burst = False
    for _ in range(int(math.ceil(duration_s))):
        flip = rng.random()
        if burst:
            burst = flip >= p_burst_to_calm
        else:
            burst = flip < p_calm_to_burst
        rates.append(burst_rps if burst else calm_rps)

    return _arrivals(rng, duration_s, lambda s: rates[s], pop, max_tokens,
                     "mmpp")


def save_jsonl(path: str, trace: list[TraceRequest]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for req in trace:
            f.write(req.to_json() + "\n")


def load_jsonl(path: str) -> list[TraceRequest]:
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(TraceRequest.from_json(line))
    return out
