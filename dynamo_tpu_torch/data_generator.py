"""Synthetic request-trace generator + analyzer (mooncake-style traces;
the port's copy of the JAX package's data_generator.py).

Parity: reference benchmarks/data_generator — synthesizes mooncake-format
traces (timestamp, input/output lengths, hash_ids encoding shared-prefix
structure) for router/cache benchmarking, and analyzes real traces for
the statistics the synthesizer mimics.

Trace record (JSONL, mooncake-compatible field names):
    {"timestamp": ms, "input_length": n, "output_length": m,
     "hash_ids": [...]}   # block ids; shared prefix == shared leading ids

The generator models multi-turn sessions: a session's turn t reuses the
full token history of turns < t (the prefix-sharing pattern KV routing
and the G2 offload tier exploit), with Poisson arrivals.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Iterator, Optional

import numpy as np


@dataclass
class TraceConfig:
    num_requests: int = 100
    request_rate_per_s: float = 2.0       # Poisson arrival rate
    isl_mean: int = 256                   # fresh input tokens per turn
    isl_cv: float = 0.5                   # coefficient of variation
    osl_mean: int = 128
    osl_cv: float = 0.5
    block_size: int = 64                  # tokens per hash id
    num_sessions: int = 20                # concurrent conversations
    turns_mean: float = 4.0               # mean turns per session
    seed: int = 0


def synthesize(cfg: TraceConfig) -> list[dict[str, Any]]:
    """Generate a trace; records are sorted by timestamp."""
    rng = np.random.RandomState(cfg.seed)
    next_hash = [1]

    def fresh_blocks(n_tokens: int) -> list[int]:
        n = max(1, math.ceil(n_tokens / cfg.block_size))
        ids = list(range(next_hash[0], next_hash[0] + n))
        next_hash[0] += n
        return ids

    def lognorm(mean: float, cv: float) -> int:
        sigma = math.sqrt(math.log(1 + cv * cv))
        mu = math.log(max(mean, 1)) - sigma * sigma / 2
        return max(1, int(rng.lognormal(mu, sigma)))

    sessions = [
        {"history": [], "hist_tokens": 0}
        for _ in range(max(1, cfg.num_sessions))
    ]
    records: list[dict[str, Any]] = []
    t_ms = 0.0
    for _ in range(cfg.num_requests):
        t_ms += rng.exponential(1000.0 / cfg.request_rate_per_s)
        s = sessions[rng.randint(len(sessions))]
        # session reset models a finished conversation
        if s["history"] and rng.random() < 1.0 / max(cfg.turns_mean, 1.0):
            s["history"] = []
            s["hist_tokens"] = 0
        new_in = lognorm(cfg.isl_mean, cfg.isl_cv)
        out = lognorm(cfg.osl_mean, cfg.osl_cv)
        hash_ids = list(s["history"]) + fresh_blocks(new_in)
        records.append({
            "timestamp": int(t_ms),
            "input_length": s["hist_tokens"] + new_in,
            "output_length": out,
            "hash_ids": hash_ids,
        })
        # next turn's history includes this turn's input AND output
        s["history"] = hash_ids + fresh_blocks(out)
        s["hist_tokens"] += new_in + out
    return records


def write_trace(records: list[dict[str, Any]], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for r in records:
            f.write(json.dumps(r, separators=(",", ":")) + "\n")


def read_trace(path: str) -> Iterator[dict[str, Any]]:
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def analyze(records: list[dict[str, Any]]) -> dict[str, Any]:
    """Trace statistics (the reference analyzer's core numbers): length
    distributions, arrival rate, and the theoretical cache-hit ratio — the
    fraction of input blocks already seen earlier in the trace."""
    if not records:
        return {"num_requests": 0}
    isl = np.array([r["input_length"] for r in records])
    osl = np.array([r["output_length"] for r in records])
    ts = np.array([r["timestamp"] for r in records], dtype=np.float64)
    seen: set[int] = set()
    total_blocks = 0
    reused_blocks = 0
    for r in records:
        for h in r.get("hash_ids", []):
            total_blocks += 1
            if h in seen:
                reused_blocks += 1
            else:
                seen.add(h)
    span_s = max((ts.max() - ts.min()) / 1000.0, 1e-9)
    return {
        "num_requests": len(records),
        "isl_mean": float(isl.mean()),
        "isl_p95": float(np.percentile(isl, 95)),
        "osl_mean": float(osl.mean()),
        "osl_p95": float(np.percentile(osl, 95)),
        "request_rate_per_s": (len(records) - 1) / span_s,
        "prefix_reuse_ratio": reused_blocks / max(total_blocks, 1),
        "unique_blocks": len(seen),
    }


def run_datagen(args) -> None:
    if args.analyze:
        stats = analyze(list(read_trace(args.analyze)))
        print(json.dumps(stats, indent=1))
        return
    cfg = TraceConfig(
        num_requests=args.num,
        request_rate_per_s=args.rate,
        isl_mean=args.isl, osl_mean=args.osl,
        block_size=args.block_size,
        num_sessions=args.sessions,
        turns_mean=args.turns,
        seed=args.seed,
    )
    records = synthesize(cfg)
    write_trace(records, args.output)
    print(f"wrote {len(records)} records to {args.output}")
    print(json.dumps(analyze(records), indent=1), flush=True)
