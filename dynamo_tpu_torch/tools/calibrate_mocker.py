"""Derive MockerArgs timing knobs from a real profiler table (the port's
copy of the JAX package's tools/calibrate_mocker.py).

The fleet simulator's workers are MockerEngines; for its autoscaling and
routing conclusions to transfer, the mocker's two timing knobs must
match the engine the fleet would actually run. This tool reads the JSON
emitted by ``dynamo_tpu_torch.profiler.profile_engine`` (or ``python -m
dynamo_tpu_torch.cli profile``) and inverts the concurrency-1 point:

- ``prefill_time_per_token_s`` = TTFT p50 at concurrency 1 / ISL
  (an unloaded TTFT is ~pure prefill; queueing is simulated separately)
- ``decode_time_per_step_s``   = ITL p50 at concurrency 1
- ``max_decode_slots``         = the profiled config's batch bound when
  present (config keys ``max_decode_slots``/``max_num_seqs``)

Usage:
    python -m dynamo_tpu_torch.tools.calibrate_mocker profile.json \
        [--config NAME] [-o mocker_args.json]

Output JSON maps 1:1 onto MockerArgs keyword arguments.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Optional


def mocker_args_from_profile(
    profile: dict[str, Any],
    config_name: Optional[str] = None,
) -> dict[str, Any]:
    """Invert a profile table into MockerArgs kwargs (see module doc)."""
    isl = int(profile.get("isl", 0))
    if isl <= 0:
        raise ValueError("profile has no positive 'isl'")
    configs = profile.get("configs", [])
    if not configs:
        raise ValueError("profile has no configs")
    if config_name is None:
        cfg = configs[0]
    else:
        match = [c for c in configs if c.get("name") == config_name]
        if not match:
            names = [c.get("name") for c in configs]
            raise ValueError(
                f"config {config_name!r} not in profile (have {names})"
            )
        cfg = match[0]
    points = sorted(cfg.get("points", []),
                    key=lambda p: p.get("concurrency", 0))
    if not points:
        raise ValueError(f"config {cfg.get('name')!r} has no points")
    # concurrency-1 point (fall back to the least loaded measured)
    p1 = next((p for p in points if p.get("concurrency") == 1), points[0])
    ttft = float(p1.get("ttft_p50_s", 0.0))
    itl = float(p1.get("itl_p50_s", 0.0))
    if ttft <= 0 or itl <= 0:
        raise ValueError(
            f"config {cfg.get('name')!r}: non-positive ttft/itl at "
            f"concurrency {p1.get('concurrency')}"
        )
    out: dict[str, Any] = {
        "prefill_time_per_token_s": ttft / isl,
        "decode_time_per_step_s": itl,
    }
    raw = cfg.get("config", {})
    slots = raw.get("max_decode_slots", raw.get("max_num_seqs"))
    if slots:
        out["max_decode_slots"] = int(slots)
    return out


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="derive MockerArgs timing from a profiler table"
    )
    ap.add_argument("profile", help="profile JSON from profile_engine")
    ap.add_argument("--config", default=None,
                    help="config name to calibrate against (default: first)")
    ap.add_argument("-o", "--output", default=None,
                    help="write JSON here (default: stdout)")
    args = ap.parse_args(argv)

    with open(args.profile, "r", encoding="utf-8") as f:
        profile = json.load(f)
    try:
        out = mocker_args_from_profile(profile, config_name=args.config)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    text = json.dumps(out, indent=2, sort_keys=True)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
