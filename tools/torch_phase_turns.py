"""Time chip_smoke.py phases of two checkouts in turns on one card.

    python3 tools/torch_phase_turns.py PARENT_DIR CHANGE_DIR \
        [--phases "remote kv" resilience offload]

Each directory is a checkout of the repository (``git archive`` of a
commit unpacked into a gitignored directory). The phases run in turns,
parent, change, change, parent, each turn in a process of its own
started from its checkout: the kernels built, Llama-3.1-8B's random bf16
weights made from chip_smoke's seed, then each named phase through
``chip_smoke.phase``. Prints the card's name and power limit, every
turn's seconds a phase, and as the last line a JSON object of the
seconds by side and phase. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

# chip_smoke.py phases that take (params) or (params, card), by name
PHASES = {
    "remote kv": "c.check_remote_kv, params, card",
    "resilience": "c.check_resilience, params",
    "offload": "c.check_offload, params, {}, card",
    "prefix economy": "c.check_prefix_economy, params, card",
}

TURN = """
import torch, chip_smoke as c
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
torch.backends.cuda.matmul.allow_tf32 = False
c.build_all()
params = llama.init_params(ModelConfig.llama3_8b(), c.SEED, device="cuda")
card = {card!r}
{calls}
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--phases", nargs="+", default=["remote kv",
                                                     "resilience",
                                                     "offload"],
                    choices=sorted(PHASES))
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    calls = "\n".join(f"c.phase({name!r}, {PHASES[name]})"
                      for name in args.phases)
    code = TURN.format(card=card, calls=calls)
    secs: dict[str, dict[str, list]] = {"parent": {}, "change": {}}
    for side in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, "-c", code],
                              cwd=getattr(args, side), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.stdout.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"{side}: the turn exited {proc.returncode}")
        for name, s in re.findall(r"^phase (.+): ([0-9.]+) s$",
                                  proc.stdout, re.M):
            if name in args.phases:
                secs[side].setdefault(name, []).append(float(s))
                print(f"{side}: phase {name}: {s} s", flush=True)
    print(json.dumps(secs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
