"""The distributed runtime's host cost beside the http path, on one GPU.

    python3 tools/torch_host_hop.py

Builds the kernels (chip_smoke.build_all), makes Llama-3.1-8B's random
bf16 weights (seed 0) on the card, runs chip_smoke.py's dense serve
phase once for the reference tokens, then its http and distributed
phases in the order http, distributed, distributed, http, twice
(BLOCKS). Every phase checks what chip_smoke.py checks (the serve
phase's tokens, the kernel's own launch count) and prints its lines:
TTFT, gaps and tok/s, each request's TTFT split at the engine's intake
and first output, and each event loop's host time per streamed token
(LoopMeter: busy at perf_counter's resolution, and the thread CPU clock
with its step on this host). The last line is a JSON object with every
phase's figures.
Needs a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BLOCKS = 2  # of http, distributed, distributed, http


def main() -> int:
    import torch

    import chip_smoke as cs
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    if not torch.cuda.is_available():
        print("torch_host_hop: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cs.log(f"card: {smi}")
    cs.build_all()
    params = llama.init_params(ModelConfig.llama3_8b(), cs.SEED,
                               device="cuda")
    dense_tokens, direct = cs.serve_llama3_8b({}, params, "none")
    want = dense_tokens[:8]
    rows = []
    for _ in range(BLOCKS):
        for which in ("http", "distributed", "distributed", "http"):
            if which == "http":
                _, http = cs.check_http(params, want, direct)
                rows.append(dict(phase="http", busy_us=http["busy_us"],
                                 cpu_us=http["cpu_us"],
                                 replay_us=http["replay_us"],
                                 ttft_s=float(np.median(http["ttft"])),
                                 gap_ms=float(np.median(http["gaps"])) * 1e3,
                                 tps=http["tps"]))
            else:
                _, d = cs.check_distributed(params, want, direct, http)
                rows.append(dict(phase="distributed",
                                 **{f"{k}_busy_us": b
                                    for k, (b, _) in d["us"].items()},
                                 **{f"{k}_cpu_us": c
                                    for k, (_, c) in d["us"].items()},
                                 ttft_s=float(np.median(d["ttft"])),
                                 gap_ms=float(np.median(d["gaps"])) * 1e3,
                                 tps=d["tps"]))
    print(smi)
    print(json.dumps({"card": smi, "cpu_clock_step_ms":
                      cs.cpu_clock_step_ms(), "phases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
