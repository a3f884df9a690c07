"""Does torch.profiler keep every kernel of a CUDA graph replay?

chip_smoke.py counts the kernels inside one replayed decode round with
torch.profiler, and the count must be exact. This probe captures a graph
of 897 elementwise products (a multiply) ending in 3 kernels of another
name (a negation), 900 as in an 8B w8a16 round, then profiles single
replays, each closed right after torch.cuda.synchronize() or after 5 ms
of idle host time more, before and after one profile of ``--eager``
kernels launched one by one (a speculative verify's worth; with
``--capture-after`` the graph is captured after that profile).
For every case it prints how many replays lost kernels, which kind they
lost, and the largest time by which the last kernel seemed to end after
the synchronize call returned, on the profile's clock (a kernel cannot
really end after the host saw it finish, so a positive figure is the
offset between the device's clock and the host's as the profile maps
them).

Run on the card:

  python -m dynamo_tpu_torch.tools.profiler_window
  python -m dynamo_tpu_torch.tools.profiler_window --replays 50 --json
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _profile(fn, margin_s: float):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
        if margin_s:
            time.sleep(margin_s)
    body = tail = 0
    last_end = sync_end = None
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.name.lower()
            if name.startswith(("memcpy", "memset")):
                continue
            if "mul" in name:
                body += 1
            elif "neg" in name:
                tail += 1
            end = evt.time_range.end
            last_end = end if last_end is None else max(last_end, end)
        elif evt.name == "cudaDeviceSynchronize":
            sync_end = evt.time_range.end
    late_us = (None if last_end is None or sync_end is None
               else last_end - sync_end)
    return body, tail, late_us


def _capture(x, y, kernels: int, tail: int) -> torch.cuda.CUDAGraph:
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):   # warm-up before capture
            x.mul_(1.0)
            y.neg_()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(kernels):
            x.mul_(1.0)
        for _ in range(tail):
            y.neg_()
    graph.replay()
    torch.cuda.synchronize()
    return graph


KERNELS, TAIL = 897, 3   # the graph's products and its last kernels
MARGIN_S = 0.005         # idle host time before a profile closes
NUMEL = 1 << 20          # elements a kernel touches


def run(eager: int, replays: int, capture_after: bool = False,
        kernels: int = KERNELS, tail: int = TAIL) -> dict:
    dev = torch.device("cuda")
    x = torch.ones(NUMEL, device=dev)
    y = torch.ones(NUMEL, device=dev)
    graph = None if capture_after else _capture(x, y, kernels, tail)

    def cases(label):
        out = {}
        for margin in (0.0, MARGIN_S):
            seen = [_profile(graph.replay, margin) for _ in range(replays)]
            lost = [(kernels - b, tail - t) for b, t, _ in seen
                    if (b, t) != (kernels, tail)]
            late = [u for *_, u in seen if u is not None]
            out[f"{label}, margin {margin * 1e3:g} ms"] = dict(
                replays=replays, lossy=len(lost),
                lost_body=sum(b for b, _ in lost),
                lost_tail=sum(t for _, t in lost),
                late_us_max=max(late) if late else None)
        return out

    report = {} if capture_after else cases("before")
    t0 = time.perf_counter()
    b, t, _ = _profile(lambda: [x.mul_(1.0) for _ in range(eager)], 0.0)
    report["eager"] = dict(kernels=eager, seen=b,
                           seconds=time.perf_counter() - t0)
    if capture_after:
        graph = _capture(x, y, kernels, tail)
    report.update(cases("after" + (", captured after" if capture_after
                                   else "")))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--eager", type=int, default=40000)
    ap.add_argument("--replays", type=int, default=20)
    ap.add_argument("--capture-after", action="store_true",
                    help="capture the graph after the eager profile")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_window: no CUDA device", file=sys.stderr)
        return 1
    report = run(a.eager, a.replays, a.capture_after)
    if a.json:
        print(json.dumps(report))
    else:
        for case, r in report.items():
            print(f"{case}: {r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
