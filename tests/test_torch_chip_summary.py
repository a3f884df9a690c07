"""chip_smoke.py's summary block, on the CPU: the lines that end the card
run's output (each phase's summary, the card line, the byte count, the
kernels line and the ok line) must fit SUMMARY_BUDGET (16,000 bytes), so
that the last 22,000 bytes of the output, what is kept of a run, start
before the first summary line; the padding lines before the block make
that window (and the last 24,000) start at a line. Fed a report
the size of the last full run's (27 phases, their figures of up to 700
characters cut as the phase cuts them, three kernels, the w8a16 record
with its 45 timed shapes and figures at full float precision)."""
import json
import random

import pytest

import chip_smoke as cs


def _float(rng):
    return rng.random() * 10 ** rng.randint(-4, 2)


def _report(rng, phases=27, line=360):
    # each phase's figures, cut as phase() cuts them
    summary = [cs.summary_line(f"phase {i}", rng.random() * 60, "x" * line)
               for i in range(phases)]
    fd = dict(name="flash_decode", route="cuda",
              source="dynamo_tpu_torch/csrc/flash_decode.cu",
              replaces="dynamo_tpu/ops/flash_decode.py:210",
              ms=_float(rng), plain_ms=_float(rng), bound_ms=_float(rng),
              bound_by="bytes", library_ms=_float(rng),
              max_abs_err=_float(rng),
              **{f"launches_{k}": rng.randint(0, 60000) for k in (
                  "http", "distributed", "kv_router", "disagg",
                  "resilience", "prefix_economy", "offload", "spec")},
              launches=2944)
    fd8 = dict(fd, name="flash_decode_int8",
               replaces="dynamo_tpu/ops/flash_decode.py:176")
    shapes = [dict(shape=f"8b shape {i}", M=rng.choice([1, 8, 32, 40]),
                   K=4096, N=14336, kernel="mma", plan=[8, 8],
                   ms=_float(rng), plain_ms=_float(rng),
                   bound_ms=_float(rng), bound_by="bytes",
                   tc_bound_ms=_float(rng), library_ms=_float(rng),
                   int8pack_ms=_float(rng)) for i in range(45)]
    w8 = dict(name="w8a16_gemm", route="cuda",
              source="dynamo_tpu_torch/csrc/w8a16_gemm.cu",
              replaces="dynamo_tpu/models/llama.py:409", launches=22275,
              launches_prefill_wgmma=1568, ms=_float(rng),
              plain_ms=_float(rng), bound_ms=_float(rng),
              library_ms=_float(rng), bound_by="bytes",
              max_abs_err=_float(rng),
              prefill_layer={str(m): dict(ms=_float(rng),
                                          tc_bound_ms=_float(rng),
                                          library_ms=_float(rng))
                             for m in (64, 128, 200, 512, 1024, 2048, 4096)},
              shapes=shapes)
    return summary, [fd, fd8, w8]


DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.mark.parametrize("line", [320, 360, 700])
def test_summary_block_fits_the_budget_and_keeps_every_kernel(line):
    rng = random.Random(line)
    summary, kernels = _report(rng, line=line)
    lines = cs.summary_block(summary, CARD, kernels, DEVICE)
    block = "".join(s + "\n" for s in lines)
    assert len(block.encode()) <= cs.SUMMARY_BUDGET == 16000
    # it ends with the ok line, the kernels line before it, then the count
    assert json.loads(lines[-1]) == {"ok": True, "device": DEVICE}
    kern = json.loads(lines[-2])["kernels"]
    count = lines[-3]
    assert count.startswith("block bytes: ")
    assert int(count.split()[2]) == len(block.encode())
    assert lines[-4] == CARD
    # every summary line is there, in order, each keeping its name
    heads = [s.split(";")[0] for s in summary]
    assert [s.split(";")[0] for s in lines[:-4]] == heads
    # one record a kernel, every key but the per-shape list, floats to
    # 4 significant digits
    assert [k["name"] for k in kern] == [k["name"] for k in kernels]
    for got, want in zip(kern, kernels):
        assert set(got) == set(want) - {"shapes"}
        for key, v in want.items():
            if isinstance(v, float):
                assert got[key] == float(f"{v:.4g}")
                assert got[key] == pytest.approx(v, rel=5e-4)
            elif key != "shapes" and not isinstance(v, dict):
                assert got[key] == v
    assert kern[2]["prefill_layer"]["4096"]["ms"] == float(
        f"{kernels[2]['prefill_layer']['4096']['ms']:.4g}")


@pytest.mark.parametrize("line", [0, 320, 700])
def test_tail_padding_starts_each_kept_window_at_a_line(line):
    """The padding lines before the block make the last 22,000 bytes
    (a short log's window) and the last 24,000 (a longer log's)
    each begin with a whole line."""
    rng = random.Random(line)
    summary, kernels = _report(rng, line=line)
    block = cs.summary_block(summary, CARD, kernels, DEVICE)
    size = sum(len(s.encode()) + 1 for s in block)
    pad = cs.tail_padding(size)
    out = ("header line\n" * 3 + "".join(
        s + "\n" for s in pad + block)).encode()
    for keep in (22000, 24000):
        tail = out[-keep:]
        assert out[-keep - 1:-keep] == b"\n"
        assert tail.startswith(f"(the last {keep} bytes".encode())
    assert all(s.isascii() for s in pad)
    with pytest.raises(AssertionError, match="no room"):
        cs.tail_padding(21990)


def test_summary_block_raises_past_the_budget():
    rng = random.Random(0)
    summary, kernels = _report(rng, phases=400, line=320)
    with pytest.raises(AssertionError, match="budget"):
        cs.summary_block(summary, CARD, kernels, DEVICE)


def test_sig4_rounds_through_nested_figures():
    assert cs.sig4({"a": [0.1389675970394338, 3], "b": {"c": 148.80867919}}
                   ) == {"a": [0.139, 3], "b": {"c": 148.8}}
    assert cs.sig4(("x", True, None, 2.5e-07)) == ["x", True, None, 2.5e-07]
