"""The port's byte accounting (dynamo_tpu_torch/roofline.py) against the
JAX package's: at context lengths on the TPU kernel's chunk grid, every
stream is byte-equal; off it, the JAX package rounds each lane's live
rows up to the TPU kernel's chunk while the port counts the rows its
kernel reads: the live rows exactly, and in int8 mode the scale groups
that hold them. chip_info gives a peak only for a card in its table, so
on the CPU and on an unknown card the roofline fraction is null."""
import numpy as np
import pytest
import torch

from dynamo_tpu import roofline as rroof
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu_torch import roofline as proof
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.models.config import ModelConfig as TConfig

ECFG = dict(max_decode_slots=4, page_size=64, max_pages_per_seq=64,
            cache_dtype="bfloat16")


def _both(model, kv_quant, lens, **kw):
    e = dict(ECFG, kv_quant=kv_quant, **kw)
    args = (lens, 123456789)
    return (rroof.decode_byte_accounting(getattr(JConfig, model)(),
                                         JEngineConfig(**e), *args),
            proof.decode_byte_accounting(getattr(TConfig, model)(),
                                         TEngineConfig(**e), *args))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("model", ["tiny", "llama3_8b"])
@pytest.mark.parametrize("lens", [[512, 1024, 4096, 2560],
                                  [0, 512, 3584, 1536]])
def test_streams_equal_the_reference_on_the_chunk_grid(
        model, kv_quant, lens):
    ref, port = _both(model, kv_quant, lens)
    assert port == ref
    assert port["bytes_per_step_breakdown"]["kv_ctx"] > 0


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("cache_dtype,page", [("bfloat16", 64),
                                              ("float32", 16),
                                              ("float32", 64)])
def test_live_rows_are_counted_as_the_kernel_reads_them(kv_quant,
                                                        cache_dtype, page):
    """Lengths off every grid: the port counts each lane's live rows
    (the kernel copies no row past them) and, in int8 mode, the scale
    groups that hold them; the other streams stay the reference's."""
    lens = [1, 100, 700, 33]
    ref, port = _both("llama3_8b", kv_quant, lens, cache_dtype=cache_dtype,
                      page_size=page, max_pages_per_seq=4096 // page)
    quant = kv_quant == "int8"
    elem = 1 if quant else {"bfloat16": 2, "float32": 4}[cache_dtype]
    c = TConfig.llama3_8b()
    got = port["bytes_per_step_breakdown"]
    assert got["kv_ctx"] == 2 * c.num_layers * c.num_kv_heads \
        * c.head_dim * sum(lens) * elem
    groups = sum(-(-n // page) for n in lens)
    assert got["kv_ctx_scales"] == (2 * c.num_layers * groups * 4
                                    if quant else 0)
    want = ref["bytes_per_step_breakdown"]
    for k in ("weights", "kv_ring", "logits"):
        assert got[k] == want[k]
    # the TPU kernel's chunk (512 rows here) reads more
    assert got["kv_ctx"] < want["kv_ctx"]
    bf16 = 2 * c.num_layers * c.num_kv_heads * c.head_dim * sum(lens) * 2
    assert port["kv_ctx_bytes_vs_bf16"] == pytest.approx(
        (got["kv_ctx"] + got["kv_ctx_scales"]) / bf16, rel=1e-12)


def test_rows_never_pass_the_region():
    """A lane longer than the region counts the region's rows, no more."""
    e = TEngineConfig(max_decode_slots=2, page_size=16, max_pages_per_seq=5,
                      cache_dtype="bfloat16")   # S = 80
    got = proof.decode_byte_accounting(TConfig.tiny(), e, [95, 65], 0)
    c = TConfig.tiny()
    assert got["bytes_per_step_breakdown"]["kv_ctx"] == \
        2 * c.num_layers * c.num_kv_heads * c.head_dim * (80 + 65) * 2


def test_chip_info_on_the_cpu_gives_no_peak():
    assert proof.chip_info("cpu") == ("cpu", None, False)
    kind, peak, on_card = proof.chip_info()
    if not torch.cuda.is_available():
        assert (kind, peak, on_card) == ("cpu", None, False)
    e = TEngineConfig(**ECFG)
    got = proof.decode_byte_accounting(TConfig.tiny(), e, [512] * 4, 1000,
                                       steps_per_s=100.0, peak_bw=peak and
                                       peak[1])
    assert got["attn_roofline_frac"] is None


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_chip_info_knows_only_the_table(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: name)
    assert proof.chip_info() == (name, peak, True)
    e = TEngineConfig(**ECFG)
    got = proof.decode_byte_accounting(
        TConfig.tiny(), e, [512] * 4, 1000, steps_per_s=100.0,
        peak_bw=peak[1] if peak else None)
    if peak is None:
        assert got["attn_roofline_frac"] is None
    else:
        assert got["attn_roofline_frac"] == pytest.approx(
            100.0 * got["total_bytes_per_step"] / 3.35e12)


def test_params_nbytes_counts_int8_weights_and_scales():
    w = {"layers": {"wq": {"q": torch.zeros(2, 8, 4, dtype=torch.int8),
                           "s": torch.zeros(2, 4)}},
         "embed": torch.zeros(10, 8, dtype=torch.bfloat16)}
    assert proof.params_nbytes(w) == 2 * 8 * 4 + 2 * 4 * 4 + 10 * 8 * 2
