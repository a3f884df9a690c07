"""The port's checkpoint loading against the JAX package's, on small Llama
checkpoints that ``transformers`` writes here (f32, bf16, sharded through
``model.safetensors.index.json``, tied embeddings): the safetensors
reader (safetensors_io.py), ``ModelConfig.from_hf_dict`` on a Llama-3.1
``config.json``, ``load_hf_params`` leaf by leaf and exactly (dense and
quantized at load), prefill logits against ``LlamaForCausalLM``, and a
TorchEngine served from the directory greedy token-identical to a
TpuEngine served from it (dense KV, int8 KV, w8a16)."""
import asyncio
import dataclasses
import json
import struct

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu_torch import safetensors_io as stio
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.protocols import common as tproto

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, max_position_embeddings=512,
            rope_theta=10000.0, rms_norm_eps=1e-5, bos_token_id=1,
            eos_token_id=[2, 3])
LLAMA31_ROPE = {"factor": 8.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0,
                "original_max_position_embeddings": 8192,
                "rope_type": "llama3"}


def write_llama_dir(d, dtype=torch.float32, tie=False, shard=None,
                    seed=0, **over) -> str:
    """A random Llama checkpoint saved by ``transformers``."""
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    cfg = LlamaConfig(**{**TINY, **over}, tie_word_embeddings=tie)
    model = LlamaForCausalLM(cfg).to(dtype).eval()
    with torch.no_grad():   # norms away from 1, so a swapped leaf shows
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(torch.randn_like(p) * 0.1)
    kw = {"max_shard_size": shard} if shard else {}
    model.save_pretrained(str(d), safe_serialization=True, **kw)
    return str(d)


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


def _assert_equal_trees(port, ref):
    """Every leaf equal in dtype, shape and value (``ref``: torch)."""
    port, ref = _flat(port), _flat(ref)
    assert port.keys() == ref.keys()
    for k in port:
        assert port[k].dtype == ref[k].dtype, k
        assert port[k].shape == ref[k].shape, k
        assert torch.equal(port[k], ref[k]), k


CHECKPOINTS = {
    "f32": dict(),
    "bf16": dict(dtype=torch.bfloat16),
    "sharded": dict(shard="60KB"),
    "tied": dict(tie=True),
}


@pytest.fixture(scope="module", params=sorted(CHECKPOINTS))
def ckpt(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    return request.param, write_llama_dir(d, **CHECKPOINTS[request.param])


def test_sharded_checkpoint_has_an_index(ckpt):
    name, d = ckpt
    files = stio.checkpoint_files(d)
    if name == "sharded":
        assert len(files) > 1
        assert all(names for names in files.values())
    else:
        assert list(files.values()) == [None]


@pytest.mark.parametrize("dtype", [None, "float32"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_load_hf_params_equals_the_reference(ckpt, dtype, quant):
    _, d = ckpt
    jcfg = JConfig.from_pretrained(d)
    tcfg = TConfig.from_pretrained(d)
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jcfg = dataclasses.replace(jcfg, quant=quant)
    tcfg = dataclasses.replace(tcfg, quant=quant)
    ref = jl.load_hf_params(jcfg, d)
    port = tl.load_hf_params(tcfg, d, device="cpu")
    _assert_equal_trees(port, tl.params_from_jax(_np(ref), device="cpu"))
    assert ("lm_head" in port) == (not tcfg.tie_word_embeddings)


def test_quantized_at_load_equals_quantize_params(ckpt):
    """Quantized one slot at a time as it loads == quantize_params of the
    loaded dense tree, bit for bit."""
    _, d = ckpt
    cfg = TConfig.from_pretrained(d)
    dense = tl.load_hf_params(cfg, d, device="cpu")
    q = tl.load_hf_params(dataclasses.replace(cfg, quant="int8"), d,
                          device="cpu")
    _assert_equal_trees(q, tl.quantize_params(dense))


def test_prefill_logits_match_transformers(ckpt):
    from transformers import LlamaForCausalLM

    name, d = ckpt
    cfg = dataclasses.replace(TConfig.from_pretrained(d), dtype="float32")
    params = tl.load_hf_params(cfg, d, device="cpu")
    toks = np.random.RandomState(0).randint(1, 256, size=20)
    ctx = tl.init_ctx(cfg, 1, 64, torch.float32, device="cpu")
    logits = tl.prefill(cfg, params, ctx, torch.tensor(toks), 0, 0, 20)
    model = LlamaForCausalLM.from_pretrained(d, torch_dtype=torch.float32)
    with torch.no_grad():
        ref = model(torch.tensor(toks)[None]).logits[0, -1].numpy()
    np.testing.assert_allclose(logits.reshape(-1).numpy(), ref, rtol=2e-3,
                               atol=2e-3)


def test_llama31_config_reads_as_the_reference(tmp_path):
    hf = {**TINY, "rope_scaling": LLAMA31_ROPE, "eos_token_id": [128001,
          128008, 128009], "bos_token_id": 128000,
          "tie_word_embeddings": True, "torch_dtype": "bfloat16",
          "model_type": "llama", "head_dim": 32}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    p = TConfig.from_pretrained(str(tmp_path))
    r = JConfig.from_pretrained(str(tmp_path))
    assert dataclasses.asdict(p) == {
        k: v for k, v in dataclasses.asdict(r).items()
        if k in dataclasses.asdict(p)}
    assert p.head_dim == 32 and p.tie_word_embeddings
    assert p.rope_scaling_dict["rope_type"] == "llama3"


ENGINE = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
              max_decode_slots=4, prefill_buckets=(32, 64),
              cache_dtype="float32")
PROMPTS = [list(range(1 + i, 30 + 3 * i)) for i in range(3)] + [
    [int(t) for t in np.random.RandomState(0).randint(1, 256, size=40)]]


async def _collect(engine, proto, prompt):
    req = proto.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=proto.StopConditions(max_tokens=10,
                                             ignore_eos=True))
    toks = []
    async for out in engine.generate(req):
        toks.extend(out.token_ids)
    return toks


async def _drive(engine, proto):
    try:
        return await asyncio.gather(
            *[_collect(engine, proto, p) for p in PROMPTS])
    finally:
        await engine.stop()


@pytest.mark.parametrize("kv_quant,quant", [
    ("none", None), ("int8", None), ("none", "int8")],
    ids=["dense", "int8_kv", "w8a16"])
def test_engine_served_from_the_directory_matches_the_reference(
        tmp_path, kv_quant, quant):
    d = write_llama_dir(tmp_path / "m", dtype=torch.bfloat16, seed=3)
    jcfg = dataclasses.replace(JConfig.from_pretrained(d), dtype="float32",
                               quant=quant)
    tcfg = dataclasses.replace(TConfig.from_pretrained(d), dtype="float32",
                               quant=quant)
    jeng = TpuEngine(jcfg, JEngineConfig(**ENGINE, kv_quant=kv_quant),
                     params=jl.load_hf_params(jcfg, d),
                     mesh_config=MeshConfig(tp=1))
    teng = TorchEngine(tcfg, TEngineConfig(**ENGINE, kv_quant=kv_quant),
                       params=tl.load_hf_params(tcfg, d, device="cpu"),
                       device="cpu")
    want = asyncio.run(_drive(jeng, jproto))
    got = asyncio.run(_drive(teng, tproto))
    assert got == want
    assert all(len(t) == 10 for t in got)


# ---------------------------------------------------------------------------
# the safetensors reader refuses malformed files


def _write_raw(path, header: dict, data: bytes, pad_header: int = 0):
    h = json.dumps(header).encode() + b" " * pad_header
    path.write_bytes(struct.pack("<Q", len(h)) + h + data)
    return str(path)


def test_reader_roundtrips_every_dtype(tmp_path):
    a = torch.randn(3, 5)
    tensors = {"f32": a, "bf16": a.to(torch.bfloat16),
               "f16": a.to(torch.float16)}
    header, data = {"__metadata__": {"format": "pt"}}, b""
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": {"f32": "F32", "bf16": "BF16",
                                  "f16": "F16"}[name],
                        "shape": list(t.shape),
                        "data_offsets": [len(data), len(data) + len(raw)]}
        data += raw
    f = stio.SafetensorsFile(_write_raw(tmp_path / "x.safetensors",
                                        header, data, pad_header=3))
    assert sorted(f) == sorted(tensors) and f.metadata == {"format": "pt"}
    for name, t in tensors.items():
        assert torch.equal(f[name], t)


@pytest.mark.parametrize("case,match", [
    ("truncated", "truncated"),
    ("header_past_end", "runs past the end"),
    ("offsets_past_end", "lie outside"),
    ("size_mismatch", "needs"),
    ("unknown_dtype", "'I64'"),
    ("not_json", "not JSON"),
])
def test_reader_refuses_malformed_files(tmp_path, case, match):
    path = tmp_path / "bad.safetensors"
    ok = {"w": {"dtype": "F32", "shape": [2, 2], "data_offsets": [0, 16]}}
    if case == "truncated":
        path.write_bytes(b"\x10\x00")
    elif case == "header_past_end":
        path.write_bytes(struct.pack("<Q", 1000) + b"{}")
    elif case == "offsets_past_end":
        _write_raw(path, ok, b"\x00" * 8)
    elif case == "size_mismatch":
        bad = {"w": {"dtype": "F32", "shape": [2, 3],
                     "data_offsets": [0, 16]}}
        _write_raw(path, bad, b"\x00" * 16)
    elif case == "unknown_dtype":
        bad = {"w": {"dtype": "I64", "shape": [2],
                     "data_offsets": [0, 16]}}
        _write_raw(path, bad, b"\x00" * 16)
    else:
        h = b"{not json"
        path.write_bytes(struct.pack("<Q", len(h)) + h)
    with pytest.raises(ValueError, match=match):
        stio.SafetensorsFile(str(path))


def test_index_naming_a_missing_tensor_is_refused(tmp_path):
    d = write_llama_dir(tmp_path / "m", shard="60KB")
    index = json.loads((tmp_path / "m" / stio.INDEX_FILE).read_text())
    index["weight_map"]["model.ghost.weight"] = next(
        iter(index["weight_map"].values()))
    (tmp_path / "m" / stio.INDEX_FILE).write_text(json.dumps(index))
    with pytest.raises(ValueError, match="ghost"):
        stio.Checkpoint(d)


def test_missing_tensor_and_wrong_shape_are_named(tmp_path):
    d = write_llama_dir(tmp_path / "m")
    cfg = TConfig.from_pretrained(d)
    with pytest.raises(ValueError, match="q_proj"):
        tl.load_hf_params(dataclasses.replace(cfg, head_dim=8), d,
                          device="cpu")
    with pytest.raises(KeyError, match="layers.3"):
        tl.load_hf_params(dataclasses.replace(cfg, num_layers=4), d,
                          device="cpu")


def test_jax_weights_bridge_gives_the_same_tree(tmp_path):
    """params_from_jax of the reference's loaded tree == the port's
    loader on the same directory (the tests' bridge stays valid)."""
    d = write_llama_dir(tmp_path / "m", tie=True)
    cfg = TConfig.from_pretrained(d)
    ref = tl.params_from_jax(jax.tree.map(
        np.asarray, jl.load_hf_params(JConfig.from_pretrained(d), d)),
        device="cpu")
    port = tl.load_hf_params(cfg, d, device="cpu")
    assert jax.tree.structure(ref) == jax.tree.structure(port)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(ref),
                                                 jax.tree.leaves(port)))
