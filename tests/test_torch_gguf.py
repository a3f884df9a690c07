"""The port's GGUF reader (dynamo_tpu_torch/gguf.py) against the JAX
package's, on the synthetic files of tests/test_gguf.py: metadata and
tensor descriptors, the model config, the SentencePiece and byte-level
BPE tokenizers (the BPE one also against the ``tokenizers`` library),
dequantization of every classic format, ``load_gguf_params`` leaf by
leaf (dense and quantized at load), and the launcher serving a .gguf end
to end on the CPU as the reference's CLI does."""
import dataclasses
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from dynamo_tpu import gguf as rg
from dynamo_tpu_torch import gguf as pg
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from tests.test_gguf import (
    _T_ARRAY,
    _T_STRING,
    _T_U32,
    GOLDEN_TEXTS,
    VOCAB,
    _arr,
    _gguf_permute,
    _kv,
    _s,
    _tok_metadata,
    _write_gguf_with_data,
    write_gguf,
)
from tests.test_torch_checkpoint import _assert_equal_trees, _np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_read_gguf_and_config_match_the_reference(tmp_path):
    path = tmp_path / "m.gguf"
    write_gguf(path, _tok_metadata(),
               tensors=[("token_embd.weight", [64, len(VOCAB)], 0, 0),
                        ("blk.0.attn_q.weight", [64, 64], 0, 4096)])
    assert pg.read_gguf(str(path)) == rg.read_gguf(str(path))
    md, _ = pg.read_gguf(str(path))
    assert dataclasses.asdict(pg.config_from_gguf(md)) == {
        k: v for k, v in dataclasses.asdict(rg.config_from_gguf(md)).items()
        if k in dataclasses.asdict(TConfig.tiny())}
    assert isinstance(pg.config_from_gguf(md), TConfig)


def test_gguf_rejects_non_gguf(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"NOTG" + b"\x00" * 64)
    with pytest.raises(ValueError, match="not a GGUF"):
        pg.read_gguf(str(p))
    blobs = _tok_metadata()
    blobs[0] = _kv("general.architecture", _T_STRING, _s("falcon"))
    write_gguf(tmp_path / "f.gguf", blobs)
    md, _ = pg.read_gguf(str(tmp_path / "f.gguf"))
    with pytest.raises(ValueError, match="falcon"):
        pg.config_from_gguf(md)


SPM_TEXTS = ["hello world", "hi", "héllo", "hello  world ", "", "wörld 😀",
             "hello\nworld", "x"]


def test_spm_tokenizer_matches_the_reference(tmp_path):
    path = tmp_path / "m.gguf"
    write_gguf(path, _tok_metadata())
    md, _ = pg.read_gguf(str(path))
    p, r = pg.GgufTokenizer.from_metadata(md), rg.GgufTokenizer.from_metadata(md)
    for text in SPM_TEXTS:
        for special in (True, False):
            assert p.encode(text, special) == r.encode(text, special)
        ids = r.encode(text)
        assert p.decode(ids) == r.decode(ids)
    assert (p.stop_token_ids, p.eos_token_ids, p.vocab_size) == \
        (r.stop_token_ids, r.eos_token_ids, r.vocab_size)


def test_bpe_gguf_dispatch(tmp_path):
    path = tmp_path / "m.gguf"
    blobs = _tok_metadata()
    blobs[9] = _kv("tokenizer.ggml.model", _T_STRING, _s("gpt2"))
    blobs.append(_kv("tokenizer.ggml.merges", _T_ARRAY, _arr(_T_STRING, [])))
    write_gguf(path, blobs)
    md, _ = pg.read_gguf(str(path))
    assert isinstance(pg.gguf_tokenizer(md), pg.GgufBpeTokenizer)
    with pytest.raises(ValueError, match="not supported"):
        pg.GgufTokenizer.from_metadata(md)


@pytest.fixture(scope="module")
def bpe_tables():
    from tokenizers import ByteLevelBPETokenizer

    ref = ByteLevelBPETokenizer()
    corpus = [
        "hello world how are you doing today",
        "the quick brown fox jumps over the lazy dog",
        "numbers 123 456 789 and punctuation !!! ... ??",
        "don't stop believing, hold on to that feeling",
        "some CamelCase and UPPERCASE and lowercase words",
        "café naïve über straße unicode text",
    ] * 50
    ref.train_from_iterator(corpus, vocab_size=600, min_frequency=1)
    vocab = ref.get_vocab()
    tokens = [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
    merges = [m if isinstance(m, str) else " ".join(m)
              for m in json.loads(ref.to_str())["model"]["merges"]]
    return ref, tokens, merges


@pytest.mark.parametrize("pre", ["gpt2", "llama-bpe"])
def test_bpe_tokenizer_matches_the_reference_and_the_library(bpe_tables,
                                                             pre):
    lib, tokens, merges = bpe_tables
    types = [1] * len(tokens)
    p = pg.GgufBpeTokenizer(tokens, merges, types, add_bos=False, pre=pre)
    r = rg.GgufBpeTokenizer(tokens, merges, types, add_bos=False, pre=pre)
    for text in GOLDEN_TEXTS:
        got = p.encode(text)
        assert got == r.encode(text), text
        if pre == "gpt2":
            assert got == lib.encode(text).ids, text
        assert p.decode(got) == r.decode(got) == text


def test_bpe_llama3_pretokenizer_rules():
    for text, want in (("1234567", ["123", "456", "7"]),
                       ("WE'LL go", ["WE", "'LL", " go"]),
                       ("end.\n\nNew", ["end", ".\n\n", "New"]),
                       ("hello world", ["hello", " world"]),
                       ("  indent", [" ", " indent"])):
        assert pg.llama3_pretokenize(text) == rg.llama3_pretokenize(text) \
            == want
    for text in GOLDEN_TEXTS:
        assert pg.llama3_pretokenize(text) == rg.llama3_pretokenize(text)
        assert pg.gpt2_pretokenize(text) == rg.gpt2_pretokenize(text)


def test_bpe_special_token_splitting():
    base = [chr(c) for c in range(33, 127)]
    tokens = base + ["<|eot_id|>", "<|start_header_id|>"]
    types = [1] * len(base) + [3, 3]
    p = pg.GgufBpeTokenizer(tokens, [], token_types=types, add_bos=False)
    r = rg.GgufBpeTokenizer(tokens, [], token_types=types, add_bos=False)
    text = "<|start_header_id|>hi<|eot_id|>"
    assert p.encode(text) == r.encode(text)
    ids = p.encode(text)
    for skip in (True, False):
        assert p.decode(ids, skip) == r.decode(ids, skip)
    assert p.stop_token_ids == r.stop_token_ids


def _f16(x):
    return np.asarray(x, "<f2").tobytes()


@pytest.mark.parametrize("dtype,bsz", [
    (pg.GGML_Q8_0, 34), (pg.GGML_Q4_0, 18), (pg.GGML_Q4_1, 20),
    (pg.GGML_Q5_0, 22), (pg.GGML_Q5_1, 24)])
def test_dequantize_blocks_match_the_reference(dtype, bsz):
    rng = np.random.RandomState(dtype)
    nblk = 7
    raw = bytearray(rng.randint(0, 256, size=nblk * bsz, dtype=np.uint8))
    for b in range(nblk):   # finite scales (and mins)
        raw[b * bsz:b * bsz + 2] = _f16([rng.uniform(-2, 2)])
        if dtype in (pg.GGML_Q4_1, pg.GGML_Q5_1):
            raw[b * bsz + 2:b * bsz + 4] = _f16([rng.uniform(-2, 2)])
    got = pg.dequantize_tensor(dtype, bytes(raw), nblk * 32)
    want = rg.dequantize_tensor(dtype, bytes(raw), nblk * 32)
    np.testing.assert_array_equal(got, want)


def test_dequantize_float_formats_and_spec_layout():
    x = np.random.RandomState(0).randn(40).astype(np.float32)
    np.testing.assert_array_equal(
        pg.dequantize_tensor(pg.GGML_F32, x.tobytes(), 40), x)
    np.testing.assert_array_equal(
        pg.dequantize_tensor(pg.GGML_F16, x.astype("<f2").tobytes(), 40),
        x.astype(np.float16).astype(np.float32))
    q = np.arange(-16, 16, dtype=np.int8)
    data = _f16([0.5]) + q.tobytes() + _f16([2.0]) + q.tobytes()
    out = pg.dequantize_tensor(pg.GGML_Q8_0, data, 64)
    np.testing.assert_allclose(out[:32], q * 0.5)
    np.testing.assert_allclose(out[32:], q * 2.0)


def test_dequantize_kquant_rejected():
    with pytest.raises(ValueError, match="Q4_K"):
        pg.dequantize_tensor(12, b"", 256)


def _tiny_gguf(path, tie=False):
    cfg = TConfig.tiny(dtype="float32", tie_word_embeddings=tie)
    rng = np.random.RandomState(0)
    H, I, V, L = (cfg.hidden_size, cfg.intermediate_size, len(VOCAB),
                  cfg.num_layers)

    def w(*shape):
        return rng.randn(*shape).astype(np.float32)

    arrays = [("token_embd.weight", w(V, H)),
              ("output_norm.weight", w(H))]
    if not tie:
        arrays.append(("output.weight", w(V, H)))
    for l in range(L):
        arrays += [
            (f"blk.{l}.attn_q.weight", _gguf_permute(w(cfg.q_dim, H),
                                                     cfg.num_heads)),
            (f"blk.{l}.attn_k.weight", _gguf_permute(w(cfg.kv_dim, H),
                                                     cfg.num_kv_heads)),
            (f"blk.{l}.attn_v.weight", w(cfg.kv_dim, H)),
            (f"blk.{l}.attn_output.weight", w(H, cfg.q_dim)),
            (f"blk.{l}.ffn_gate.weight", w(I, H)),
            (f"blk.{l}.ffn_up.weight", w(I, H)),
            (f"blk.{l}.ffn_down.weight", w(H, I)),
            (f"blk.{l}.attn_norm.weight", w(H)),
            (f"blk.{l}.ffn_norm.weight", w(H)),
        ]
    blobs = _tok_metadata()
    blobs[1] = _kv("llama.embedding_length", _T_U32, struct.pack("<I", H))
    _write_gguf_with_data(path, blobs, arrays)
    return str(path)


@pytest.mark.parametrize("dtype,quant,tie", [
    ("float32", None, False), (None, None, False), ("float32", "int8", False),
    (None, "int8", True)], ids=["f32", "bf16", "f32_w8a16", "bf16_w8a16_no_head"])
def test_load_gguf_params_equals_the_reference(tmp_path, dtype, quant, tie):
    """The file without output.weight serves its embedding as the head
    (both loaders), quantized at load under quant=int8."""
    path = _tiny_gguf(tmp_path / "tiny.gguf", tie=tie)
    md, _ = pg.read_gguf(path)
    tcfg = dataclasses.replace(pg.config_from_gguf(md), quant=quant)
    jcfg = dataclasses.replace(rg.config_from_gguf(md), quant=quant)
    if dtype:
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    port = pg.load_gguf_params(tcfg, path, device="cpu")
    ref = rg.load_gguf_params(jcfg, path)
    _assert_equal_trees(port, tl.params_from_jax(_np(ref), device="cpu"))
    assert "lm_head" in port
    ctx = tl.init_ctx(tcfg, 1, 64, tl.torch_dtype(tcfg.dtype), device="cpu")
    lg = tl.prefill(tcfg, port, ctx, torch.arange(1, 17), 0, 0, 16)
    assert torch.isfinite(lg).all()


def _serve(pkg, path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env = {k: v for k, v in env.items() if not k.startswith("DYNTPU_")}
    common = ["in=text", "--model-path", str(path), "--prompt",
              "hello world", "--max-tokens", "4", "--page-size", "16",
              "--num-pages", "32", "--max-decode-slots", "2",
              "--cache-dtype", "float32"]
    cmd = ([sys.executable, "-m", "dynamo_tpu_torch.launch.run",
            "out=torch", "--device", "cpu"] if pkg == "port" else
           [sys.executable, "-m", "dynamo_tpu.cli", "run", "out=tpu"])
    return subprocess.run(cmd + common, capture_output=True, text=True,
                          timeout=240, env=env, cwd=ROOT)


def test_cli_serves_gguf_end_to_end(tmp_path):
    """`launch.run in=text out=torch --model-path x.gguf` serves a
    completion from one GGUF file (config, tokenizer, dequantized
    weights), the text the reference's CLI serves from it."""
    rng = np.random.RandomState(3)
    cfg = TConfig.tiny(dtype="float32")
    s = 1.0 / np.sqrt(cfg.hidden_size)

    def w(*shape, scale=s):
        return rng.randn(*shape).astype(np.float32) * scale

    arrays = [("token_embd.weight", w(len(VOCAB), cfg.hidden_size,
                                       scale=0.02)),
              ("output_norm.weight", np.ones(cfg.hidden_size, np.float32)),
              ("output.weight", w(len(VOCAB), cfg.hidden_size, scale=0.02))]
    for l in range(cfg.num_layers):
        arrays += [
            (f"blk.{l}.attn_q.weight", w(cfg.q_dim, cfg.hidden_size)),
            (f"blk.{l}.attn_k.weight", w(cfg.kv_dim, cfg.hidden_size)),
            (f"blk.{l}.attn_v.weight", w(cfg.kv_dim, cfg.hidden_size)),
            (f"blk.{l}.attn_output.weight", w(cfg.hidden_size, cfg.q_dim)),
            (f"blk.{l}.ffn_gate.weight", w(cfg.intermediate_size,
                                           cfg.hidden_size)),
            (f"blk.{l}.ffn_up.weight", w(cfg.intermediate_size,
                                         cfg.hidden_size)),
            (f"blk.{l}.ffn_down.weight", w(cfg.hidden_size,
                                           cfg.intermediate_size)),
            (f"blk.{l}.attn_norm.weight", np.ones(cfg.hidden_size,
                                                  np.float32)),
            (f"blk.{l}.ffn_norm.weight", np.ones(cfg.hidden_size,
                                                 np.float32)),
        ]
    path = tmp_path / "served.gguf"
    _write_gguf_with_data(path, _tok_metadata(), arrays)
    port, ref = _serve("port", path), _serve("ref", path)
    assert port.returncode == 0, port.stderr[-2000:]
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert any(line.strip() for line in port.stdout.splitlines())
    assert port.stdout == ref.stdout
