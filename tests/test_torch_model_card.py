"""The port's model resolver and model card against the JAX package's: the
resolver's cases (tests/test_model_resolver.py), a card round trip
through the port's store, and a discovering frontend with no access to a
worker's model directory that serves chat with the checkpoint's
tokenizer and template from the card, answering as the JAX package's
frontend does over the same worker."""
import asyncio
import json

import pytest

from dynamo_tpu import model_resolver as rres
from dynamo_tpu import tokenizer as rtok
from dynamo_tpu_torch import model_resolver as pres
from dynamo_tpu_torch import tokenizer as ptok
from dynamo_tpu_torch.engines import EchoEngine as PEcho
from dynamo_tpu_torch.frontend.watcher import ModelEntry as PModelEntry
from dynamo_tpu_torch.frontend.watcher import register_llm as p_register_llm
from dynamo_tpu_torch.model_card import (
    CARD_FILES,
    MAX_ARTIFACT_BYTES,
    delete_card,
    download_card,
    upload_card,
)
from dynamo_tpu_torch.runtime.client import KvClient
from dynamo_tpu_torch.runtime.store import serve_store
from tests.test_torch_distributed import SIDE
from tests.test_torch_frontend import CHAT
from tests.test_torch_hf_tokenizer import _build

TEMPLATE = (
    "{{- bos_token }}{%- for m in messages %}<|start_header_id|>"
    "{{ m.role }}<|end_header_id|>\n\n{{ m.content | trim }}<|eot_id|>"
    "{%- endfor %}{%- if add_generation_prompt %}<|start_header_id|>"
    "assistant<|end_header_id|>\n\n{%- endif %}")


@pytest.fixture(autouse=True)
def _fresh_resolutions():
    pres.resolver_cache_clear()
    rres.resolver_cache_clear()
    yield
    pres.resolver_cache_clear()
    rres.resolver_cache_clear()


def _both(spec):
    out = []
    for mod in (pres, rres):
        try:
            r = mod.resolve_model(spec)
            out.append((r.kind, r.path))
        except FileNotFoundError as e:
            out.append(("error", str(e)))
    return out


def test_local_dir(tmp_path):
    d = tmp_path / "model"
    d.mkdir()
    p, r = _both(str(d))
    assert p == r == ("dir", str(d))
    # an alias of the same directory resolves to the first resolution
    assert pres.resolve_model(str(d) + "/") is pres.resolve_model(str(d))


def test_gguf_file(tmp_path):
    f = tmp_path / "m.gguf"
    f.write_bytes(b"GGUF")
    p, r = _both(str(f))
    assert p == r == ("gguf", str(f))


def test_cached_hub_id(tmp_path, monkeypatch):
    snap = tmp_path / "hub" / "models--org--name" / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    (snap / "config.json").write_text("{}")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    p, r = _both("org/name")
    assert p == r == ("dir", str(snap))


def test_uncached_hub_id_errors_with_guidance(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "empty2"))
    p, r = _both("org/missing-model")
    assert p == r and p[0] == "error" and "no egress" in p[1]


def test_bogus_path_errors():
    p, r = _both("/no/such/dir")
    assert p == r and "does not exist" in p[1]


def _model_dir(tmp_path) -> str:
    d = _build("llama3", tmp_path / "model")
    (tmp_path / "model" / "tokenizer_config.json").write_text(json.dumps({
        "chat_template": TEMPLATE, "bos_token": "<|begin_of_text|>",
        "eos_token": {"content": "<|eot_id|>"}}))
    return d


async def test_card_roundtrip_through_the_port_store(tmp_path):
    from dynamo_tpu import model_card as rcard

    assert CARD_FILES == rcard.CARD_FILES
    assert MAX_ARTIFACT_BYTES == rcard.MAX_ARTIFACT_BYTES
    d = _model_dir(tmp_path)
    server, _ = await serve_store(port=0, sweep_interval_s=0.05)
    kv = await KvClient(port=server.sockets[0].getsockname()[1]).connect()
    try:
        bucket = await upload_card(kv, "ns", "m1", d)
        assert bucket == "cards/ns/m1"
        dest = await download_card(kv, bucket, str(tmp_path / "dl"))
        got = ptok.HfTokenizer.from_dir(dest)
        want = rtok.HfTokenizer.from_dir(d)
        text = "<|begin_of_text|>Hello, world! 123 café"
        assert got.encode(text) == want.encode(text)
        assert got.eos_token_ids == want.eos_token_ids
        await delete_card(kv, bucket)
        assert await download_card(kv, bucket) is None
        empty = tmp_path / "empty"
        empty.mkdir()
        assert await upload_card(kv, "ns", "m2", str(empty)) is None
    finally:
        await kv.close()
        server.close()


async def _serve_chat(front_pk, model_dir):
    """A port worker registered with the checkpoint, then a ``front_pk``
    frontend started that does not share its filesystem (the entry's
    model_path rewritten away first); the chat answer, the frontend
    chain's tokenizer and the cards the frontend downloaded."""
    store_srv, _ = await SIDE["port"]["serve_store"](port=0,
                                                     sweep_interval_s=0.05)
    port = store_srv.sockets[0].getsockname()[1]
    rt = await SIDE["port"]["Runtime"].connect(port=port)
    eng = PEcho(delay_s=0.0)
    entry = PModelEntry(name="ckpt", namespace="cm", component="backend",
                        block_size=16, model_path=model_dir)
    served = await p_register_llm(rt, eng, entry)
    assert entry.card_ref == "cards/cm/ckpt"
    moved = json.loads(entry.to_json())
    moved["model_path"] = "/nonexistent/elsewhere"
    await rt.kv.put(f"dynamo://cm/_models/ckpt/{served.lease_id}",
                    json.dumps(moved), lease=served.lease_id)
    side = SIDE[front_pk]
    frt = await side["Runtime"].connect(port=port)
    manager = side["Manager"]()
    watcher = await side["Watcher"](frt, manager, namespace="cm").start()
    try:
        async with side["Http"](manager) as http:
            for _ in range(600):
                if manager.list_models() == ["ckpt"]:
                    break
                await asyncio.sleep(0.02)
            st, _, body = await http.call("POST", CHAT, {
                "model": "ckpt", "max_tokens": 64,
                "messages": [{"role": "user",
                              "content": " Hello, world! 123 café "}]})
            assert st == 200, body
            tok = manager.get("ckpt").preprocessor.tokenizer
            return (body["choices"][0]["message"]["content"], tok,
                    list(watcher._card_dirs))
    finally:
        await watcher.stop()
        await frt.close()
        await served.shutdown()
        await rt.close()
        store_srv.close()


async def test_frontend_serves_chat_with_the_card_tokenizer(tmp_path):
    d = _model_dir(tmp_path)
    got, ptk, pcards = await _serve_chat("port", d)
    want, rtk, rcards = await _serve_chat("ref", d)
    assert pcards == rcards == ["cards/cm/ckpt"]
    assert isinstance(ptk, ptok.HfTokenizer)
    assert isinstance(rtk, rtok.HfTokenizer)
    assert got == want
    # the echo carries the rendered prompt back up to its first EOS
    # (<|eot_id|>): the template's markup and the trimmed message went
    # through the checkpoint's tokenizer and back
    assert got == "user\n\nHello, world! 123 café"
