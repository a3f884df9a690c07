"""``python -m dynamo_tpu_torch.cli llmctl`` against the JAX package's
llmctl: add (a static registration, with ``--model-path`` the model card
uploaded through model_card.upload_card), list and remove leave the same
store keys and values and print the same lines, each package's CLI on a
store of its own."""
import asyncio

import pytest

from dynamo_tpu import cli as rcli
from dynamo_tpu_torch import cli as pcli
from dynamo_tpu_torch.runtime.client import KvClient
from dynamo_tpu_torch.runtime.store import serve_store
from tests.test_model_card import build_model_dir

CLIS = {"ref": rcli.main, "port": pcli.main}


async def _session(which, capsys, steps):
    """Run ``steps`` (llmctl argument lists) on a fresh store with one
    package's CLI; each step's printed text and the store's keys and
    values after it."""
    server, _ = await serve_store(port=0, sweep_interval_s=0.05)
    port = server.sockets[0].getsockname()[1]
    kv = await KvClient(port=port).connect()
    out = []
    try:
        for argv in steps:
            # the CLI runs its own loop: in a thread
            rc = await asyncio.to_thread(
                CLIS[which], ["llmctl", "--control-plane",
                              f"127.0.0.1:{port}", *argv])
            assert rc == 0
            out.append((capsys.readouterr().out,
                        sorted((k, v) for k, v, _ in
                               await kv.get_prefix("dynamo://"))))
    finally:
        await kv.close()
        server.close()
    return out


@pytest.mark.parametrize("card", [False, True], ids=["plain", "card"])
async def test_llmctl_equals_the_reference(tmp_path, capsys, card):
    extra = ["--model-path", build_model_dir(tmp_path)] if card else []
    steps = [
        ["list"],
        ["add", "ext-model", "--component", "extbackend",
         "--router-mode", "round_robin", "--block-size", "16",
         "--context-length", "4096", *extra],
        ["list"],
        ["add", "other"],
        ["remove", "ext-model"],
        ["list"],
        ["remove", "other"],
    ]
    ref = await _session("ref", capsys, steps)
    port = await _session("port", capsys, steps)
    assert port == ref
    printed, keys = port[1]
    models = [k for k, _ in keys if "/_models/" in k]
    assert models == ["dynamo://dynamo/_models/ext-model/static"]
    assert any("cards/dynamo/ext-model" in k for k, _ in keys) == card
    assert "ext-model: 1 registration(s), 0 instance(s) at " \
        "extbackend/generate [round_robin, block=16]" in port[2][0]
    assert port[4][0] == "removed 1 registration(s) for ext-model\n"
    assert port[-1][1] == []   # nothing left behind
