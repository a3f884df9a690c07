"""TorchEngine against TpuEngine on ModelConfig.tiny (f32) with the same
weights: greedy outputs must be token-identical across concurrent
requests, a prefix-cache hit, an EOS stop and a prompt longer than one
prefill bucket. Plus the port's import isolation and its refusal to fall
back to the CPU silently."""
import asyncio
import subprocess
import sys
from pathlib import Path

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
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols import common as tproto

ENGINE_KW = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                 max_decode_slots=4, prefill_buckets=(32, 64),
                 cache_dtype="float32")
# 5 concurrent prompts over 4 slots; the last one spans two 64-token
# prefill chunks (100 tokens, max context 128)
PROMPTS = [list(range(1 + i, 30 + 3 * i)) for i in range(4)] + [
    [int(t) for t in np.random.RandomState(0).randint(1, 256, size=100)]]
N_NEW = 12


async def _collect(engine, proto, prompt, n_new, stop=()):
    req = proto.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=proto.StopConditions(
            max_tokens=n_new, stop_token_ids=list(stop),
            ignore_eos=not stop),
    )
    toks, finish, ann = [], None, {}
    async for out in engine.generate(req):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            finish, ann = out.finish_reason.value, out.annotations
    return toks, finish, ann


async def _drive(engine, proto, stop_token=None):
    """Concurrent batch, then a repeat of the first prompt (prefix hit),
    then the first prompt again with an EOS stop token."""
    batch = await asyncio.gather(
        *[_collect(engine, proto, p, N_NEW) for p in PROMPTS])
    repeat = await _collect(engine, proto, PROMPTS[0], N_NEW)
    eos = None
    if stop_token is not None:
        eos = await _collect(engine, proto, PROMPTS[0], N_NEW,
                             stop=[stop_token])
    await engine.stop()
    return batch, repeat, eos


def _stop_token(toks):
    """A token of the greedy stream first seen at index >= 2."""
    for i in range(2, len(toks)):
        if toks[i] not in toks[:i]:
            return toks[i], i
    pytest.skip("greedy stream repeats one token throughout")


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    return jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def reference(weights):
    eng = TpuEngine(JConfig.tiny(dtype="float32"),
                    JEngineConfig(**ENGINE_KW), params=weights[0],
                    mesh_config=MeshConfig(tp=1))
    batch, _, _ = asyncio.run(_drive(eng, jproto))
    stop, idx = _stop_token(batch[0][0])
    eng = TpuEngine(JConfig.tiny(dtype="float32"),
                    JEngineConfig(**ENGINE_KW), params=weights[0],
                    mesh_config=MeshConfig(tp=1))
    return asyncio.run(_drive(eng, jproto, stop)), stop, idx


def test_torch_engine_greedy_identical_to_tpu_engine(weights, reference):
    (jbatch, jrepeat, jeos), stop, idx = reference
    eng = TorchEngine(TConfig.tiny(dtype="float32"),
                      TEngineConfig(**ENGINE_KW),
                      params=params_from_jax(weights[1], device="cpu"),
                      device="cpu")
    tbatch, trepeat, teos = asyncio.run(_drive(eng, tproto, stop))
    for (tt, tf, _), (jt, jf, _) in zip(tbatch, jbatch):
        assert (tt, tf) == (jt, jf)
        assert len(tt) == N_NEW and tf == "length"
    # prefix hit: 29-token prompt = one complete 16-token block matched
    assert trepeat[:2] == jrepeat[:2] == (jbatch[0][0], "length")
    assert trepeat[2]["cached_blocks"] == 1
    assert eng.allocator.hit_blocks >= 1
    # EOS: the stop token ends the stream and is not emitted
    assert teos[:2] == jeos[:2] == (jbatch[0][0][:idx], "eos")
    assert stop not in teos[0]
    # every decode step launched no kernel on the CPU: the plain version
    assert eng.kernel_launches == 0 and eng.step_count > 0
    # one device->host copy per round and per first token, nothing else
    dc = eng.dispatch_counts
    assert dc["fetch"] == dc["round"] + dc["round_seal"] + dc["sample_first"]
    assert dc["round"] + dc["round_seal"] == (
        eng.step_count // eng.ecfg.flush_every)


def test_torch_engine_without_device_refuses_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEngine(TConfig.tiny(dtype="float32"), TEngineConfig(**ENGINE_KW))


def test_unported_engine_knobs_raise():
    TEngineConfig(kv_quant="int8")  # ported
    assert TEngineConfig().round_pipeline is True  # ported, on by default
    TEngineConfig(round_pipeline=False)  # the strict order stays reachable
    with pytest.raises(ValueError, match="kv_quant"):
        TEngineConfig(kv_quant="fp8")
    with pytest.raises(ValueError, match="speculative"):
        TEngineConfig(speculative="ngram")
    with pytest.raises(ValueError, match="preempt_running"):
        TEngineConfig(preempt_running=True)


def test_logprobs_request_gets_a_clear_error():
    """Logprobs are served (tests/test_torch_engine_int8.py); a negative
    count is refused up front."""
    eng = TorchEngine(TConfig.tiny(dtype="float32"),
                      TEngineConfig(**ENGINE_KW), device="cpu")
    req = tproto.PreprocessedRequest(
        token_ids=[1, 2, 3],
        output_options=tproto.OutputOptions(logprobs=-1))

    async def run():
        async for _ in eng.generate(req):
            pass

    with pytest.raises(ValueError, match="logprobs"):
        asyncio.run(run())


def test_port_imports_neither_jax_nor_the_jax_package():
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys, pkgutil, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'dynamo_tpu'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import dynamo_tpu_torch\n"
        "import dynamo_tpu_torch.runtime, dynamo_tpu_torch.frontend.watcher\n"
        "import dynamo_tpu_torch.cli\n"
        "import dynamo_tpu_torch.kv_router, dynamo_tpu_torch.kv_router.router\n"
        "import dynamo_tpu_torch.kv_router.indexer\n"
        "import dynamo_tpu_torch.kv_router.scheduler\n"
        "import dynamo_tpu_torch.kv_router.sequence\n"
        "import dynamo_tpu_torch.kv_router.metrics_aggregator\n"
        "import dynamo_tpu_torch.resilience.health\n"
        "import dynamo_tpu_torch.resilience.migration\n"
        "import dynamo_tpu_torch.resilience.metrics\n"
        "import dynamo_tpu_torch.overload.load\n"
        "import dynamo_tpu_torch.overload.metrics\n"
        "import dynamo_tpu_torch.recorder, dynamo_tpu_torch.router_service\n"
        "import dynamo_tpu_torch.kv_transfer, dynamo_tpu_torch.disagg\n"
        "import dynamo_tpu_torch.kv_transfer_metrics\n"
        "import dynamo_tpu_torch.resilience.chaos\n"
        "import dynamo_tpu_torch.resilience.drain\n"
        "import dynamo_tpu_torch.resilience.shared\n"
        "import dynamo_tpu_torch.runtime.system_server\n"
        "import dynamo_tpu_torch.tools.chaos\n"
        "import dynamo_tpu_torch.tools.scrub_kv\n"
        "for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__, "
        "'dynamo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dynamo_tpu' or m.startswith('dynamo_tpu.')"
        " or m == 'aiohttp' or m.startswith('aiohttp.')]\n"
        "assert len([m for m in sys.modules if m.startswith("
        "'dynamo_tpu_torch.')]) >= 15, sorted(sys.modules)\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
