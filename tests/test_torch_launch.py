"""The port's launcher (python -m dynamo_tpu_torch.launch.run) against the
JAX package's: its parser takes every flag of the reference's with the
same defaults and refuses the flags of planes the port does not serve;
in=text, in=stdin, in=batch and in=http run end to end in a subprocess;
and with jax, the JAX package and the reference's third-party packages
made unimportable, every module of the port imports and the launcher
serves a prompt (the card's machine needs none of them)."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from dynamo_tpu.launch import run as rrun
from dynamo_tpu_torch.launch import run as prun

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "dynamo_tpu", "aiohttp", "pydantic", "prometheus_client",
           "tokenizers", "jinja2", "xxhash")
TINY_TEXT = ["in=text", "out=torch", "--device", "cpu", "--model-config",
             "tiny", "--cache-dtype", "float32", "--prompt", "w1 w2 w3",
             "--max-tokens", "8"]


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DYNTPU_")}
    env["PYTHONPATH"] = str(ROOT)
    return env


def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings}


def test_parser_takes_every_reference_flag_with_its_default(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DYNTPU_"):
            monkeypatch.delenv(k)
    ref, port = _options(rrun.build_parser()), _options(prun.build_parser())
    missing = sorted(set(ref) - set(port))
    assert not missing, f"reference flags the port does not parse: {missing}"
    for flag, (kw, _) in prun.UNPORTED_FLAGS.items():
        assert port[flag].default == ref[flag].default, flag
        assert port[flag].choices == ref[flag].choices, flag
    for flag in ("--http-host", "--http-port", "--num-pages", "--page-size",
                 "--max-decode-slots", "--cache-dtype", "--kv-quant",
                 "--round-pipeline", "--max-tokens", "--trace-block-size",
                 "--control-plane", "--namespace", "--component",
                 "--endpoint-name", "--router-mode", "--record-kv-events"):
        assert port[flag].default == ref[flag].default, flag
        assert port[flag].choices == ref[flag].choices, flag
    args = prun.build_parser().parse_intermixed_args(
        ["--prompt", "x", "in=text", "--max-tokens", "3", "out=echo"])
    assert (args.io, args.prompt, args.max_tokens) == (
        ["in=text", "out=echo"], "x", 3)
    prun.refuse_unported(args)  # every unported flag at its default


@pytest.mark.parametrize("io,want", [
    ([], ("http", "echo")),
    (["in=text", "out=torch"], ("text", "torch")),
    (["out=echo", "in=batch:/tmp/x.jsonl"], ("batch:/tmp/x.jsonl", "echo")),
])
def test_parse_io_matches_reference(io, want):
    assert prun._parse_io(io) == rrun._parse_io(io) == want


def test_parse_io_refuses_other_words():
    with pytest.raises(SystemExit, match="unrecognized"):
        prun._parse_io(["serve"])


@pytest.mark.parametrize("argv,match", [
    (["out=torch", "--model-config", "tiny", "--speculative", "draft"],
     "--speculative draft needs --draft-model-config"),
    (["in=endpoint"], "in=endpoint requires --control-plane"),
    (["--model-path", "/models/x"], "--model-path"),
    (["--tensor-parallel-size", "2"], "--tensor-parallel-size=2"),
    (["--num-nodes", "2", "--role", "decode"], "--num-nodes=2"),
    (["--forensics-sample-rate", "0.5"], "--forensics-sample-rate=0.5"),
    (["--preempt-running", "on"], "running preemption"),
    (["--spec-tree", "on"], "--spec-tree='on'"),
    (["out=mocker"], "mocker"),
    (["out=torch", "--model-config", "llama3_70b"], "llama3_70b"),
    (["out=torch"], "needs --model-config"),
    (["in=carrier-pigeon"], "unknown input"),
])
def test_unported_flags_and_modes_exit_with_a_clear_message(argv, match):
    if argv[0] in ("--spec-tree", "--preempt-running"):
        # served (tree speculation; running preemption): the launcher
        # runs, no refusal
        assert argv[0] not in prun.UNPORTED_FLAGS
        assert prun.run_cli(["in=text", "out=echo", "--prompt", "x"]
                            + argv) == 0
        return
    with pytest.raises(SystemExit) as e:
        prun.run_cli(["in=text", "--prompt", "x"] + argv)
    assert match in str(e.value)


def _run(argv, **kw):
    return subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run"] + argv,
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True,
        timeout=120, **kw)


def test_text_prompt_on_the_tiny_torch_engine():
    out = _run(TINY_TEXT)
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.splitlines()) == 1


def test_batch_and_stdin_on_echo_match_reference(tmp_path):
    batch = tmp_path / "prompts.jsonl"
    batch.write_text(json.dumps({"prompt": "w1 w2"}) + "\n"
                     + json.dumps({"prompt": "w7", "max_tokens": 2}) + "\n")
    port = _run([f"in=batch:{batch}", "out=echo", "--max-tokens", "4"])
    ref = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu.cli", "run", f"in=batch:{batch}",
         "out=echo", "--max-tokens", "4"], cwd=ROOT, env=_clean_env(),
        capture_output=True, text=True, timeout=120)
    assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout == ref.stdout
    assert [json.loads(line)["text"] for line in port.stdout.splitlines()] \
        == [" w1 w2", " w7"]
    assert "batch_summary" in port.stderr
    # the default template puts <unk> (no text) before the prompt's words
    out = _run(["in=stdin", "out=echo", "--max-tokens", "3"],
               input="w3 w4\n\nw5\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [" w3 w4", " w5"]


def test_http_input_serves_the_openai_api():
    import asyncio

    from dynamo_tpu_torch.frontend.http import HttpClient

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=http",
         "out=echo", "--http-host", "127.0.0.1", "--http-port", str(port),
         "--model-name", "m"],
        cwd=ROOT, env=_clean_env(), stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert f"http://127.0.0.1:{port}" in line, line

        async def ask():
            async with HttpClient("127.0.0.1", port) as c:
                r = await c.request("POST", "/v1/chat/completions",
                                    json_body={"model": "m", "max_tokens": 3,
                                               "messages": [{"role": "user",
                                                             "content": "w1"}]})
                return r.status, r.json()

        status, body = asyncio.run(asyncio.wait_for(ask(), 30))
        assert status == 200
        assert body["choices"][0]["finish_reason"] == "length"
        assert body["choices"][0]["message"]["content"] == " w1"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_port_runs_with_reference_packages_unimportable():
    """A meta-path finder refuses jax, the JAX package and the reference's
    third-party packages; every module of the port then imports, and the
    launcher serves a prompt on the tiny engine."""
    code = (
        "import sys, importlib, pkgutil\n"
        f"BLOCKED = {BLOCKED!r}\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        "for b in BLOCKED:\n"
        "    try:\n"
        "        importlib.import_module(b)\n"
        "    except ImportError:\n"
        "        pass\n"
        "    else:\n"
        "        raise SystemExit(f'{b} was importable')\n"
        "import dynamo_tpu_torch\n"
        "import dynamo_tpu_torch.runtime, dynamo_tpu_torch.frontend.watcher\n"
        "import dynamo_tpu_torch.cli, dynamo_tpu_torch.kv_router\n"
        "import dynamo_tpu_torch.router_service, dynamo_tpu_torch.recorder\n"
        "import dynamo_tpu_torch.resilience, dynamo_tpu_torch.overload.load\n"
        "import dynamo_tpu_torch.kv_router.prefetch\n"
        "import dynamo_tpu_torch.kv_fleet_metrics\n"
        "import dynamo_tpu_torch.tools.kv_fleet\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "dynamo_tpu_torch.__path__, 'dynamo_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 30, mods\n"
        "from dynamo_tpu_torch.launch.run import run_cli\n"
        f"sys.exit(run_cli({TINY_TEXT!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert len(out.stdout.splitlines()) == 1


@pytest.mark.parametrize("cmd", ["serve", "metrics", "profile", "planner",
                                 "llmctl"])
def test_cli_refuses_the_reference_commands_by_name(cmd, capsys):
    from dynamo_tpu_torch import cli

    assert cli.main([cmd]) == 2
    assert f"{cmd}: " in capsys.readouterr().err


ROLE_FLAGS = ("--kv-transfer-chunk-pages", "--kv-transfer-inflight-chunks",
              "--xfer-op-timeout", "--kv-transfer-stream-idle-timeout",
              "--role", "--max-local-prefill-length",
              "--max-prefill-queue-size", "--remote-kv", "--prefill-timeout")


def test_role_and_transfer_flags_parse_with_the_reference_defaults(
        monkeypatch):
    for k in list(os.environ):
        if k.startswith("DYNTPU_"):
            monkeypatch.delenv(k)
    ref, port = _options(rrun.build_parser()), _options(prun.build_parser())
    for flag in ROLE_FLAGS:
        assert flag not in prun.UNPORTED_FLAGS, flag
        assert port[flag].default == ref[flag].default, flag
        assert port[flag].choices == ref[flag].choices, flag
        assert type(port[flag]) is type(ref[flag]), flag
    for role in ("prefill", "decode"):
        argv = ["in=endpoint", "out=torch", "--role", role,
                "--max-local-prefill-length", "64",
                "--kv-transfer-chunk-pages", "0", "--prefill-timeout", "5"]
        args = prun.build_parser().parse_intermixed_args(argv)
        want = rrun.build_parser().parse_intermixed_args(argv)
        for flag in ROLE_FLAGS:
            key = flag[2:].replace("-", "_")
            assert getattr(args, key) == getattr(want, key), flag
        prun.refuse_unported(args)
    # the transfer flags reach the engine's config
    args = prun.build_parser().parse_intermixed_args(
        ["in=text", "out=torch", "--model-config", "tiny", "--device", "cpu",
         "--cache-dtype", "float32", "--kv-transfer-chunk-pages", "3",
         "--kv-transfer-inflight-chunks", "4", "--xfer-op-timeout", "9",
         "--kv-transfer-stream-idle-timeout", "7"])
    _, chain = prun.build_chain(args)
    try:
        e = chain.engine.ecfg
        assert (e.kv_transfer_chunk_pages, e.kv_transfer_inflight_chunks,
                e.xfer_op_timeout_s, e.kv_transfer_stream_idle_timeout_s) \
            == (3, 4, 9.0, 7.0)
    finally:
        import asyncio

        asyncio.run(chain.engine.stop())


RESILIENCE_FLAGS = ("--system-port", "--chaos", "--health-heartbeat-ttl",
                    "--drain-timeout")


def test_resilience_flags_parse_with_the_reference_defaults(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DYNTPU_"):
            monkeypatch.delenv(k)
    ref, port = _options(rrun.build_parser()), _options(prun.build_parser())
    for flag in RESILIENCE_FLAGS:
        assert flag not in prun.UNPORTED_FLAGS, flag
        assert port[flag].default == ref[flag].default, flag
        assert port[flag].type == ref[flag].type, flag
        assert port[flag].help == ref[flag].help or flag == "--chaos", flag
    argv = ["in=endpoint", "--system-port", "0", "--chaos",
            "delay:t=0.01", "--health-heartbeat-ttl", "2",
            "--drain-timeout", "5"]
    args = prun.build_parser().parse_intermixed_args(argv)
    want = rrun.build_parser().parse_intermixed_args(argv)
    for flag in RESILIENCE_FLAGS:
        key = flag[2:].replace("-", "_")
        assert getattr(args, key) == getattr(want, key), flag
    prun.refuse_unported(args)


def test_chaos_spec_is_armed_before_serving(monkeypatch):
    """--chaos (or DYNAMO_CHAOS) arms the process's points before the
    chain runs; a bad spec exits before anything starts."""
    from dynamo_tpu_torch.resilience.chaos import CHAOS

    CHAOS.reset()
    try:
        monkeypatch.setenv("DYNAMO_CHAOS", "delay:t=0.001:once")
        assert prun.run_cli(["in=text", "out=echo", "--prompt", "w1"]) == 0
        d = CHAOS.points["delay"]
        assert d.armed and d.once and d.delay_s == 0.001
        with pytest.raises(ValueError, match="unknown chaos point"):
            prun.run_cli(["in=text", "out=echo", "--prompt", "w1",
                          "--chaos", "explode"])
    finally:
        CHAOS.reset()


def test_remote_kv_without_a_g2_tier_exits_with_the_reference_message():
    import asyncio

    args = prun.build_parser().parse_intermixed_args(
        ["in=endpoint", "out=echo", "--remote-kv", "--control-plane",
         "127.0.0.1:1"])
    _, chain = prun.build_chain(args)
    with pytest.raises(SystemExit) as e:
        asyncio.run(prun.serve_worker(args, chain, None))
    assert str(e.value) == (
        "--remote-kv needs a G2 host tier (--host-offload-pages > 0)")
    # the reference's message, from its launcher's source
    import inspect

    assert str(e.value).split(" (")[0] in inspect.getsource(
        rrun._serve_worker)


FLEET_FLAGS = ("--kv-replication-target", "--kv-prefetch-hot-k",
               "--kv-prefetch-interval", "--kv-freq-halflife",
               "--no-kv-dedup-admission")
FLEET_FIELDS = ("kv_replication_target", "kv_prefetch_hot_k",
                "kv_prefetch_interval_s", "kv_freq_halflife_s",
                "kv_dedup_admission")
# what the parser still refuses: the reference's flags of planes the port
# does not serve yet (the fleet economy's five left this list, then the
# linear speculation's eight, then tree speculation's three, then the
# overload plane's three)
REFUSED = {
    "--model-path", "--trace-sample-rate", "--tensor-parallel-size",
    "--prof-attribution", "--slo-ttft-target",
    "--slo-itl-target", "--slo-objective", "--forensics-sample-rate",
    "--num-nodes", "--node-rank", "--leader-addr",
}
OVERLOAD_FLAGS = {"--max-waiting-requests": ("7", "max_waiting_requests", 7),
                  "--max-waiting-prefill-tokens": (
                      "4096", "max_waiting_prefill_tokens", 4096),
                  "--preempt-running": ("on", "preempt_running", True)}


@pytest.mark.parametrize("layer", ["defaults", "toml", "env"])
def test_fleet_flags_parse_with_the_reference_defaults_and_layering(
        layer, monkeypatch, tmp_path):
    from dynamo_tpu.config import load_config as rload
    from dynamo_tpu_torch.config import load_config as pload

    for k in list(os.environ):
        if k.startswith("DYNTPU_"):
            monkeypatch.delenv(k)
    monkeypatch.chdir(tmp_path)   # no ./dynamo_tpu.toml in the way
    if layer == "toml":
        path = tmp_path / "fleet.toml"
        path.write_text("[runtime]\nkv_replication_target = 3\n"
                        "kv_prefetch_hot_k = 24\n"
                        "kv_prefetch_interval_s = 0.5\n"
                        "kv_freq_halflife_s = 0.0\n"
                        "kv_dedup_admission = false\n")
        monkeypatch.setenv("DYNTPU_CONFIG", str(path))
    elif layer == "env":
        for k, v in (("KV_REPLICATION_TARGET", "1"),
                     ("KV_PREFETCH_HOT_K", "4"),
                     ("KV_PREFETCH_INTERVAL_S", "0.25"),
                     ("KV_FREQ_HALFLIFE_S", "60"),
                     ("KV_DEDUP_ADMISSION", "0")):
            monkeypatch.setenv("DYNTPU_" + k, v)
    want, got = rload(), pload()
    assert [getattr(got, f) for f in FLEET_FIELDS] == \
        [getattr(want, f) for f in FLEET_FIELDS]
    if layer != "defaults":
        assert got.kv_replication_target != 2 and not got.kv_dedup_admission
    ref, port = _options(rrun.build_parser()), _options(prun.build_parser())
    for flag in FLEET_FLAGS:
        assert flag not in prun.UNPORTED_FLAGS, flag
        assert port[flag].default == ref[flag].default, flag
        assert port[flag].type == ref[flag].type, flag
        assert port[flag].help == ref[flag].help, flag
    argv = ["in=http", "--control-plane", "127.0.0.1:1",
            "--kv-replication-target", "3", "--kv-prefetch-hot-k", "16",
            "--kv-prefetch-interval", "0.5", "--kv-freq-halflife", "0",
            "--no-kv-dedup-admission"]
    args = prun.build_parser().parse_intermixed_args(argv)
    ref_args = rrun.build_parser().parse_intermixed_args(argv)
    for flag in FLEET_FLAGS:
        key = flag[2:].replace("-", "_")
        assert getattr(args, key) == getattr(ref_args, key), flag
    prun.refuse_unported(args)


def test_the_refused_flags_lost_exactly_the_fleet_five():
    assert set(prun.UNPORTED_FLAGS) == REFUSED
    assert not set(FLEET_FLAGS) & set(prun.UNPORTED_FLAGS)
    parsed = set(_options(prun.build_parser()))
    assert set(FLEET_FLAGS) <= parsed


@pytest.mark.parametrize("argv,controller", [
    ([], (2, 8, 2.0)),
    (["--kv-replication-target", "1"], None),
    (["--kv-replication-target", "0"], None),
    (["--kv-replication-target", "3", "--kv-prefetch-hot-k", "24",
      "--kv-prefetch-interval", "0.5"], (3, 24, 0.5)),
])
def test_the_frontend_builds_a_controller_only_above_one_copy(
        argv, controller, monkeypatch):
    for k in list(os.environ):
        if k.startswith("DYNTPU_"):
            monkeypatch.delenv(k)
    args = prun.build_parser().parse_intermixed_args(
        ["in=http", "--control-plane", "127.0.0.1:1"] + argv)
    got = prun.fleet_configs(args)
    assert got["router_config"].freq_halflife_s == 600.0
    p = got["prefetch_config"]
    assert (None if p is None else (p.replication_target, p.hot_k,
                                    p.interval_s)) == controller
    args.kv_freq_halflife = 0.0   # raw counters
    assert prun.fleet_configs(args)["router_config"].freq_halflife_s is None


@pytest.mark.parametrize("flag,want", [([], True),
                                       (["--no-kv-dedup-admission"], False)])
def test_no_kv_dedup_admission_reaches_the_engine_config(flag, want):
    import asyncio

    args = prun.build_parser().parse_intermixed_args(
        ["in=text", "out=torch", "--model-config", "tiny", "--device", "cpu",
         "--cache-dtype", "float32"] + flag)
    _, chain = prun.build_chain(args)
    try:
        assert chain.engine.ecfg.kv_dedup_admission is want
    finally:
        asyncio.run(chain.engine.stop())


@pytest.mark.parametrize("flag", sorted(OVERLOAD_FLAGS))
def test_overload_flag_parses_as_the_reference_and_reaches_engine_config(
        flag, monkeypatch):
    """Each overload flag is served with the reference's default, type,
    choices and help, and its value lands in the EngineConfig of the
    engine the launcher builds."""
    from dynamo_tpu_torch.engine.engine import TorchEngine

    assert flag not in prun.UNPORTED_FLAGS
    ref, port = _options(rrun.build_parser()), _options(prun.build_parser())
    for attr in ("default", "type", "choices", "help"):
        assert getattr(port[flag], attr) == getattr(ref[flag], attr), attr
    value, field, want = OVERLOAD_FLAGS[flag]
    built = []
    orig = TorchEngine.__init__

    def spy(self, cfg, ecfg=None, **kw):
        built.append(ecfg)
        orig(self, cfg, ecfg, **kw)

    monkeypatch.setattr(TorchEngine, "__init__", spy)
    assert prun.run_cli(["in=text", "out=torch", "--model-config", "tiny",
                         "--cache-dtype", "float32", "--device", "cpu",
                         "--prompt", "w1 w2", "--max-tokens", "2",
                         flag, value]) == 0
    assert getattr(built[-1], field) == want
