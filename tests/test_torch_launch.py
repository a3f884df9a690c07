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
    (["--speculative", "ngram"], "--speculative='ngram'"),
    (["in=endpoint"], "in=endpoint requires --control-plane"),
    (["--model-path", "/models/x"], "--model-path"),
    (["--tensor-parallel-size", "2"], "--tensor-parallel-size=2"),
    (["--num-nodes", "2", "--role", "decode"], "--num-nodes=2"),
    (["--remote-kv"], "--remote-kv=True"),
    (["--preempt-running", "on"], "running preemption"),
    (["--system-port", "9000"], "--system-port=9000"),
    (["out=mocker"], "mocker"),
    (["out=torch", "--model-config", "llama3_70b"], "llama3_70b"),
    (["out=torch"], "needs --model-config"),
    (["in=carrier-pigeon"], "unknown input"),
])
def test_unported_flags_and_modes_exit_with_a_clear_message(argv, match):
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
