"""The card probes of dynamo_tpu_torch/tools (profiler_window,
profile_verify) exit with 1 and print no result where there is no CUDA
device, as here on the CPU."""
import pytest
import torch

from dynamo_tpu_torch.tools import profile_verify, profiler_window


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device runs it")
@pytest.mark.parametrize("tool, argv", [
    (profiler_window, ["--json"]),
    (profile_verify, ["--json"]),
])
def test_probe_refuses_without_a_card(tool, argv, capsys):
    assert tool.main(argv) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA device" in out.err
