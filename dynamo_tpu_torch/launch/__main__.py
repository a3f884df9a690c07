"""``python -m dynamo_tpu_torch.launch in=... out=...``: the same as
``python -m dynamo_tpu_torch.launch.run``."""
import sys

from dynamo_tpu_torch.launch.run import run_cli

if __name__ == "__main__":
    sys.exit(run_cli())
