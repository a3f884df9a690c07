"""Operator tools of the port, run as ``python -m
dynamo_tpu_torch.tools.<name>``: ``chaos`` (arm and disarm a running
worker's fault-injection points) and ``scrub_kv`` (offline check of a G3
disk-tier file against its manifest)."""
