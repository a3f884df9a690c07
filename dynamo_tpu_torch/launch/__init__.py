"""The port's launcher (``python -m dynamo_tpu_torch.launch.run``)."""
