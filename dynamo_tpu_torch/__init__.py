"""PyTorch/CUDA port of dynamo-tpu's serving engine.

A package of its own beside ``dynamo_tpu`` (the JAX reference): it imports
``torch`` and nothing of JAX or of ``dynamo_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; kernels written by
hand for Hopper live in ``csrc/`` and are built with ``nvcc`` at first use
(ops/cuda_build.py).
"""
