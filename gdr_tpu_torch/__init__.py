"""gdr_tpu_torch — the PyTorch/CUDA port of gdr_tpu (Generative Dense
Retrieval), serving retrieval and evaluation on an NVIDIA H100.

The layout mirrors ``gdr_tpu`` (``models/t5.py``, ``models/pawa.py``,
``models/gdr.py``, ``ops/beam.py``, ``ops/rerank.py``, ``ops/quantize.py``,
``eval/evaluator.py``, ``eval/offline.py``, ``cli.py``), so each module's
counterpart is found by its path.  The package imports ``torch`` and numpy
only — never JAX and nothing of ``gdr_tpu``; the host code it needs is
copied.  Every Pallas kernel of ``gdr_tpu`` is a hand-written CUDA kernel
under ``csrc/``,
with its plain PyTorch version beside it in ``kernels/``: the device of the
tensors decides which runs.
"""
