"""gdr_tpu_torch — the PyTorch/CUDA port of gdr_tpu (Generative Dense
Retrieval) on an NVIDIA H100: it builds and grows the index, trains the
generative retriever and its doc tower, and serves retrieval and
evaluation.

The layout mirrors ``gdr_tpu`` (``models/t5.py``, ``models/pawa.py``,
``models/gdr.py``, ``ops/beam.py``, ``ops/rerank.py``, ``ops/losses.py``,
``ops/quantize.py``, ``eval/evaluator.py``, ``eval/offline.py``,
``train/``, ``data/``, ``cli.py``), so each module's counterpart is found
by its path.  The package imports ``torch`` and numpy only — never JAX and
nothing of ``gdr_tpu``; the host code it needs is copied.  Every Pallas
kernel of ``gdr_tpu`` is a hand-written CUDA kernel under ``csrc/``,
with its plain PyTorch version beside it in ``kernels/``: the device of the
tensors decides which runs.
"""
