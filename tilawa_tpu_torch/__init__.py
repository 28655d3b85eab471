"""tilawa-tpu on PyTorch and CUDA: the port of the JAX package to one
NVIDIA H100.

The JAX package `tilawa_tpu` stays the reference; this package imports
`torch` and nothing of JAX, flax, msgpack or `tilawa_tpu`. Host modules it
needs from the JAX package are copied under the same relative path (the
counterpart of `tilawa_tpu/data/quran.py` is `tilawa_tpu_torch/data/quran.py`).

  io        — the export bundle reader (msgpack, no flax)
  models    — FastConformer-CTC as torch modules + the weight converter
  ops       — log-mel frontend, int4 dequant matmul, CTC scorer; the two
              hand-written CUDA kernels live in csrc/ and are built with
              nvcc into _build/ at first use
  pipeline  — encoder runtime, candidate retrieval, CTC rerank, Recognizer
  data/text — host code copied from the JAX package

Entry points run on the card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
