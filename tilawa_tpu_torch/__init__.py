"""tilawa-tpu on PyTorch and CUDA: the port of the JAX package to one
NVIDIA H100.

The JAX package `tilawa_tpu` stays the reference; this package imports
`torch` and nothing of JAX, flax, msgpack or `tilawa_tpu`. Host modules it
needs from the JAX package are copied under the same relative path (the
counterpart of `tilawa_tpu/data/quran.py` is `tilawa_tpu_torch/data/quran.py`).

  io        — the export bundle reader (msgpack, no flax)
  models    — FastConformer-CTC as torch modules + the weight converter
  ops       — log-mel frontend, int4 and int8 matmuls, CTC scorer; the
              three hand-written CUDA kernels live in csrc/ and are built
              with nvcc into _build/ at first use
  pipeline  — encoder runtime (long-clip stitching, streaming encoder
              cache), candidate retrieval, CTC rerank, Recognizer, the
              phoneme pipeline and its oracle acoustics
  streaming — recitation tracker and session, verse tracker and
              StreamingPipeline (copied), micro-batch dispatcher,
              WebSocket server
  eval      — experiment registry (the champion modes, LM fusion,
              pruned-ctc, two-stage, heldout, the phoneme family, oracles)
              and runtime loading, the JAX package's recorded decisions the
              card's gates compare with (jax_refs.py, refs/),
              the runner, the batched corpus eval, metrics, the streaming
              validation replay, the WS endpoint bench, and the diagnostic
              harnesses: context sweep, stability, run_single, tracker
              oracle, analyze, compare, hypothesis sweep
  train     — the training path: CTC fine-tune (train, finetune), the
              checkpoint reader/writer, data and forced alignment (numpy
              copies), int4/int8 quantization and its inverse, export with
              the sha256 contract, self-distillation, the corpus-fit
              report, depth pruning, the phoneme-head fine-tune
  data/text — host code copied from the JAX package (with the word n-gram
              LM, the token trie, the phoneme store and the phoneme
              aligner); ops/beam.py and utils/profiling.py
              are copies too

Entry points, on the card unless --device cpu (or device="cpu") is passed:

  python -m tilawa_tpu_torch.cli <audio>           recognize clips
  python -m tilawa_tpu_torch.eval.runner           an experiment over a corpus
  python -m tilawa_tpu_torch.bench                 the headline JSON line
  python -m tilawa_tpu_torch.streaming.server      the WebSocket server
  python -m tilawa_tpu_torch.eval.ws_bench         replay clips against it
  python -m tilawa_tpu_torch.train.train           CTC training (small/large preset)
  python -m tilawa_tpu_torch.train.finetune        the champion fine-tune recipe
  python -m tilawa_tpu_torch.train.distill         self-distillation from champion-int4
  python -m tilawa_tpu_torch.train.phoneme         the phoneme-head fine-tune
  python -m tilawa_tpu_torch.train.export          a checkpoint → an int4 bundle
  python -m tilawa_tpu_torch.train.prune           a checkpoint → a depth-pruned one
  python -m tilawa_tpu_torch.eval.context_sweep    decodes of 1/2/3/5/10 s prefixes
  python -m tilawa_tpu_torch.eval.stability        N repeats: flaky samples
  python -m tilawa_tpu_torch.eval.run_single       one experiment's result history
  python -m tilawa_tpu_torch.eval.tracker_oracle   the tracker's policy ceiling (host only)
  python -m tilawa_tpu_torch.eval.analyze          failure taxonomy of a results file
  python -m tilawa_tpu_torch.eval.compare          batch vs streaming results
  python -m tilawa_tpu_torch.eval.hypothesis_sweep offline Viterbi parameter sweep
"""

__version__ = "0.1.0"
