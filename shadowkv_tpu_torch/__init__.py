"""ShadowKV serving path in PyTorch with hand-written CUDA kernels for Hopper.

A port of ``shadowkv_tpu`` (the JAX/Pallas package beside it, which stays the
reference). Module names mirror the JAX package so each counterpart is easy
to find: ``config``, ``core/``, ``cache/``, ``kernels/``, ``models/``
(``llm.py`` is the user's entry point), ``serving.py``, ``parallel/``
(dp, tp, sp and pp, one process per rank), ``utils/`` (context
checkpoints), ``data/``, ``eval/`` and ``entry/`` (``e2e``, ``eval_acc``).
Differences of idiom:

- parameters are stacked [L, ...] tensors in NamedTuples, and the layer
  loop is a Python loop (JAX scans over the stacked axis);
- cache buffers are updated in place where JAX returns new buffers through
  ``dynamic_update_slice`` / ``input_output_aliases``;
- every entry point takes an explicit ``device`` (CUDA by default) and
  randomness comes from explicit ``torch.Generator`` objects;
- every TPU kernel of the JAX package is CUDA C++ for ``sm_90a`` under
  ``csrc/``, built with ``nvcc`` at first use (``kernels/build.py``). CPU
  tensors take each kernel's plain PyTorch version;
- HF checkpoints are read by the port's own safetensors reader, and
  ``transformers`` is imported only to load a tokenizer.

Nothing here imports JAX or the JAX package.
"""
