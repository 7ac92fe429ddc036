"""PyTorch/CUDA port of the pipeline-parallel LLM inference framework.

The JAX package beside this one
(``global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu``)
is the reference; this package mirrors its layout module for module and
never imports it (nor ``jax``):

  models/    config (copy), stacked-layer decoder forward, int8 quantization,
             stage partitioning, the JAX->torch weight bridge
  ops/       norms, rotary, cached attention, sampling, and ``int8_dot`` — a
             hand-written CUDA kernel for Hopper (``csrc/int8_dot.cu``)
  runtime/   KV arena, stage executor, in-process transport, pipeline client
  scheduling/ placement registry (copy)
  utils/     flag catalog (copy), the nvcc build helper for ``csrc/`` kernels
  main.py    the CLI subset ``--mode {local,oracle}``

Entry points run on ``cuda`` unless the caller asks for the CPU; on a CPU
tensor each kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
