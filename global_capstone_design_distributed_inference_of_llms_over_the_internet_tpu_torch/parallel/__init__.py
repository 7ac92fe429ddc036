"""Training and parallel engines.

So far the fine-tuning path's optimizer and loss (`trainer`). The JAX
package's pipelined trainer and its mesh engines (pipeline, ring
attention and decode, tensor and sequence parallelism) wait for their port
on ``torch.distributed``.
"""
