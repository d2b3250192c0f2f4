"""The launch stack, the counterpart of ``repro.launch``, driven by one
process over a mesh of devices (a device may repeat): ``mesh`` (meshes
over the local cards or a pool), ``collectives`` (all-gather,
all-reduce, reduce-scatter, all-to-all over a row of slots, with a byte
counter), ``shardings`` (the spec rules, ``shard_tree`` / ``gather_tree``,
params and AdamW state placed by their specs), ``pipeline`` (GPipe over
the ``pod`` axis cut by AFarePart, each stage on its ``(data, model)``
sub-mesh, the swap bookkeeping), ``steps`` (the FSDP x tensor-parallel,
pipelined, prefill and sequence-sharded decode steps), ``roofline``,
``dryrun`` (the per-device memory, FLOPs, bytes and collective bytes of
a cell on meta tensors) and the training CLI ``train``."""
