"""The launch stack, the counterpart of ``repro.launch``, driven by one
process over a mesh of devices (a device may repeat): ``mesh`` (meshes
over the local cards or a pool), ``shardings`` (the spec rules,
``shard_tree`` / ``gather_tree``), ``pipeline`` (GPipe over the ``pod``
axis cut by AFarePart, the swap bookkeeping), ``steps`` (the
data-parallel, pipelined, prefill and sequence-sharded decode steps),
``roofline`` and the training CLI ``train``.  The reference's
``dryrun.py`` (a 512-chip TPU compile read through XLA's analyses) has no
counterpart."""
