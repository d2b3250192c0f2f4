"""The launch stack, the counterpart of ``repro.launch``: the evaluation
mesh (``mesh.make_eval_mesh``) and the pipeline's swap bookkeeping
(``pipeline.group_cuts``, ``pipeline.swap_migration``).  Both are host-side:
neither needs a process group."""
