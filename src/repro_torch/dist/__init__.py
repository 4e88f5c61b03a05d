"""Distributed substrate of the port.

The counterpart of :mod:`repro.dist`, on ``torch.distributed`` in SPMD
style: one process per shard, every rank running the same replicated host
control.

* :mod:`repro_torch.dist.group` — :class:`~repro_torch.dist.group.SeqGroup`,
  the port's counterpart of a 1-D "seq" mesh and ``shard_map``'s axis
  index (the process group, this rank's shard, the size, the device) with
  in-place ``pmax_``/``psum_`` collectives, ``ppermute`` and
  ``exchange`` (one ``all_to_all`` of rows with split sizes);
  :class:`~repro_torch.dist.group.DataGroup`, the same for the "data"
  axis (each rank holds its rows of the global batch) with ``psum_`` and
  ``all_gather``; :class:`~repro_torch.dist.group.ModelGroup`, the "model"
  axis (every rank the same batch, its slices of the split weights) with
  the autograd collectives of a split product; ``StackedGroup``, the
  collectives over a leading shard axis on one device (``jax.vmap`` with
  an axis name); and :func:`~repro_torch.dist.group.run_ranks`, which
  starts ``n`` local ranks on an explicit backend (as a ``(data, model)``
  mesh with ``model=``) and joins them under a deadline.
* :mod:`repro_torch.dist.compression` — int8 gradient compression with
  error feedback: ``compress_decompress`` (one participant) and
  ``compressed_psum``/``compressed_psum_with_residual``, whose wire is one
  ``all_gather`` of every tensor's int8 values and one of the scales; the
  train step's ``compress_grads`` over a data group.
* :mod:`repro_torch.dist.sharded_plan` — sequence-parallel training
  (``ShardedPlan``/``shard_plan``: per-shard step tables over a ``[local |
  halo | global]`` view; the halo exchange and its exact reverse; a
  reordered schedule's stride exchange across shards, ``to_work`` /
  ``from_work``; K1–K3 per shard; ``sharded_attention``, which
  ``hybrid_attention``,
  ``Model.loss`` and ``make_train_step`` reach under ``group=``), and
  ``masked_psum_merge``, the cross-shard softmax merge of the
  sequence-parallel serving engine (``ContinuousEngine(seq_shards > 1,
  group=...)``) and of training's global rows.

* :mod:`repro_torch.dist.sharding` — the reference's placement rules
  for the "model" axis without JAX (``PARAM_RULES``,
  ``logical_axes_for``, the divisibility rules of ``cell_rules`` and
  ``_mesh_clean``) and its FSDP fallback over the "data" axis:
  ``mesh_placements`` gives each parameter leaf one ``Split``, the dim it
  splits on over the model group and over the data group, or ``None``.

Data parallelism (``make_train_step(..., data=DataGroup)``, the train
CLI's ``--data``) maps the reference's ``batch`` logical axis onto the
ranks, tensor parallelism (``model_group=ModelGroup``, ``--model``) its
``heads``, ``kv_heads``, ``ffn`` and ``vocab`` axes; the two compose as
the reference's ``(data, model)`` mesh (``group.mesh_groups``). The port
passes the groups explicitly; only the parameter placements come from
the rules.
"""
