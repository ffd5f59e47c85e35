"""Distributed backend: meshes, collectives, sharding helpers, partition
rules, and sequence parallelism.

The port of ``mmlspark_tpu/parallel``: the reference's L3 coordination
layer (SURVEY §2.13; the driver rendezvous, LightGBM's socket allreduce,
VW's spanning tree) as one process per device under ``torch.distributed``:

- rendezvous        → :func:`distributed_init` (the TCP store)
- socket allreduce  → :func:`allreduce` over a mesh axis's process group
- empty partitions  → padding masks (:func:`pad_rows`), never ragged shards
- per-model layout  → :func:`match_partition_rules` (regex rules → specs →
  ``DTensor`` placements) + :func:`shard_params` / :func:`gather_params`
  with a :class:`DtypePolicy`
- long context      → ``ring_attention`` and :func:`make_ulysses_attention`

Import is light: nothing here starts a CUDA context or a process group,
and submodules load on first attribute access. Pipeline and expert
parallelism and the pod harness are ROADMAP.md §1 item 10-2: their names
are here and raise ``NotImplementedError``.
"""

_LAZY = {
    "AXIS_ORDER": ".mesh", "MeshSpec": ".mesh", "build_mesh": ".mesh",
    "distributed_init": ".mesh", "local_mesh": ".mesh",
    "mesh_shape_for": ".mesh", "mesh_scope": ".mesh",
    "DtypePolicy": ".partition", "PartitionRule": ".partition",
    "activation_spec_for": ".partition",
    "constrain_activation": ".partition", "dtype_policy_for": ".partition",
    "gather_params": ".partition", "match_partition_rules": ".partition",
    "named_leaves": ".partition", "partition_rules_for": ".partition",
    "register_partition_rules": ".partition",
    "registered_rule_sets": ".partition", "shard_params": ".partition",
    "to_shardings": ".partition",
    "allgather": ".collectives", "allreduce": ".collectives",
    "all_to_all": ".collectives", "axis_index": ".collectives",
    "barrier": ".collectives", "ppermute": ".collectives",
    "psum_scatter": ".collectives", "ring_permute": ".collectives",
    "batch_sharding": ".sharding", "pad_rows": ".sharding",
    "replicated": ".sharding", "shard_batch": ".sharding",
    "unpad_rows": ".sharding",
    # not "ring_attention": the function shares its submodule's name (the
    # JAX package's rule): use make_ring_attention or
    # ring_attention.ring_attention
    "make_ring_attention": ".ring_attention",
    "blockwise_attention": ".ring_attention",
    "make_ulysses_attention": ".ulysses",
}

# item 10-2: pipeline and expert parallelism, the pod harness
LATER = ("pipeline_apply", "pipeline_encode", "pipeline_train_1f1b",
         "pipeline_train_encoder_1f1b", "make_pipeline_mlp", "launch_pod",
         "pod_mesh", "feed_process_local", "worker_env")

__all__ = sorted(set(_LAZY) | set(LATER))


def _later(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"parallel.{name}: pipeline and expert parallelism and the pod "
            "harness come with ROADMAP.md §1 item 10-2")
    stub.__name__ = name
    return stub


def __getattr__(name: str):
    if name in LATER:
        return _later(name)
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(target, __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY) | set(LATER))
