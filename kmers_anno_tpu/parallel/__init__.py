"""Multi-chip scaling: mesh construction + sharded annotation steps.

The reference is single-process/single-host (SURVEY.md §2d); this package is
the device replacement: a 2-axis ``jax.sharding.Mesh`` ``(data, table)``
with XLA collectives, plus jax.distributed multi-host wiring.

* data axis — genome/protein batches shard across chips (DP).
* table axis — the signature table either replicates (lookups are pure
  local gathers), shards by ``hash % n_shards`` with probes merged by a
  ``pmax`` over the table axis, or shards with kmers routed to their owner
  shard via one ``all_to_all`` and partial votes merged collectively
  (the §5.8 large-table mode).
"""

from .distributed import distributed_env, maybe_init_distributed
from .mesh import (make_mesh, replicated_apply_step, routed_apply_step,
                   shard_signature_table, sharded_apply_step,
                   split_tokens_for_table_axis)

__all__ = ["distributed_env", "make_mesh", "maybe_init_distributed",
           "replicated_apply_step", "routed_apply_step",
           "shard_signature_table", "sharded_apply_step",
           "split_tokens_for_table_axis"]
