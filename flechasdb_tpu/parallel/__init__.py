"""Multi-chip scale-out.

The reference has **no** distributed components (SURVEY.md §2: "Parallelism &
distributed-communication components: NONE") — its scaling story is
storage-level sharding of content-addressed partition files
(``database.proto:16-39``). The device-native analogue promotes that design to a
first-class device-mesh component set:

* the IVF **corpus axis is the data-parallel axis**: PQ codes and partition
  assignments shard across devices of a :class:`jax.sharding.Mesh`;
* **build** (k-means training) runs with the vector axis sharded — XLA
  inserts ``psum`` collectives for the cluster-sum/count reductions;
* **query** runs as an SPMD ``shard_map`` program: every device scans its
  local shard, keeps a local top-k, and the k-best merge rides an
  ``all_gather`` of just ``k`` candidates per device (never the full
  distance vector).
"""

from .build import build_sharded, build_step_donating
from .exact import exact_sharded, rerank_sharded, shard_flat
from .kmeans import fit_sharded
from .mesh import corpus_mesh, shard_corpus
from .query import query_sharded, range_sharded

__all__ = [
    "build_sharded",
    "build_step_donating",
    "exact_sharded",
    "fit_sharded",
    "range_sharded",
    "rerank_sharded",
    "shard_flat",
    "corpus_mesh",
    "query_sharded",
    "shard_corpus",
]
