"""Multi-device parallelism: database sharding + all-gather top-k merge.

New first-class subsystem with no reference counterpart — faiss-metal is
single-process/single-device (SURVEY.md §2.4, §5.8). The scaling axis for
exact search is the database length (nv), so the design is a 1-D
``jax.sharding.Mesh`` with the DB row-sharded across chips; each chip computes
distances + top-k over its local shard and the k-lists are merged with one
``all_gather`` over the interconnect (O(P·k) bytes — tiny).
"""

from .sharded import ShardedIndexFlat  # noqa: F401
from .sharded_ivf import ShardedIndexIVFFlat  # noqa: F401
