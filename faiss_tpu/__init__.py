"""faiss_tpu — an exact (flat) and IVF vector-similarity search framework
in JAX, running on NVIDIA GPUs (the package keeps the name of its first
target).

Capability-equivalent rebuild of the faiss-metal reference (a Metal GPU backend
for FAISS brute-force search):

  * the whole ``search()`` is ONE XLA program (distance GEMM with a
    fused L2-norm epilogue + top-k selection) with no host round-trips —
    mirroring the reference's "entire pipeline in one MTLCommandBuffer"
    property (reference: src/MetalIndexFlat.mm:358-381, README.md:149-159);
  * vector storage in float32 / bfloat16 / float16 / int8 device arrays with fp32
    norms computed *before* quantization (reference: MetalIndexFlat.mm:258-267);
  * a Pallas (Triton route) kernel for the fused distance + group-max sweep
    (reference analog: shaders/simdgroup_gemm*.metal, fused_l2_topk.metal);
  * multi-device scale-out via a ``jax.sharding.Mesh`` over the database
    axis with an all-gather top-k merge (new component — the reference is
    single-device).

Public API (parity with include/faiss-metal/MetalIndexFlat.h plus the sharded
extension):

    TpuResources, TpuDeviceCapabilities, query_device_capabilities
    TpuIndexFlat, TpuSearchToken, StorageType, MetricType
    ShardedIndexFlat
    ShardedIndexIVFFlat
    index_cpu_to_tpu, index_tpu_to_cpu, index_numpy_to_tpu
"""

from .resources import (
    TpuResources,
    TpuDeviceCapabilities,
    query_device_capabilities,
    describe_capabilities,
)
from .dtypes import StorageType, MetricType
from .index import (
    TpuIndexFlat,
    TpuSearchToken,
    index_cpu_to_tpu,
    index_tpu_to_cpu,
    index_numpy_to_tpu,
)
from .parallel.sharded import ShardedIndexFlat
from .parallel.sharded_ivf import ShardedIndexIVFFlat
from .io import save_index, load_index
from .multi import IndexShardsHost, merge_search_results
from .idmap import TpuIndexIDMap, TpuIndexIDMap2
from .clustering import Kmeans, kmeans_clustering, knn, pairwise_distances
from .ivf import TpuIndexIVFFlat
from .selector import (
    IDSelector,
    IDSelectorRange,
    IDSelectorBatch,
    IDSelectorMask,
    IDSelectorNot,
    IDSelectorAnd,
    IDSelectorOr,
    SearchParams,
    SearchParameters,
    SearchParametersIVF,
)
from . import loader
from . import native
from . import utils

__version__ = "0.1.0"

__all__ = [
    "TpuResources",
    "TpuDeviceCapabilities",
    "query_device_capabilities",
    "describe_capabilities",
    "StorageType",
    "MetricType",
    "TpuIndexFlat",
    "TpuSearchToken",
    "ShardedIndexFlat",
    "ShardedIndexIVFFlat",
    "index_cpu_to_tpu",
    "index_tpu_to_cpu",
    "index_numpy_to_tpu",
    "save_index",
    "load_index",
    "IndexShardsHost",
    "merge_search_results",
    "TpuIndexIDMap",
    "TpuIndexIDMap2",
    "TpuIndexIVFFlat",
    "Kmeans",
    "kmeans_clustering",
    "knn",
    "pairwise_distances",
    "IDSelector",
    "IDSelectorRange",
    "IDSelectorBatch",
    "IDSelectorMask",
    "IDSelectorNot",
    "IDSelectorAnd",
    "IDSelectorOr",
    "SearchParams",
    "SearchParameters",
    "SearchParametersIVF",
    "loader",
    "native",
    "utils",
    "__version__",
]
