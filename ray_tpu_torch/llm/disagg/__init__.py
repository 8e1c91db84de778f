"""ray_tpu_torch.llm.disagg — disaggregated LLM serving, in one process.

Counterpart of ``ray_tpu/llm/disagg``: DistServe's prefill/decode split
(Zhong et al., OSDI'24) and vLLM's paged KV as a shareable cache (Kwon et
al., SOSP'23), over the port's engine:

- **KV-page plane** (:mod:`.kv_plane`): a prefill worker copies the KV
  pages it produced to host memory and hands over a
  :class:`KVPageManifest` (token ids and one entry of host arrays per
  page); a decode worker adopts it, scattering the pages into free pages
  of its own pool.
- **Prefill/decode workers** (:mod:`.pools`): ``PrefillWorker`` batches
  prompts into padded waves on ``paged_prefill_batch`` (a suffix-only
  prefill over cached prefix pages via ``paged_prefill_suffix``);
  ``DecodeWorker`` runs the continuous-batching engine, admitting requests
  only with adopted KV.
- **Cross-request prefix cache** (:mod:`.prefix_cache`): a radix tree over
  token-id pages with pins, LRU eviction and prefix-affinity hints.

Left out: the scheduler ``DisaggLLMServer`` and ``build_disagg_deployment``,
which drive the pools through actor handles, GCS calls and signal loops of
the JAX package's runtime.
"""

from ray_tpu_torch.llm.disagg.kv_plane import (
    KVPageManifest,
    KVShipError,
    adopt_pages,
    ship_pages,
)
from ray_tpu_torch.llm.disagg.pools import DecodeWorker, PrefillWorker
from ray_tpu_torch.llm.disagg.prefix_cache import PrefixCache, prefix_hint

__all__ = [
    "DecodeWorker",
    "KVPageManifest",
    "KVShipError",
    "PrefillWorker",
    "PrefixCache",
    "adopt_pages",
    "prefix_hint",
    "ship_pages",
]
