"""ray_tpu_torch.llm.disagg — disaggregated LLM serving on the port's runtime.

Counterpart of ``ray_tpu/llm/disagg``: DistServe's prefill/decode split
(Zhong et al., OSDI'24) and vLLM's paged KV as a shareable cache (Kwon et
al., SOSP'23), over the port's engine, runtime and serve:

- **KV-page plane** (:mod:`.kv_plane`): a prefill worker copies the KV
  pages it produced to host memory and seals each page's components into
  the local shm arena (``put_value(prefer_shm=True)``), handing over a
  :class:`KVPageManifest` (token ids, per-page object refs, node,
  nbytes); a decode worker adopts it with one batched get and scatters
  the pages into free pages of its own pool. Page bytes never ride an RPC
  frame.
- **Prefill/decode pools** (:mod:`.pools`): ``PrefillWorker`` batches
  prompts into padded waves on ``paged_prefill_batch`` (a suffix-only
  prefill over cached prefix pages via ``paged_prefill_suffix``);
  ``DecodeWorker`` runs the continuous-batching engine, admitting requests
  only with adopted KV. Each is an async actor on a share of the card.
- **Scheduler** (:mod:`.scheduler`): ``DisaggLLMServer``, a serve
  deployment fronting both pools with admission control driven by decode
  page headroom (``EngineFull`` becomes router backpressure) and
  decode-death recovery by manifest re-adoption or re-prefill;
  ``build_disagg_deployment`` binds it.
- **Cross-request prefix cache** (:mod:`.prefix_cache`): a radix tree over
  token-id pages with pins, LRU eviction, a tier-1 spill of cold pages
  and prefix-affinity routing hints.
"""

from ray_tpu_torch.llm.disagg.kv_plane import (
    KVPageManifest,
    KVShipError,
    adopt_pages,
    ship_pages,
)
from ray_tpu_torch.llm.disagg.pools import DecodeWorker, PrefillWorker
from ray_tpu_torch.llm.disagg.prefix_cache import PrefixCache, prefix_hint
from ray_tpu_torch.llm.disagg.scheduler import (
    DisaggLLMServer,
    build_disagg_deployment,
)

__all__ = [
    "DecodeWorker",
    "DisaggLLMServer",
    "KVPageManifest",
    "KVShipError",
    "PrefillWorker",
    "PrefixCache",
    "adopt_pages",
    "build_disagg_deployment",
    "prefix_hint",
    "ship_pages",
]
