"""ray_tpu_torch.data — an in-process dataset for batch inference.

``from_items``, ``Dataset.map_batches`` and ``Dataset.take_all`` with the
numpy batch format of ``ray_tpu.data``; no executor, actors or object
store.
"""
from ray_tpu_torch.data.dataset import Dataset, from_items

__all__ = ["Dataset", "from_items"]
