"""ray_tpu_torch.data — distributed datasets feeding the card.

Counterpart of ``ray_tpu.data`` on the port's task/actor runtime
(``ray_tpu_torch.core``): lazy ops over a streaming executor that keeps a
bounded number of block tasks in flight on the runtime's workers, an
actor-pool map, numpy/pandas/pyarrow blocks (pandas and pyarrow imported
only when a block needs them), and ``streaming_split`` so each
TorchTrainer worker pulls its own shard of one stream. Consuming a dataset
starts the runtime (``ray_tpu_torch.init()``) if nothing has.
"""

from ray_tpu_torch.data.block import BlockAccessor  # noqa: F401
from ray_tpu_torch.data.dataset import (  # noqa: F401
    ActorPoolStrategy,
    AggregateFn,
    Dataset,
    GroupedDataset,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    read_binary_files,
    read_csv,
    read_json,
    read_numpy,
    read_images,
    read_parquet,
    read_sql,
    read_text,
)
from ray_tpu_torch.data.dataset import range as _range
from ray_tpu_torch.data.iterator import DataIterator  # noqa: F401

range = _range  # noqa: A001  (mirror ray.data.range naming)

__all__ = [
    "ActorPoolStrategy",
    "AggregateFn",
    "BlockAccessor",
    "DataIterator",
    "Dataset",
    "GroupedDataset",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_binary_files",
    "read_csv",
    "read_json",
    "read_numpy",
    "read_images",
    "read_parquet",
    "read_sql",
    "read_text",
]
