"""``ray_tpu_torch.data`` on a host without pyarrow and pandas, for
``tests/test_torch_data.py``. Not a test module.

    PYTHONPATH=<dir whose pyarrow and pandas raise ImportError>:... \
        python tests/_torch_data_noarrow.py <out.json>

Both packages are hidden from this process and, through PYTHONPATH, from
the task workers of the runtime it starts, as on the card's host: every
tabular block stays a numpy dict. It runs ``_torch_data_jax.pipelines``
on the port and a ``from_numpy`` -> ``streaming_split`` -> ``iter_batches``
stream, and writes ``{case: rows}`` (a case that needs Arrow, as the hash
join does, gives the name of the error it raised), and the kinds of block
the driver and a task worker hold.
"""
import dataclasses
import faulthandler
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kinds():
    """[pyarrow importable, pandas importable, the type of a from_numpy
    block] in this process."""
    import numpy as np

    import ray_tpu_torch.data as rtd
    from ray_tpu_torch.data import block

    try:
        import pandas  # noqa: F401
        has_pandas = True
    except ImportError:
        has_pandas = False
    ds = rtd.from_numpy({"x": np.arange(4)}, parallelism=1)
    (b,) = list(ds.iter_blocks())
    return [block._pa() is not None, has_pandas, type(b).__name__]


def main() -> int:
    faulthandler.dump_traceback_later(200, exit=True)
    sys.path.insert(0, ROOT)
    import numpy as np

    import _torch_data_jax
    import ray_tpu_torch
    import ray_tpu_torch.data as rtd
    from ray_tpu_torch import config

    config.set_config(dataclasses.replace(config.get_config(), worker_lease_timeout_s=1.0))
    ray_tpu_torch.init(num_cpus=8)
    out = {}
    try:
        @ray_tpu_torch.remote
        def worker_kinds():
            from ray_tpu_torch.data import block

            return [block._pa() is not None,
                    type(block.normalize_block({"x": np.arange(3)})).__name__]

        out["_driver"] = kinds()
        out["_worker"] = ray_tpu_torch.get(worker_kinds.remote())
        for name, fn in _torch_data_jax.pipelines(rtd).items():
            try:
                out[name] = _torch_data_jax.plain(fn())
            except Exception as e:  # noqa: BLE001 — a map task's error arrives as TaskError
                if "ImportError" not in f"{type(e).__name__}: {e}":
                    raise
                out[name] = {"error": "ImportError"}
    finally:
        ray_tpu_torch.shutdown()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
