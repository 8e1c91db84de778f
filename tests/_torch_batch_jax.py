"""JAX's ``build_llm_processor`` over ``ray_tpu.data`` for
``tests/test_torch_batch.py``. Not a test module.

    python tests/_torch_batch_jax.py <out.json>

Maps the processor (``LlamaConfig.tiny()``, weights from
``jax.random.PRNGKey(0)`` carried by value, batch_size 4, 3 greedy tokens)
over ``ROWS`` on a fresh ``ray_tpu`` runtime in this process, and writes
the output rows: the port's processor must give the same tokens.
"""
import dataclasses
import faulthandler
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = [{"prompt_tokens": [1, 2, 3, 10 + i], "id": i} for i in range(10)]
BATCH_SIZE, MAX_NEW = 4, 3


def main() -> int:
    faulthandler.dump_traceback_later(240, exit=True)
    sys.path.insert(0, ROOT)
    import jax

    import ray_tpu
    from ray_tpu import config, data
    from ray_tpu.llm import build_llm_processor
    from ray_tpu.models.llama import LlamaConfig, llama_init

    config.set_config(dataclasses.replace(config.get_config(), worker_lease_timeout_s=1.0))
    ray_tpu.init(num_cpus=4)
    try:
        cfg = LlamaConfig.tiny()
        params = llama_init(jax.random.PRNGKey(0), cfg)
        out = build_llm_processor(cfg, params=params, batch_size=BATCH_SIZE,
                                  max_new_tokens=MAX_NEW)(data.from_items(ROWS)).take_all()
    finally:
        ray_tpu.shutdown()
    with open(sys.argv[1], "w") as f:
        json.dump([{k: v.tolist() if hasattr(v, "tolist") else v for k, v in r.items()}
                   for r in out], f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
