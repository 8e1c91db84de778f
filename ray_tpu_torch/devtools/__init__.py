"""Developer tooling for ray_tpu_torch: the chaos engine.

Only ``devtools.chaos`` (fault points, controller, plans) is copied from
``ray_tpu/devtools``: the runtime's fault points call it. The JAX package's
lint (raylint), CLI and process killers are not part of the port.
"""
