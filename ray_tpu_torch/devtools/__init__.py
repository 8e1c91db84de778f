"""Developer tooling for ray_tpu_torch: the chaos engine.

Only ``devtools.chaos`` (fault points, controller, plans, and the ``chaos``
subcommand of ``python -m ray_tpu_torch`` in ``chaos/cli.py``) is copied
from ``ray_tpu/devtools``: the runtime's fault points call it. The JAX
package's lint (raylint), its process killers and churn are not ported
yet.
"""
